// K1: frame-batched BEV splat (scatter-add of point rows into a BEV grid).
//
// Replaces the TPU kernel
//   stp3_tpu/ops/pallas/bev_pool_kernel.py::bev_pool_pallas_v2_batched
//   (_forward_v2_batched, kernel _scatter_kernel_v2b)
// which walks each frame's points serially over a VMEM-resident fp32
// accumulator. Hopper has no such sequential grid: its blocks run in
// parallel and in no order, so the sums across blocks are fp32 atomics.
//
// Contract: feats (F, P, C) fp32 or bf16, ranks (F, P) int32 in
// [0, ncells]; acc (F, ncells, C) fp32, zeroed by the caller. Point p of
// frame f adds its C channels to acc[f, ranks[f, p]]. A rank outside
// [0, ncells) -- ncells is the "invalid point" id -- is dropped.
//
// What bounds it on an H100: the bytes of the rows of the points that land
// (120 MB of bf16 rows at the serving shape F=3, P=483,840, C=64, 64.4%
// landing), once the atomics are few: one fp32 atomic per channel per
// landed point would be 60 M atomics at that shape. The points repeat
// their cell: with nz = 1 and points ordered (camera, depth bin, pixel
// row, pixel column), the 28 pixel rows of one column at one depth bin
// land in one cell, 60 points apart, so neighbours rarely share a rank
// (0.91 runs per landed point) but a tile of 1,024 consecutive points
// holds only 0.093 distinct ranks per landed point (0.068 at 2,048; the
// flagship rig's pre-warped ranks).
//
// Design: a block takes a tile of T = 1,024 consecutive points of one
// frame (on an H100 it ran faster than T = 2,048 and 4,096, which fold
// more points a run: PERF.md), sorts
// its (rank, point) pairs by the rank's significant bits
// (cub::BlockRadixSort; a dropped point sorts last under the key ncells),
// flags the heads of equal-rank runs and numbers them with a block scan.
// Runs are summed in registers, each row read once. Where a row is whole
// 16-byte vectors (C = 64 in bf16: 8 vectors, one coalesced 128-byte
// read), a group of lanes reads one row a step and takes a run of its own,
// so a warp sums four runs at once, each with up to four rows in flight
// (the run phase, not the sort, is what takes the time: a warp that takes
// one run at a time waits a memory round trip per run); then the group
// adds its run's row with two red.global.add.v4.f32 a lane (vector atomics
// of compute capability 9.x that return nothing, so no thread waits on
// them): 16 vector atomics per run instead of 64 scalar ones per point. A
// row that is not whole 16-byte vectors (a C that no configuration uses)
// takes a warp per run, lanes on channels, scalar loads and atomics. A
// tile with no landing point returns after reading its ranks.
//
// Numerics: a run sums in an order fixed by the (stable) sort; the
// atomics of different tiles add in an order that changes from run to
// run, so the result is nondeterministic in the last bits; compare it
// with a tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kSplatThreads = 256;
constexpr int kItems = 4;                       // ranks a thread sorts
constexpr int kTile = kSplatThreads * kItems;   // T = 1,024 points a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// a vector atomic add to global memory (compute capability 9.x) that
// returns nothing, so that no thread waits for the old value
__device__ __forceinline__ void red_add_v4(float* dst, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(dst), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}
__device__ __forceinline__ void add_vec(float (&sum)[4], uint4 q) {
  sum[0] += __uint_as_float(q.x);
  sum[1] += __uint_as_float(q.y);
  sum[2] += __uint_as_float(q.z);
  sum[3] += __uint_as_float(q.w);
}
__device__ __forceinline__ void add_vec(float (&sum)[8], uint4 q) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(b[k]);
    sum[2 * k] += f.x;
    sum[2 * k + 1] += f.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSplatThreads)
splat_tile_kernel(const T* __restrict__ feats, const int32_t* __restrict__ ranks,
                  float* __restrict__ acc, int64_t n_points, int channels, int ncells,
                  int key_bits, int lanes_per_row) {
  using Sort = cub::BlockRadixSort<uint32_t, kSplatThreads, kItems, uint16_t>;
  using Scan = cub::BlockScan<int, kSplatThreads>;
  __shared__ union {
    typename Sort::TempStorage sort;
    int run_key[kTile];                 // written once the sort is done
  } u;
  __shared__ typename Scan::TempStorage scan;
  __shared__ uint16_t point[kTile];     // sorted: each item's point within the tile
  __shared__ uint16_t run_start[kTile + 1];
  __shared__ uint32_t last_key[kSplatThreads];

  const int tid = threadIdx.x;
  const int64_t frame = blockIdx.y;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const int32_t* f_ranks = ranks + frame * n_points;

  // striped load of the tile's ranks; a dropped point or a padding item
  // past the frame's end takes the key ncells, which sorts last
  uint32_t keys[kItems];
  uint16_t pts[kItems];
  int landing = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int local = j * kSplatThreads + tid;
    const int64_t p = tile0 + local;
    const int32_t r = p < n_points ? __ldg(f_ranks + p) : ncells;
    const bool lands = r >= 0 && r < ncells;
    keys[j] = lands ? (uint32_t)r : (uint32_t)ncells;
    pts[j] = (uint16_t)local;
    landing += lands;
  }
  if (!__syncthreads_or(landing)) return;

  Sort(u.sort).Sort(keys, pts, 0, key_bits);    // blocked: item j is tid * kItems + j
#pragma unroll
  for (int j = 0; j < kItems; ++j) point[tid * kItems + j] = pts[j];
  last_key[tid] = keys[kItems - 1];
  __syncthreads();

  // run heads, numbered by an exclusive scan of their counts
  uint32_t prev = tid > 0 ? last_key[tid - 1] : ~0u;
  int heads = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    heads += keys[j] != prev;
    prev = keys[j];
  }
  int run, n_runs;
  Scan(scan).ExclusiveSum(heads, run, n_runs);
  prev = tid > 0 ? last_key[tid - 1] : ~0u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (keys[j] != prev) {
      run_start[run] = (uint16_t)(tid * kItems + j);
      u.run_key[run] = (int)keys[j];
      ++run;
    }
    prev = keys[j];
  }
  if (tid == 0) run_start[n_runs] = (uint16_t)kTile;
  __syncthreads();

  // the last run (key ncells) is the dropped points
  const int lane = tid & 31;
  const T* f_feats = feats + (frame * n_points + tile0) * channels;
  float* f_acc = acc + frame * (int64_t)ncells * channels;
  if (lanes_per_row > 0) {
    // rows of 16-byte vectors: a group of lanes_per_row lanes reads one row
    // a step and takes a run of its own, so a warp sums 32 / lanes_per_row
    // runs at once (4 at C = 64 in bf16) with up to four rows each in
    // flight; the group adds its run's row with float4 atomics
    constexpr int kV = 16 / sizeof(T);            // channels a vector
    const int group = lane / lanes_per_row, sub = lane % lanes_per_row;
    const int groups = 32 / lanes_per_row, row_vecs = channels / kV;
    for (int r = (tid >> 5) * groups + group; r < n_runs;
         r += (kSplatThreads / 32) * groups) {
      const int key = u.run_key[r];
      if (key >= ncells) continue;
      const int begin = run_start[r], end = run_start[r + 1];
      float* dst = f_acc + (int64_t)key * channels;
      for (int v = sub; v < row_vecs; v += lanes_per_row) {
        float sum[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) sum[k] = 0.0f;
#pragma unroll 4
        for (int i = begin; i < end; ++i) {
          add_vec(sum, __ldg(reinterpret_cast<const uint4*>(
                                 f_feats + (int64_t)point[i] * channels) + v));
        }
#pragma unroll
        for (int k = 0; k < kV; k += 4) {
          red_add_v4(dst + v * kV + k, sum[k], sum[k + 1], sum[k + 2], sum[k + 3]);
        }
      }
    }
    return;
  }
  // other rows: warps take whole runs, lanes on channels, scalar atomics
  for (int r = tid >> 5; r < n_runs; r += kSplatThreads / 32) {
    const int key = u.run_key[r];
    if (key >= ncells) continue;                  // warp-uniform
    const int begin = run_start[r], end = run_start[r + 1];
    float* dst = f_acc + (int64_t)key * channels;
    for (int c = lane; c < channels; c += 32) {
      float sum = 0.0f;
#pragma unroll 4
      for (int i = begin; i < end; ++i) {
        sum += to_f32(f_feats[(int64_t)point[i] * channels + c]);
      }
      atomicAdd(dst + c, sum);
    }
  }
}

template <typename T>
cudaError_t launch(const void* feats, const int32_t* ranks, float* acc, int n_frames,
                   int64_t n_points, int channels, int ncells, cudaStream_t stream) {
  int key_bits = 1;
  while (key_bits < 31 && ((int64_t)1 << key_bits) <= ncells) ++key_bits;   // holds ncells
  // 16-byte vectors when a row is whole vectors and both bases are aligned:
  // lanes a row, the row's vectors rounded up to a power of two, at most 32
  int lanes_per_row = 0;
  const int row_bytes = channels * (int)sizeof(T);
  if (row_bytes % 16 == 0 && (((uintptr_t)feats | (uintptr_t)acc) & 15) == 0) {
    lanes_per_row = 1;
    while (lanes_per_row < 32 && lanes_per_row * 16 < row_bytes) lanes_per_row <<= 1;
  }
  const int64_t tiles = (n_points + kTile - 1) / kTile;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)n_frames);
  splat_tile_kernel<T><<<grid, kSplatThreads, 0, stream>>>(
      static_cast<const T*>(feats), ranks, acc, n_points, channels, ncells, key_bits,
      lanes_per_row);
  return cudaGetLastError();
}

}  // namespace

// K3: the splat's backward, a row gather.
//
// Replaces the TPU kernel
//   stp3_tpu/ops/pallas/bev_pool_kernel.py::gather_rows_pallas
//   (kernel _gather_kernel_v2), which the batched splat's VJP (_bwd_v2b)
// calls once per frame on a zero-padded (ncells + 1, C) cotangent.
//
// Contract: table (F, ncells, C) and out (F, P, C) of one element type,
// ranks (F, P) int32. out[f, p, :] = table[f, ranks[f, p], :] when the
// rank is in [0, ncells), zeros otherwise: the padded row is never
// materialised, and one launch covers all F frames.
//
// What bounds it on an H100: bytes. At the training shape (F=6,
// P=483,840, C=64, bf16) it writes 372 MB of rows and reads 12 MB of
// ranks; each frame's table is 5.1 MB and the whole table (31 MB) fits
// in the card's 50 MB L2 (H100 data sheet), so the row reads mostly hit
// L2. There is no arithmetic. Design: the output is cut into 16-byte
// vectors (8 bf16 or 4 fp32 channels) and consecutive threads take
// consecutive vectors, so a 64-channel bf16 row is 8 lanes of one warp,
// the stores are fully coalesced, the lanes of a row read one contiguous
// 128-byte table row, and the rank load is a broadcast within those
// lanes. A row whose byte width is not a multiple of 16 takes 4- or
// 2-byte vectors instead. A copy: the result equals the plain gather
// bit for bit.

namespace {

template <typename V>
__global__ void __launch_bounds__(256)
gather_rows_kernel(const V* __restrict__ table, const int32_t* __restrict__ ranks,
                   V* __restrict__ out, int n_vecs, int vecs_per_row,
                   int n_points, int ncells) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_vecs; i += stride) {
    const int point = i / vecs_per_row;           // frame-major point index
    const int v = i - point * vecs_per_row;
    const int frame = point / n_points;
    const int32_t r = __ldg(ranks + point);
    V val{};
    if (r >= 0 && r < ncells) {
      val = __ldg(table + ((int64_t)frame * ncells + r) * vecs_per_row + v);
    }
    out[i] = val;
  }
}

template <typename V>
cudaError_t launch_gather(const void* table, const int32_t* ranks, void* out,
                          int n_frames, int n_points, int row_bytes, int ncells,
                          cudaStream_t stream) {
  const int vecs_per_row = row_bytes / (int)sizeof(V);
  const int64_t n_vecs = (int64_t)n_frames * n_points * vecs_per_row;
  const int threads = 256;
  const int max_grid = 132 * 8;    // 132 SMs x 8 resident blocks of 256 threads
  // 32-bit indices, with room for the last grid-stride step
  if (n_vecs > (int64_t)INT32_MAX - (int64_t)max_grid * threads) return cudaErrorInvalidValue;
  const int64_t blocks = (n_vecs + threads - 1) / threads;
  const int grid = (int)(blocks < max_grid ? blocks : max_grid);
  gather_rows_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(table), ranks, static_cast<V*>(out), (int)n_vecs,
      vecs_per_row, n_points, ncells);
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 (fp32) or 2 (bf16). Returns the launch's cudaError_t.
extern "C" int gather_rows(const void* table, const void* ranks, void* out,
                           int n_frames, int n_points, int channels,
                           int elem_bytes, int ncells, void* stream) {
  if (n_frames <= 0 || n_points <= 0) return (int)cudaSuccess;
  if (channels <= 0 || (elem_bytes != 2 && elem_bytes != 4)) return (int)cudaErrorInvalidValue;
  const int row_bytes = channels * elem_bytes;
  const int32_t* r = static_cast<const int32_t*>(ranks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t both = (uintptr_t)table | (uintptr_t)out;
  if (row_bytes % 16 == 0 && both % 16 == 0) {
    return (int)launch_gather<uint4>(table, r, out, n_frames, n_points, row_bytes, ncells, s);
  }
  if (row_bytes % 4 == 0 && both % 4 == 0) {
    return (int)launch_gather<uint32_t>(table, r, out, n_frames, n_points, row_bytes, ncells, s);
  }
  return (int)launch_gather<uint16_t>(table, r, out, n_frames, n_points, row_bytes, ncells, s);
}

// dtype: 0 = fp32 feats, 1 = bf16 feats. Returns the launch's cudaError_t.
extern "C" int bev_splat_accumulate(const void* feats, int dtype,
                                    const void* ranks, void* acc,
                                    int n_frames, int64_t n_points,
                                    int channels, int ncells, void* stream) {
  if (n_frames <= 0 || n_points <= 0) return (int)cudaSuccess;
  if (n_frames > 65535 || channels <= 0 || ncells <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* r = static_cast<const int32_t*>(ranks);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(feats, r, a, n_frames, n_points, channels, ncells, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(feats, r, a, n_frames, n_points, channels, ncells, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
