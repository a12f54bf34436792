// K1: frame-batched BEV splat (scatter-add of point rows into a BEV grid).
//
// Replaces the TPU kernel
//   stp3_tpu/ops/pallas/bev_pool_kernel.py::bev_pool_pallas_v2_batched
//   (_forward_v2_batched, kernel _scatter_kernel_v2b)
// which walks each frame's points serially over a VMEM-resident fp32
// accumulator. Hopper has no such sequential grid: its blocks run in
// parallel and in no order, so the accumulation is an fp32 atomicAdd
// instead.
//
// Contract: feats (F, P, C) fp32 or bf16, ranks (F, P) int32 in
// [0, ncells]; acc (F, ncells, C) fp32, zeroed by the caller. Point p of
// frame f adds its C channels to acc[f, ranks[f, p]]. A rank outside
// [0, ncells) -- ncells is the "invalid point" id -- is skipped.
//
// What bounds it on an H100: the F*P*C fp32 atomics (93 M at the
// flagship shape F=3, P=483,840, C=64, counted from the shapes), not the
// 186 MB of bf16 feats it reads once. The 3 x 40,000 x 64 fp32
// accumulator (30.7 MB) fits in the card's 50 MB L2 (H100 data sheet),
// so the atomics resolve there without a trip to HBM. Design:
// one warp per point, its lanes on consecutive channels, so a warp's
// atomics hit one contiguous row (coalesced), its rank load is a
// broadcast, and the invalid-point branch is warp-uniform. Invalid
// points are skipped rather than summed onto an overflow row as the TPU
// kernel does: here all of them would contend on that one row's C
// addresses.
//
// Numerics: fp32 atomics add in an order that changes from run to run,
// so the result is nondeterministic in the last bits; compare it with a
// tolerance, never bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
splat_kernel(const T* __restrict__ feats, const int32_t* __restrict__ ranks,
             float* __restrict__ acc, int64_t n_points, int channels,
             int ncells) {
  const int64_t frame = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const T* f_feats = feats + frame * n_points * channels;
  const int32_t* f_ranks = ranks + frame * n_points;
  float* f_acc = acc + frame * (int64_t)ncells * channels;

  for (int64_t p = warp; p < n_points; p += n_warps) {
    const int32_t r = __ldg(f_ranks + p);
    if (r < 0 || r >= ncells) continue;           // warp-uniform
    const T* row = f_feats + p * channels;
    float* dst = f_acc + (int64_t)r * channels;
    for (int c = lane; c < channels; c += 32) {
      atomicAdd(dst + c, to_f32(row[c]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* feats, const int32_t* ranks, float* acc,
                   int n_frames, int64_t n_points, int channels, int ncells,
                   cudaStream_t stream) {
  const int64_t blocks = (n_points + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dim3 grid((unsigned)(blocks < 1048576 ? blocks : 1048576), (unsigned)n_frames);
  splat_kernel<T><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(feats), ranks, acc, n_points, channels, ncells);
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
  if (n_frames > 65535 || channels <= 0) return (int)cudaErrorInvalidValue;
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
