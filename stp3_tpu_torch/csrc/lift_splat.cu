// K4: fused lift + splat (depth probability x context row, scatter-added
// into the BEV grid), frame-batched.
//
// Replaces the TPU kernel
//   stp3_tpu/ops/pallas/bev_pool_kernel.py::lift_splat_pallas
//   (_lift_splat_forward, kernel _lift_scatter_kernel)
// which walks one frame's points serially over a VMEM-resident fp32
// accumulator with the whole (R, C) context table beside it. Hopper has no
// such sequential grid: its blocks run in parallel and in no order, so the
// sums across blocks are fp32 atomics, as in K1 (bev_pool.cu).
//
// Contract: ctx (F, R, C) and dp (F, P) each fp32 or bf16; ranks (F, P)
// int32 in [0, ncells]; ray_ids (P,) int32 in [0, R), shared by every
// frame; acc (F, ncells, C) fp32, zeroed by the caller. For every point p
// of frame f whose rank r is in [0, ncells):
//     acc[f, r, :] += fp32(dp[f, p]) * fp32(ctx[f, ray_ids[p], :]).
// A point whose rank is outside [0, ncells) -- ncells is the "invalid
// point" id -- is dropped, and so is a ray id outside [0, R) (the contract
// excludes it; dropping keeps a bad id from reading outside the table).
//
// What it saves: the materialised path (lift, then K1) writes and re-reads
// the lifted (F, P, C) tensor, 186 MB in bf16 at the flagship shape (F=3,
// P=483,840, C=64). Here each point's row dp[p] * ctx[ray[p]] is formed in
// registers from the ctx table (3.9 MB in bf16 at that shape), which stays
// in the card's 50 MB L2 (H100 data sheet), as does the 3 x 40,000 x 64
// fp32 accumulator (30.7 MB).
// What bounds it on an H100: its bytes, ~33 MB at the flagship shape (the
// ranks, the ray ids and dp of the points that land, the ctx table, the
// output), once the atomics are few: one fp32 atomic per channel per
// landed point, the design this kernel replaces, was ~60 M atomics there.
//
// Design, K1's (tile_runs.cuh): K4 walks the points in K1's order (camera,
// depth bin, pixel row, pixel column), where a tile of 1,024 consecutive
// points holds 0.093 distinct ranks per landed point at the flagship rig.
// A block takes a tile of T = 1,024 points of one frame, loads its ranks
// coalesced and, for the points that land, their ray ids and dp (a
// dropped point's are never read), staged in shared memory by point. It
// sorts the tile's (rank, point) pairs by rank and, once every thread has
// read its sorted items' ray id and dp, stores both back in sorted order,
// so that the run loop reads them with one shared load each. Runs are
// summed in registers: where a ctx row is whole 16-byte vectors (C = 64 in
// bf16: 8 vectors, one 128-byte L2 read), a group of lanes reads one row a
// step, scales it by dp in fp32 and takes a run of its own, so a warp sums
// four runs at once with up to four rows each in flight; the group adds
// its run's sum with red.global.add.v4.f32: 16 vector atomics per run
// instead of 64 scalar ones per point. A row that is not whole 16-byte
// vectors takes a warp per run, lanes on channels, scalar loads and
// atomics. A tile with no landing point returns after reading its ranks.
//
// Numerics: a run sums (as fused multiply-adds) in an order fixed by the
// (stable) sort; the atomics of different tiles add in an order that
// changes from run to run, so the result is nondeterministic in the last
// bits; compare it with a tolerance, never bit for bit.

#include "tile_runs.cuh"

namespace {

using tile_runs::red_add_v4;
using tile_runs::to_f32;

constexpr int kThreads = 256;
constexpr int kItems = 4;                       // ranks a thread sorts
using Runs = tile_runs::TileRuns<kThreads, kItems>;
constexpr int kTile = Runs::kTile;              // T = 1,024 points a block

__device__ __forceinline__ void fma_vec(float (&sum)[4], uint4 q, float w) {
  sum[0] = fmaf(w, __uint_as_float(q.x), sum[0]);
  sum[1] = fmaf(w, __uint_as_float(q.y), sum[1]);
  sum[2] = fmaf(w, __uint_as_float(q.z), sum[2]);
  sum[3] = fmaf(w, __uint_as_float(q.w), sum[3]);
}
__device__ __forceinline__ void fma_vec(float (&sum)[8], uint4 q, float w) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(b[k]);
    sum[2 * k] = fmaf(w, f.x, sum[2 * k]);
    sum[2 * k + 1] = fmaf(w, f.y, sum[2 * k + 1]);
  }
}

template <typename T, typename D>
__global__ void __launch_bounds__(kThreads)
lift_splat_tile_kernel(const T* __restrict__ ctx, const D* __restrict__ dp,
                       const int32_t* __restrict__ ranks, const int32_t* __restrict__ ray_ids,
                       float* __restrict__ acc, int64_t n_points, int n_rays, int channels,
                       int ncells, int key_bits, int lanes_per_row) {
  __shared__ Runs::Storage runs;
  // by point in the tile until the sort, then by sorted position
  __shared__ int32_t ray[kTile];
  __shared__ float weight[kTile];

  const int tid = threadIdx.x;
  const int64_t frame = blockIdx.y;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  const int32_t* f_ranks = ranks + frame * n_points;
  const D* f_dp = dp + frame * n_points;

  // striped loads; a dropped point (its rank or its ray id out of range)
  // or a padding item past the frame's end takes the key ncells, which
  // sorts last
  uint32_t keys[kItems];
  uint16_t pts[kItems];
  int landing = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int local = j * kThreads + tid;
    const int64_t p = tile0 + local;
    const int32_t r = p < n_points ? __ldg(f_ranks + p) : ncells;
    bool lands = r >= 0 && r < ncells;
    int32_t y = 0;
    float w = 0.0f;
    if (lands) {
      y = __ldg(ray_ids + p);
      w = to_f32(f_dp[p]);
      lands = y >= 0 && y < n_rays;
    }
    ray[local] = y;
    weight[local] = w;
    keys[j] = lands ? (uint32_t)r : (uint32_t)ncells;
    pts[j] = (uint16_t)local;
    landing += lands;
  }
  if (!__syncthreads_or(landing)) return;

  Runs::sort(runs, keys, pts, key_bits);
  int32_t sorted_ray[kItems];
  float sorted_weight[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    sorted_ray[j] = ray[pts[j]];
    sorted_weight[j] = weight[pts[j]];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    ray[tid * kItems + j] = sorted_ray[j];
    weight[tid * kItems + j] = sorted_weight[j];
  }
  const int n_runs = Runs::number_runs(runs, keys);   // its closing barrier publishes them

  // the last run (key ncells) is the dropped points
  const int lane = tid & 31;
  const T* f_ctx = ctx + frame * (int64_t)n_rays * channels;
  float* f_acc = acc + frame * (int64_t)ncells * channels;
  if (lanes_per_row > 0) {
    // rows of 16-byte vectors: a group of lanes_per_row lanes reads one row
    // a step and takes a run of its own, so a warp sums 32 / lanes_per_row
    // runs at once (4 at C = 64 in bf16) with up to four rows each in
    // flight; the group adds its run's sum with float4 atomics
    constexpr int kV = 16 / sizeof(T);            // channels a vector
    const int group = lane / lanes_per_row, sub = lane % lanes_per_row;
    const int groups = 32 / lanes_per_row, row_vecs = channels / kV;
    for (int r = (tid >> 5) * groups + group; r < n_runs; r += (kThreads / 32) * groups) {
      const int key = runs.u.run_key[r];
      if (key >= ncells) continue;
      const int begin = runs.run_start[r], end = runs.run_start[r + 1];
      float* dst = f_acc + (int64_t)key * channels;
      for (int v = sub; v < row_vecs; v += lanes_per_row) {
        float sum[kV];
#pragma unroll
        for (int k = 0; k < kV; ++k) sum[k] = 0.0f;
#pragma unroll 4
        for (int i = begin; i < end; ++i) {
          fma_vec(sum, __ldg(reinterpret_cast<const uint4*>(
                                 f_ctx + (int64_t)ray[i] * channels) + v), weight[i]);
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
  for (int r = tid >> 5; r < n_runs; r += kThreads / 32) {
    const int key = runs.u.run_key[r];
    if (key >= ncells) continue;                  // warp-uniform
    const int begin = runs.run_start[r], end = runs.run_start[r + 1];
    float* dst = f_acc + (int64_t)key * channels;
    for (int c = lane; c < channels; c += 32) {
      float sum = 0.0f;
#pragma unroll 4
      for (int i = begin; i < end; ++i) {
        sum = fmaf(weight[i], to_f32(f_ctx[(int64_t)ray[i] * channels + c]), sum);
      }
      atomicAdd(dst + c, sum);
    }
  }
}

template <typename T, typename D>
cudaError_t launch(const void* ctx, const void* dp, const int32_t* ranks,
                   const int32_t* ray_ids, float* acc, int n_frames,
                   int64_t n_points, int n_rays, int channels, int ncells,
                   cudaStream_t stream) {
  const int key_bits = tile_runs::key_bits(ncells);
  const int lanes_per_row = tile_runs::lanes_per_row(channels * (int)sizeof(T),
                                                     (uintptr_t)ctx | (uintptr_t)acc);
  const int64_t tiles = (n_points + kTile - 1) / kTile;
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)n_frames);
  lift_splat_tile_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(ctx), static_cast<const D*>(dp), ranks, ray_ids, acc,
      n_points, n_rays, channels, ncells, key_bits, lanes_per_row);
  return cudaGetLastError();
}

}  // namespace

// ctx_dtype, dp_dtype: 0 = fp32, 1 = bf16. Returns the launch's cudaError_t.
extern "C" int lift_splat_accumulate(const void* ctx, int ctx_dtype, const void* dp,
                                     int dp_dtype, const void* ranks, const void* ray_ids,
                                     void* acc, int n_frames, int64_t n_points,
                                     int n_rays, int channels, int ncells, void* stream) {
  if (n_frames <= 0 || n_points <= 0) return (int)cudaSuccess;
  if (n_frames > 65535 || channels <= 0 || n_rays <= 0 || ncells <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((ctx_dtype | dp_dtype) & ~1) return (int)cudaErrorInvalidValue;
  const int32_t* r = static_cast<const int32_t*>(ranks);
  const int32_t* ray = static_cast<const int32_t*>(ray_ids);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ctx_dtype * 2 + dp_dtype) {
    case 0:
      return (int)launch<float, float>(ctx, dp, r, ray, a, n_frames, n_points, n_rays,
                                       channels, ncells, s);
    case 1:
      return (int)launch<float, __nv_bfloat16>(ctx, dp, r, ray, a, n_frames, n_points,
                                               n_rays, channels, ncells, s);
    case 2:
      return (int)launch<__nv_bfloat16, float>(ctx, dp, r, ray, a, n_frames, n_points,
                                               n_rays, channels, ncells, s);
    default:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(ctx, dp, r, ray, a, n_frames,
                                                       n_points, n_rays, channels, ncells, s);
  }
}
