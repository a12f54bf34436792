// K4: fused lift + splat (depth probability x context row, scatter-added
// into the BEV grid), frame-batched.
//
// Replaces the TPU kernel
//   stp3_tpu/ops/pallas/bev_pool_kernel.py::lift_splat_pallas
//   (_lift_splat_forward, kernel _lift_scatter_kernel)
// which walks one frame's points serially over a VMEM-resident fp32
// accumulator with the whole (R, C) context table beside it. Hopper has no
// such sequential grid: its blocks run in parallel and in no order, so the
// accumulation is an fp32 atomicAdd, as in K1 (bev_pool.cu).
//
// Contract: ctx (F, R, C) and dp (F, P) each fp32 or bf16; ranks (F, P)
// int32 in [0, ncells]; ray_ids (P,) int32 in [0, R), shared by every
// frame; acc (F, ncells, C) fp32, zeroed by the caller. For every point p
// of frame f whose rank r is in [0, ncells):
//     acc[f, r, :] += fp32(dp[f, p]) * fp32(ctx[f, ray_ids[p], :]).
// A point whose rank is outside [0, ncells) -- ncells is the "invalid
// point" id -- is skipped, and so is a ray id outside [0, R) (the contract
// excludes it; skipping keeps a bad id from reading outside the table).
//
// What it saves: the materialised path (lift, then K1) writes and re-reads
// the lifted (F, P, C) tensor, 186 MB in bf16 at the flagship shape (F=3,
// P=483,840, C=64). Here that product is formed in registers.
// What bounds it on an H100: the F*P*C fp32 atomics of the points that land
// (as many as K1's), not its bytes: the ranks, the ray ids and dp of the
// points that land, the ctx table (3.9 MB in bf16 at the flagship shape,
// L2-resident) and the output, ~33 MB. The 3 x 40,000 x 64 fp32
// accumulator (30.7 MB) fits in the card's 50 MB L2 (H100 data sheet), so
// the atomics resolve there. Design, K1's: one warp per point, its lanes on
// consecutive channels, so a warp's atomics hit one contiguous row
// (coalesced) and its ctx read is one contiguous row; the rank, ray id and
// dp loads are broadcasts within the warp; the invalid-point branch is
// warp-uniform, and a dropped point's ray id and dp are never read.
//
// Numerics: fp32 atomics add in an order that changes from run to run, so
// the result is nondeterministic in the last bits; compare it with a
// tolerance, never bit for bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, typename D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lift_splat_kernel(const T* __restrict__ ctx, const D* __restrict__ dp,
                  const int32_t* __restrict__ ranks, const int32_t* __restrict__ ray_ids,
                  float* __restrict__ acc, int64_t n_points, int n_rays,
                  int channels, int ncells) {
  const int64_t frame = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const T* f_ctx = ctx + frame * n_rays * channels;
  const D* f_dp = dp + frame * n_points;
  const int32_t* f_ranks = ranks + frame * n_points;
  float* f_acc = acc + frame * (int64_t)ncells * channels;

  for (int64_t p = warp; p < n_points; p += n_warps) {
    const int32_t r = __ldg(f_ranks + p);
    if (r < 0 || r >= ncells) continue;            // warp-uniform
    const int32_t ray = __ldg(ray_ids + p);
    if (ray < 0 || ray >= n_rays) continue;        // warp-uniform
    const float w = to_f32(f_dp[p]);
    const T* row = f_ctx + (int64_t)ray * channels;
    float* dst = f_acc + (int64_t)r * channels;
    for (int c = lane; c < channels; c += 32) {
      atomicAdd(dst + c, w * to_f32(row[c]));
    }
  }
}

template <typename T, typename D>
cudaError_t launch(const void* ctx, const void* dp, const int32_t* ranks,
                   const int32_t* ray_ids, float* acc, int n_frames,
                   int64_t n_points, int n_rays, int channels, int ncells,
                   cudaStream_t stream) {
  const int64_t blocks = (n_points + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dim3 grid((unsigned)(blocks < 1048576 ? blocks : 1048576), (unsigned)n_frames);
  lift_splat_kernel<T, D><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(ctx), static_cast<const D*>(dp), ranks, ray_ids, acc,
      n_points, n_rays, channels, ncells);
  return cudaGetLastError();
}

}  // namespace

// ctx_dtype, dp_dtype: 0 = fp32, 1 = bf16. Returns the launch's cudaError_t.
extern "C" int lift_splat_accumulate(const void* ctx, int ctx_dtype, const void* dp,
                                     int dp_dtype, const void* ranks, const void* ray_ids,
                                     void* acc, int n_frames, int64_t n_points,
                                     int n_rays, int channels, int ncells, void* stream) {
  if (n_frames <= 0 || n_points <= 0) return (int)cudaSuccess;
  if (n_frames > 65535 || channels <= 0 || n_rays <= 0) return (int)cudaErrorInvalidValue;
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
  return (int)cudaErrorInvalidValue;
}
