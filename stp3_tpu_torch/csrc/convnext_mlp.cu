// K2: the fused ConvNeXt MLP tail over (N, C) rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   stp3_tpu/ops/pallas/convnext_mlp_kernel.py::convnext_mlp_pallas
//   (kernel _mlp_kernel). Per row:
//     u = LayerNorm(h; scale, bias, eps 1e-6)  fp32 stats, var = E[x^2] - mean^2
//     a = bf16(u) @ bf16(W1) + b1              fp32 accumulate, 4C wide
//     g = gelu_tanh(a)
//     o = bf16(g) @ bf16(W2) + b2              fp32 accumulate
//     y = x + gamma * o                        stored in x's dtype
//   with the rounding points of the JAX plain mirror _mlp_reference.
//
// What bounds it on an H100: bytes. At C = 64 a row reads h and x and
// writes y (384 B in bf16) against 2 x 64 x 256 x 2 = 65,536 FLOPs,
// ~170 FLOP/B, under the ~295 FLOP/B at which the bf16 tensor cores
// rather than HBM become the limit (H100 data sheet: 989 TFLOP/s,
// 3.35 TB/s). Next in line are the 256 GELUs a row (154 M at the serving
// shape), whose tanh is one MUFU op here.
//
// Design:
// - Persistent CTAs, one per SM. Each loads W1 and W2 (2 x 32 KB bf16)
//   into shared memory once, in the 128-byte-swizzled K-major layout that
//   wgmma's B operand reads, plus LN scale/bias, b1, b2 and gamma; then
//   walks 64-row tiles, one tile at a time per consumer warpgroup: 3
//   consumers with rings of 2 stages for bf16 rows (8 KB tiles), 2 with 2
//   for fp32 rows (16 KB tiles; a third would not fit in 227 KB). On an
//   H100 at the bf16 serving row counts 3 x 2 ran faster than 2 x 3
//   (PERF.md).
// - Loads: a producer warp keeps each consumer's ring of h and x tiles
//   filled with the TMA engine's bulk copies (cp.async.bulk, completion
//   on an mbarrier). A tile of 64 contiguous rows is one contiguous block,
//   so a 1-D bulk copy moves it whole; a tensor map (cuTensorMapEncodeTiled,
//   linked from libcuda) would add only a swizzle, which the channel
//   permutation below makes unnecessary.
// - Channel permutation. wgmma's register fragments give thread (g, t) of
//   a warp (g = lane / 4, t = lane % 4) the logical columns 8i + 2t + e
//   (i < 8, e < 2) of rows g and g + 8. Logical column 8i + 2t + e is
//   mapped to channel pi = 16t + 2i + e, for the K of product 1 and the N
//   of product 2 alike (W1's rows and W2's columns are stored permuted),
//   so each thread owns 16 consecutive channels of its two rows: the
//   LayerNorm reads and the epilogue's x reads and y stores are 16-byte
//   vectors, and a row's statistics are a 4-lane shuffle reduction.
// - LN in registers, then bf16(u) as the register A operand of product 1.
// - The hidden dimension in 4 chunks of 64: wgmma m64n64k16 over K = 64
//   gives a chunk of `a` (32 fp32 registers a thread); + b1, GELU, bf16
//   in registers; that accumulator layout is the A-operand layout, so the
//   chunk feeds product 2 (wgmma m64n64k16 over its 64 hidden columns)
//   straight from registers, accumulating o (32 registers). The (64, 256)
//   hidden tile is never live whole and never touches shared memory.
// - Epilogue: + b2, x gamma, + x from the staged tile, cast, 16-byte
//   stores; rows past N are not stored.
// - GELU: tanh.approx.f32 (one MUFU op; relative error ~2^-11, below the
//   bf16 rounding of g that follows it).
//
// C is a compile-time 64 (every configuration of the repository);
// convnext_mlp_channels() reports it and the launch refuses any other C.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // channels
constexpr int kHidden = 4 * kC;        // 256
constexpr int kRows = 64;              // rows per tile: wgmma's M
constexpr int kChunk = 64;             // hidden columns per chunk
constexpr float kEps = 1e-6f;
constexpr float kK0 = 0.7978845608028654f;        // sqrt(2 / pi)

// consumer warpgroups a CTA and ring stages a consumer, by row type
template <typename T> struct Layout {
  static constexpr int consumers = 3, stages = 2;       // bf16: 8 KB tiles
};
template <> struct Layout<float> {
  static constexpr int consumers = 2, stages = 2;       // fp32: 16 KB tiles
};
// + one producer warp
template <typename T> constexpr int threads_of() { return Layout<T>::consumers * 128 + 32; }

template <typename T>
struct Smem {
  __nv_bfloat16 w1[kHidden * kC];      // B of product 1: 256 rows (hidden) x 64 (K)
  __nv_bfloat16 w2[kHidden * kC];      // B of product 2: 4 chunks of 64 rows (C) x 64 (K)
  T h[Layout<T>::consumers][Layout<T>::stages][kRows * kC];
  T x[Layout<T>::consumers][Layout<T>::stages][kRows * kC];
  float scale[kC], bias[kC], b2[kC], gamma[kC], b1[kHidden];
  uint64_t full[Layout<T>::consumers][Layout<T>::stages];
  uint64_t empty[Layout<T>::consumers][Layout<T>::stages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row n, column k < 64) in a 128-byte-swizzled K-major
// bf16 tile: 8-row groups of 1,024 bytes, 16-byte chunk c of row n at c ^ (n % 8)
__device__ __forceinline__ int swizzled(int n, int k) {
  return (n >> 3) * 512 + (n & 7) * 64 + ((((k >> 3) ^ n) & 7) << 3) + (k & 7);
}

// the logical fragment column of channel c (the inverse of pi above)
__device__ __forceinline__ int logical_column(int c) {
  return 8 * ((c & 15) >> 1) + 2 * (c >> 4) + (c & 1);
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A barrier that
// never completes (a fault in this file) traps after ~2^33 cycles rather
// than hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// one contiguous global -> shared bulk copy, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// ------------------------------------------------------------------- wgmma
// B descriptor of a 128-byte-swizzled K-major tile: 8-row groups 1,024
// bytes apart (SBO), LBO unused for this layout, layout type 1 (128B)
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// fence, commit or wait
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64 fp32) (+)= a (64 x 16 bf16, registers) @ B (16 x 64 bf16, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// ------------------------------------------------------------- elementwise
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float gelu_tanh(float a) {
  float th;
  const float z = kK0 * a * fmaf(0.044715f, a * a, 1.0f);
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(z));
  const float half = 0.5f * a;
  return fmaf(half, th, half);
}

// 16 consecutive channels of one staged row, as fp32
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float (&v)[16]) {
  const uint4 q[2] = {reinterpret_cast<const uint4*>(src)[0],
                      reinterpret_cast<const uint4*>(src)[1]};
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(q);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const float* src, float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(src)[i];
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float (&v)[16]) {
  uint4 q[2];
  uint32_t* w = reinterpret_cast<uint32_t*>(q);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  reinterpret_cast<uint4*>(dst)[0] = q[0];
  reinterpret_cast<uint4*>(dst)[1] = q[1];
}

__device__ __forceinline__ void store16(float* dst, const float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    reinterpret_cast<float4*>(dst)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                                    v[4 * i + 3]);
  }
}

// ------------------------------------------------------------------ kernel
template <typename T>
__global__ void __launch_bounds__(threads_of<T>(), 1)
convnext_mlp_kernel(const T* __restrict__ h, const T* __restrict__ x, T* __restrict__ out,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ gamma, int n_rows) {
  constexpr int kConsumers = Layout<T>::consumers;
  constexpr int kStages = Layout<T>::stages;
  extern __shared__ uint8_t smem_raw[];
  // 1,024-byte alignment: the swizzle is a function of the address bits
  Smem<T>& s = *reinterpret_cast<Smem<T>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int tile_stride = gridDim.x * kConsumers;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int w = 0; w < kConsumers; ++w) {
      for (int st = 0; st < kStages; ++st) {
        bar_init(&s.full[w][st], 1);            // the producer's arrive + the bytes
        bar_init(&s.empty[w][st], 128);         // every thread of the consumer
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {
    // ---- producer warp: one thread keeps every consumer's ring filled
    if ((threadIdx.x & 31) != 0) return;
    for (int k = 0;; ++k) {
      bool any = false;
      for (int w = 0; w < kConsumers; ++w) {
        const int tile = blockIdx.x * kConsumers + w + k * tile_stride;
        if (tile >= n_tiles) continue;
        any = true;
        const int st = k % kStages, use = k / kStages;
        if (use > 0) bar_wait(&s.empty[w][st], (use - 1) & 1);
        const int rows = min(kRows, n_rows - tile * kRows);
        const uint32_t bytes = rows * kC * sizeof(T);
        const int64_t offset = (int64_t)tile * kRows * kC;
        bar_arrive_expect_tx(&s.full[w][st], 2 * bytes);
        bulk_load(s.h[w][st], h + offset, bytes, &s.full[w][st]);
        bulk_load(s.x[w][st], x + offset, bytes, &s.full[w][st]);
      }
      if (!any) return;
    }
  }

  // ---- consumers: first the weights and parameters, once per CTA, while
  // the producer's first loads are in flight
  const int tid = threadIdx.x;                  // < kConsumers * 128
  // a warp's threads take 32 channels of W1 (32 K columns of one B row)
  // and 32 hidden units of W2 (32 K columns of one B row), so that the
  // 2-byte stores of a warp fall into distinct shared-memory words
  for (int i = tid; i < kC * kHidden / 8; i += kConsumers * 128) {
    // W1 (C, 4C): hidden units n0..n0+7 of channel c -> B rows n, column logical(c)
    const int c = i % kC, n0 = (i / kC) * 8;
    const uint4 q1 = reinterpret_cast<const uint4*>(w1 + c * kHidden + n0)[0];
    const __nv_bfloat16* v1 = reinterpret_cast<const __nv_bfloat16*>(&q1);
    const int k1 = logical_column(c);
#pragma unroll
    for (int e = 0; e < 8; ++e) s.w1[swizzled(n0 + e, k1)] = v1[e];
    // W2 (4C, C): channels c0..c0+7 of hidden unit j -> chunk j / 64, B rows
    // logical(c), column j % 64
    const int j = i % kHidden, c0 = (i / kHidden) * 8;
    const uint4 q2 = reinterpret_cast<const uint4*>(w2 + j * kC + c0)[0];
    const __nv_bfloat16* v2 = reinterpret_cast<const __nv_bfloat16*>(&q2);
    __nv_bfloat16* chunk = s.w2 + (j / kChunk) * (kC * kChunk);
#pragma unroll
    for (int e = 0; e < 8; ++e) chunk[swizzled(logical_column(c0 + e), j % kChunk)] = v2[e];
  }
  for (int i = tid; i < kHidden; i += kConsumers * 128) s.b1[i] = b1[i];
  for (int i = tid; i < kC; i += kConsumers * 128) {
    s.scale[i] = scale[i];
    s.bias[i] = bias[i];
    s.b2[i] = b2[i];
    s.gamma[i] = gamma[i];
  }
  // make the weights visible to wgmma (the async proxy), then sync the consumers
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" :: "n"(kConsumers * 128) : "memory");

  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = ((tid & 127) >> 5) * 16 + g;     // and row0 + 8
  const int ch = 16 * t;                            // this thread's 16 channels

  float a[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = o[i] = 0.0f;

  for (int k = 0;; ++k) {
    const int tile = blockIdx.x * kConsumers + wg + k * tile_stride;
    if (tile >= n_tiles) break;
    const int st = k % kStages;
    bar_wait(&s.full[wg][st], (k / kStages) & 1);
    const T* hs = s.h[wg][st];
    const T* xs = s.x[wg][st];

    // LayerNorm of rows row0 and row0 + 8 -> the A operand of product 1
    uint32_t pu[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[16];
      load16(hs + (row0 + 8 * r) * kC + ch, v);
      float sum = 0.0f, sq = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sum += v[i];
        sq += v[i] * v[i];
      }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, m);
        sq += __shfl_xor_sync(0xffffffffu, sq, m);
      }
      const float mean = sum * (1.0f / kC);
      const float rstd = rsqrtf(sq * (1.0f / kC) - mean * mean + kEps);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float u0 = (v[2 * i] - mean) * rstd * s.scale[ch + 2 * i] + s.bias[ch + 2 * i];
        const float u1 =
            (v[2 * i + 1] - mean) * rstd * s.scale[ch + 2 * i + 1] + s.bias[ch + 2 * i + 1];
        pu[r][i] = pack_bf16(u0, u1);
      }
    }

#pragma unroll
    for (int j = 0; j < kHidden / kChunk; ++j) {
      // product 1, hidden chunk j: a = bf16(u) @ W1[:, 64j : 64j + 64]
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        const uint32_t frag[4] = {pu[0][2 * kk], pu[1][2 * kk], pu[0][2 * kk + 1],
                                  pu[1][2 * kk + 1]};
        wgmma_rs(a, frag, b_desc(s.w1 + j * (kChunk * kC) + kk * 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();                 // also retires the previous chunk's product 2
      fence_regs(a);
      fence_regs(o);

      // + b1, GELU, bf16: the accumulator's layout is product 2's A layout
      uint32_t pg[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 bb = *reinterpret_cast<const float2*>(s.b1 + j * kChunk + 8 * i + 2 * t);
        pg[2 * i] = pack_bf16(gelu_tanh(a[4 * i] + bb.x), gelu_tanh(a[4 * i + 1] + bb.y));
        pg[2 * i + 1] =
            pack_bf16(gelu_tanh(a[4 * i + 2] + bb.x), gelu_tanh(a[4 * i + 3] + bb.y));
      }

      // product 2: o += bf16(g) @ W2[64j : 64j + 64, :]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const uint32_t frag[4] = {pg[4 * kk], pg[4 * kk + 1], pg[4 * kk + 2], pg[4 * kk + 3]};
        wgmma_rs(o, frag, b_desc(s.w2 + j * (kC * kChunk) + kk * 16), j > 0 || kk > 0);
      }
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(o);

    // epilogue: o[4i + e] (row0) and o[4i + 2 + e] (row0 + 8) are channel ch + 2i + e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      float y[16];
      load16(xs + row * kC + ch, y);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = ch + 2 * i + e;
          y[2 * i + e] += s.gamma[c] * (o[4 * i + 2 * r + e] + s.b2[c]);
        }
      }
      if (tile * kRows + row < n_rows) store16(out + ((int64_t)tile * kRows + row) * kC + ch, y);
    }
    bar_arrive(&s.empty[wg][st]);
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* x, void* out, const float* scale,
                   const float* bias, const __nv_bfloat16* w1, const float* b1,
                   const __nv_bfloat16* w2, const float* b2, const float* gamma, int n_rows,
                   cudaStream_t stream) {
  // the opt-in to more than 48 KB of dynamic shared memory, once per device
  static bool configured[64] = {};
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t smem = sizeof(Smem<T>) + 1024;   // + room to align to 1,024 bytes
  if (err == cudaSuccess && !(device < 64 && configured[device])) {
    err = cudaFuncSetAttribute(convnext_mlp_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && device < 64) configured[device] = true;
  }
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_rows + kRows - 1) / kRows;
  const int want = (n_tiles + Layout<T>::consumers - 1) / Layout<T>::consumers;
  const int grid = want < sms ? want : sms;
  convnext_mlp_kernel<T><<<grid, threads_of<T>(), smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x), static_cast<T*>(out), scale, bias,
      w1, b1, w2, b2, gamma, n_rows);
  return cudaGetLastError();
}

}  // namespace

// The channel count the kernel is built for.
extern "C" int convnext_mlp_channels() { return kC; }

// The dynamic shared memory a CTA takes for rows of `dtype` (0 fp32, 1 bf16).
extern "C" int convnext_mlp_smem_bytes(int dtype) {
  return (int)(dtype == 0 ? sizeof(Smem<float>) : sizeof(Smem<__nv_bfloat16>)) + 1024;
}

// h, x, out: (n_rows, channels) contiguous, 16-byte aligned; dtype 0 =
// fp32, 1 = bf16. scale, bias, b1, b2, gamma fp32; w1 (C, 4C) and w2
// (4C, C) bf16, contiguous. Returns the launch's cudaError_t.
extern "C" int convnext_mlp(const void* h, const void* x, void* out, int dtype,
                            const void* scale, const void* bias, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* gamma, int n_rows, int channels, void* stream) {
  if (channels != kC || n_rows < 0) return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)h | (uintptr_t)x | (uintptr_t)out | (uintptr_t)w1 | (uintptr_t)w2) & 15) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (n_rows == 0) return (int)cudaSuccess;
  const float* f[5] = {static_cast<const float*>(scale), static_cast<const float*>(bias),
                       static_cast<const float*>(b1), static_cast<const float*>(b2),
                       static_cast<const float*>(gamma)};
  const __nv_bfloat16* wa = static_cast<const __nv_bfloat16*>(w1);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(h, x, out, f[0], f[1], wa, f[2], wb, f[3], f[4], n_rows, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(h, x, out, f[0], f[1], wa, f[2], wb, f[3], f[4], n_rows, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
