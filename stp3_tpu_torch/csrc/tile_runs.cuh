// The tile machinery that K1 (bev_pool.cu) and K4 (lift_splat.cu) share.
//
// Both scatter-add point rows onto a BEV grid whose cells repeat within a
// tile of consecutive points far more often than between neighbours (the
// points are ordered camera, depth bin, pixel row, pixel column). A block
// takes a tile of kThreads x kItems points of one frame, sorts the tile's
// (rank, point-in-tile) pairs on the rank's significant bits
// (cub::BlockRadixSort; a dropped point takes the key ncells and sorts
// last), flags the heads of equal-rank runs and numbers them with a block
// scan. The kernel then sums each run's rows in registers and adds the sum
// with one vector atomic per 4 channels (red_add_v4).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace tile_runs {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a vector atomic add to global memory (compute capability 9.x) that
// returns nothing, so that no thread waits for the old value
__device__ __forceinline__ void red_add_v4(float* dst, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(dst), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

// the radix sort's key bits: enough to hold ncells, the dropped points' key
inline int key_bits(int ncells) {
  int bits = 1;
  while (bits < 31 && ((int64_t)1 << bits) <= ncells) ++bits;
  return bits;
}

// Lanes that read one row of row_bytes as 16-byte vectors: the row's
// vectors rounded up to a power of two, at most 32; 0 (the scalar path)
// when a row is not whole vectors or a base (bases: the OR of the row
// table's and the sums' addresses) is not 16-byte aligned.
inline int lanes_per_row(int row_bytes, uintptr_t bases) {
  if (row_bytes % 16 != 0 || (bases & 15) != 0) return 0;
  int lanes = 1;
  while (lanes < 32 && lanes * 16 < row_bytes) lanes <<= 1;
  return lanes;
}

template <int kThreads, int kItems>
struct TileRuns {
  static constexpr int kTile = kThreads * kItems;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, uint16_t>;
  using Scan = cub::BlockScan<int, kThreads>;

  struct Storage {
    union {
      typename Sort::TempStorage sort;
      int run_key[kTile];                 // written once the sort is done
    } u;
    typename Scan::TempStorage scan;
    uint16_t run_start[kTile + 1];        // run r is sorted items [run_start[r], run_start[r + 1])
    uint32_t last_key[kThreads];
  };

  // Sorts the keys with each item's point in the tile. Blocked afterwards:
  // item j of thread t is sorted position t * kItems + j.
  static __device__ __forceinline__ void sort(Storage& s, uint32_t (&keys)[kItems],
                                              uint16_t (&pts)[kItems], int key_bits) {
    Sort(s.u.sort).Sort(keys, pts, 0, key_bits);
    s.last_key[threadIdx.x] = keys[kItems - 1];
  }

  // Called by every thread after a __syncthreads that follows sort():
  // numbers the runs of equal sorted keys (an exclusive scan of each
  // thread's run heads), writes run_start and run_key, and ends with a
  // __syncthreads. Returns the number of runs; the last run is the dropped
  // points' whenever the tile has one (key ncells).
  static __device__ __forceinline__ int number_runs(Storage& s,
                                                    const uint32_t (&keys)[kItems]) {
    const int tid = threadIdx.x;
    uint32_t prev = tid > 0 ? s.last_key[tid - 1] : ~0u;
    int heads = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      heads += keys[j] != prev;
      prev = keys[j];
    }
    int run, n_runs;
    Scan(s.scan).ExclusiveSum(heads, run, n_runs);
    prev = tid > 0 ? s.last_key[tid - 1] : ~0u;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (keys[j] != prev) {
        s.run_start[run] = (uint16_t)(tid * kItems + j);
        s.u.run_key[run] = (int)keys[j];
        ++run;
      }
      prev = keys[j];
    }
    if (tid == 0) s.run_start[n_runs] = (uint16_t)kTile;
    __syncthreads();
    return n_runs;
  }
};

}  // namespace tile_runs
