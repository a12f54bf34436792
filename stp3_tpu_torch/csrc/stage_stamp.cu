// The stage stamp: one thread writes the device's nanosecond clock and a
// stamp id into the next slot of a ring (utils/profiling.py's device
// spans).
//
// Replaces no TPU kernel: the JAX package's spans are host ranges of
// jax.profiler. It exists because the port's hot paths are CUDA graphs,
// and a graph's replay carries no host range: a stamp is a kernel, so a
// capture records it and every replay writes it again, in stream order
// between the stage's kernels.
//
// Contract: ring is (2 + 2 x capacity) unsigned 64-bit words on the
// device, zeroed once by its owner: word 0 counts the stamps written (an
// atomic index, so each stamp takes a slot of its own), word 1 is unused
// (the slots start 16-byte aligned), and slot k is words 2 + 2k (the
// %globaltimer reading, in ns) and 3 + 2k (the id). The index wraps
// modulo capacity; the host reads a slot before the ring comes round to
// it again.
//
// What bounds it on an H100: the launch, ~2 us inside a graph; the
// kernel itself is one atomic and two 8-byte stores.

#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp_kernel(unsigned long long* ring, unsigned long long capacity,
                                   unsigned long long id) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(ring, 1ULL) % capacity;
  ring[2 + 2 * slot] = now;
  ring[3 + 2 * slot] = id;
}

}  // namespace

// One stamp on `stream`; returns the launch's cudaError_t.
extern "C" int stage_stamp(void* ring, unsigned long long capacity, unsigned long long id,
                           void* stream) {
  if (ring == nullptr || capacity == 0) return (int)cudaErrorInvalidValue;
  stage_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), capacity, id);
  return (int)cudaGetLastError();
}
