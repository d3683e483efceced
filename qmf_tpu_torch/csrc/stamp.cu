// Time stamps on the device's own clock, for utils/tracing.py's part().
//
// Replaces no TPU kernel: the JAX package traces on the host alone. It is
// here because a span opened on the host is lost inside a replayed CUDA
// graph (the host does not pass through the captured code again), while a
// kernel node runs at every replay. One thread reads %globaltimer (the
// device's nanosecond clock) and writes (tag, ns) into the next slot of a
// ring in device memory; the slot comes from a 64-bit write counter on the
// device, so stamps of one stream land in the order they ran and the counter
// counts every stamp written, replays included (it is the launch count).
//
// Bound by nothing but its launch: 16 bytes written and one atomic. Its cost
// is one graph node or one launch, a few microseconds; it reads no operand,
// so it changes no arithmetic of the work around it.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* ring, unsigned long long* count,
                             unsigned long long entries, long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(count, 1ULL) % entries;
  ring[2 * slot] = tag;
  ring[2 * slot + 1] = (long long)now;
}

}  // namespace

extern "C" {

// Writes (tag, %globaltimer) into ring[(*count)++ % entries] on `stream`.
// ring is (entries, 2) int64 and count one uint64, both in device memory of
// `device`. The caller's current device is left as it was, so the caller
// needs no device guard (a stamp is on the host's path of every part).
// Does not synchronise. Returns the cudaError_t of the first call that
// failed.
int qmf_stamp(void* ring, void* count, long long entries, long long tag,
              int device, void* stream) {
  if (entries <= 0) return int(cudaErrorInvalidValue);
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err == cudaSuccess && caller != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  stamp_kernel<<<1, 1, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<unsigned long long*>(count),
      (unsigned long long)entries, tag);
  err = cudaGetLastError();
  if (caller != device) {
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  return int(err);
}

}  // extern "C"
