// stamp: a device time stamp for core/spans.py, enqueued on the stream
// between two pieces of work (and so captured into a CUDA graph as a kernel
// node that runs on every replay).
//
// One thread reads %globaltimer (ns), adds the time since the previous
// stamp to its segment's total and counts the stamp:
//   acc[2 * seg] += now - *last   (skipped when *last is 0: the first stamp
//                                  after a reset has no previous one)
//   acc[2 * seg + 1] += 1
//   *last = now
// A stream runs its kernels in order, so the time between two stamps is the
// device time of the work enqueued between them, the gaps between its
// kernels included. Nothing is read back: the host reads acc once, after a
// synchronise.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* acc, long long* last, int seg) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  if (*last != 0) acc[2 * seg] += t - *last;
  acc[2 * seg + 1] += 1;
  *last = t;
}

}  // namespace

// acc: int64 (segments, 2); last: int64 (1,); both on the stream's device.
extern "C" int sgs_stamp(void* acc, void* last, int seg, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(acc), static_cast<long long*>(last), seg);
  return static_cast<int>(cudaGetLastError());
}
