// The tracer's device clock stamp (utils.profiling, ops.stamp).
//
// No Pallas kernel of the JAX package corresponds: this is instrumentation.
// One thread reads the card's %globaltimer (nanoseconds) and stores it in
// slot ``slot`` of an int64 buffer that the caller owns.  Launched inside a
// captured graph it becomes a kernel node, so a replay writes the times at
// which the nodes before it had finished; launched eagerly it stamps the
// current stream.  Bounded by nothing but its launch: one 8-byte store.
//
// octane_stamp(buf, slot, stream) returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void octane_stamp_kernel(int64_t* buf, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = (int64_t)t;
}

}  // namespace

extern "C" int octane_stamp(void* buf, int slot, void* stream) {
  octane_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((int64_t*)buf, slot);
  return (int)cudaGetLastError();
}
