// Shared helpers of the octane_tpu_torch CUDA kernels: deterministic block
// reductions (fixed shuffle tree, then the warp partials in warp order; no
// atomics, so a result never depends on scheduling).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace octane {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(kFullMask, v, o));
  return v;
}

// Sum of ``v`` over a block of NWARPS full warps; the result is valid in
// thread 0 only.  ``tid`` is the linear thread index.  ``scratch`` holds
// at least NWARPS floats of shared memory.
template <int NWARPS>
__device__ __forceinline__ float block_sum(float v, int tid, float* scratch) {
  v = warp_sum(v);
  if ((tid & 31) == 0) scratch[tid >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (tid == 0) {
    s = scratch[0];
    for (int i = 1; i < NWARPS; ++i) s = __fadd_rn(s, scratch[i]);
  }
  return s;
}

}  // namespace octane
