// Shared helpers of the octane_tpu_torch CUDA kernels: deterministic block
// reductions (fixed shuffle tree, then the warp partials in warp order; no
// atomics, so a result never depends on scheduling), the mirror-at-1
// neighbour offsets of the solver's stencil, and single-rounding float
// arithmetic (each op rounded on its own, as PyTorch's eager kernels do).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace octane {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// Pixel (i, j) of an (h, w) plane and its four neighbours with the
// mirror-at-1 edges of core/bc.py mirror_shift: row 0's north is row 1,
// row h-1's south is row h-2, and the same for columns.
struct Stencil5 {
  int jw, je, in, is;
  size_t o, ow, oe, on, os;
};

__device__ __forceinline__ Stencil5 stencil5(int i, int j, int h, int w) {
  Stencil5 s;
  s.jw = j == 0 ? 1 : j - 1;
  s.je = j == w - 1 ? w - 2 : j + 1;
  s.in = i == 0 ? 1 : i - 1;
  s.is = i == h - 1 ? h - 2 : i + 1;
  s.o = (size_t)i * w + j;
  s.ow = (size_t)i * w + s.jw;
  s.oe = (size_t)i * w + s.je;
  s.on = (size_t)s.in * w + j;
  s.os = (size_t)s.is * w + j;
  return s;
}

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
