// Red-black SOR half-sweeps on the coupled 5-point system.
//
// Replaces the Pallas TPU kernel _kernel of octane_tpu/ops/pallas/sor.py
// (:257, called at :421).  The update is that kernel's (and the reference
// loop flow/cg.py sor_solve's): the residual r = b - A x under the
// mirror-at-1 edges, the exact 2 x 2 block solve (a1 a2; a2 a4) with the
// hoisted reciprocal determinant, and x += omega * block solve on one colour
// ((row + column) even is red).  Each product and sum is rounded on its own
// in the order of ops/sor.py sor_sweep_plain, so the kernels equal the plain
// version bit for bit.
//
// Layout: x is (2, h, w) (u then v); cf is the coefficient stack of
// ops/sor.py build_cf, [a1, a4, a2, bu, bv, rdet] (quad: off-diagonals the
// scalar -1) or [a1, a4, a2, bu, bv, a5, a6, a7, a8, rdet].
//
// Two kernels:
//   * sor_update: one colour in place, one thread per cell of that colour.
//     A cell reads only its own value and the other colour's, so there is
//     no race inside the launch.
//   * sor_resid: the first half-sweep of a pass.  One thread per pixel
//     takes the pre-update residual of both colours from x and writes the
//     updated colour and a copy of the other one to a second buffer (in
//     place, the black residual would race with the red writes), plus one
//     partial of ||r||^2 per 32 x 8 block, summed in a fixed order (no
//     atomics).  That is the stopping rule's full-grid residual of the
//     pass's incoming iterate (sor.py:325-345).
//
// Left behind from the TPU kernel: the temporal blocking over 2S overlap
// rows in VMEM, the colour packing (_deinterleave/_interleave), the band
// height model and the identity padding rows: cells are indexed directly
// and the edges are index fix-ups.
//
// Bound: memory.  A half-sweep reads every 32-byte sector of the nc
// coefficient planes and the 2 state planes (a colour's cells are every
// other float) and writes half of the state: ~12 plane reads in the robust
// steps, ~1.4 GB at 5424^2.  Temporal blocking in shared memory is the
// later optimisation.

#include "common.cuh"

namespace {

using octane::add;
using octane::mul;
using octane::sub;

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kWarps = kBX * kBY / 32;

struct Cell {
  float xu, xv, ru, rv;
};

// x and the pre-update residual at one pixel
template <bool QUAD>
__device__ __forceinline__ Cell residual(const float* x, const float* cf,
                                         size_t plane, const octane::Stencil5& n) {
  const float* xv_p = x + plane;
  Cell c;
  c.xu = x[n.o];
  c.xv = xv_p[n.o];
  const float wu = x[n.ow], eu = x[n.oe], nu = x[n.on], su = x[n.os];
  const float wv = xv_p[n.ow], ev = xv_p[n.oe], nv = xv_p[n.on], sv = xv_p[n.os];
  float off_u, off_v;
  if (QUAD) {
    off_u = add(add(add(-wu, -eu), -nu), -su);
    off_v = add(add(add(-wv, -ev), -nv), -sv);
  } else {
    const float a5 = cf[5 * plane + n.o], a6 = cf[6 * plane + n.o];
    const float a7 = cf[7 * plane + n.o], a8 = cf[8 * plane + n.o];
    off_u = add(add(add(mul(a5, wu), mul(a7, eu)), mul(a6, nu)), mul(a8, su));
    off_v = add(add(add(mul(a5, wv), mul(a7, ev)), mul(a6, nv)), mul(a8, sv));
  }
  const float a1 = cf[n.o], a4 = cf[plane + n.o], a2 = cf[2 * plane + n.o];
  const float au = add(add(mul(a1, c.xu), mul(a2, c.xv)), off_u);
  const float av = add(add(mul(a2, c.xu), mul(a4, c.xv)), off_v);
  c.ru = sub(cf[3 * plane + n.o], au);
  c.rv = sub(cf[4 * plane + n.o], av);
  return c;
}

// x + omega * (a1 a2; a2 a4)^-1 r, written to out at pixel o
template <bool QUAD>
__device__ __forceinline__ void update(const Cell& c, const float* cf, size_t plane,
                                       size_t o, float omega, float* out) {
  const float a1 = cf[o], a4 = cf[plane + o], a2 = cf[2 * plane + o];
  const float rdet = cf[(QUAD ? 5 : 9) * plane + o];
  const float ndu = mul(sub(mul(a4, c.ru), mul(a2, c.rv)), rdet);
  const float ndv = mul(sub(mul(a1, c.rv), mul(a2, c.ru)), rdet);
  out[o] = add(c.xu, mul(omega, ndu));
  out[plane + o] = add(c.xv, mul(omega, ndv));
}

template <bool QUAD>
__global__ void __launch_bounds__(kBX * kBY) sor_update(
    float* x, const float* __restrict__ cf, int h, int w, int colour, float omega) {
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int j = 2 * (blockIdx.x * kBX + threadIdx.x) + ((i + colour) & 1);
  if (i >= h || j >= w) return;
  const size_t plane = (size_t)h * w;
  const octane::Stencil5 n = octane::stencil5(i, j, h, w);
  const Cell c = residual<QUAD>(x, cf, plane, n);
  update<QUAD>(c, cf, plane, n.o, omega, x);
}

template <bool QUAD>
__global__ void __launch_bounds__(kBX * kBY) sor_resid(
    const float* __restrict__ x, float* __restrict__ x_out,
    const float* __restrict__ cf, float* __restrict__ partials,
    int h, int w, int colour, float omega) {
  __shared__ float scratch[kWarps];
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const size_t plane = (size_t)h * w;
  float part = 0.f;
  if (i < h && j < w) {
    const octane::Stencil5 n = octane::stencil5(i, j, h, w);
    const Cell c = residual<QUAD>(x, cf, plane, n);
    part = add(mul(c.ru, c.ru), mul(c.rv, c.rv));
    if (((i + j) & 1) == colour) {
      update<QUAD>(c, cf, plane, n.o, omega, x_out);
    } else {
      x_out[n.o] = c.xu;
      x_out[plane + n.o] = c.xv;
    }
  }
  const float s = octane::block_sum<kWarps>(part, tid, scratch);
  if (tid == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

}  // namespace

// One half-sweep of colour ``colour`` (0 red, 1 black).  With partials ==
// nullptr it updates x in place (x_out is ignored); otherwise it reads x,
// writes the updated grid to x_out and one ||r||^2 partial per 32 x 8
// block of pixels (row-major over the blocks) to partials.
extern "C" int octane_sor_sweep(float* x, float* x_out, const float* cf,
                                float* partials, int h, int w, int quad,
                                int colour, float omega, void* stream) {
  const dim3 block(kBX, kBY);
  const cudaStream_t s = (cudaStream_t)stream;
  if (partials == nullptr) {
    const dim3 grid(((w + 1) / 2 + kBX - 1) / kBX, (h + kBY - 1) / kBY);
    if (quad) {
      sor_update<true><<<grid, block, 0, s>>>(x, cf, h, w, colour, omega);
    } else {
      sor_update<false><<<grid, block, 0, s>>>(x, cf, h, w, colour, omega);
    }
  } else {
    const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
    if (quad) {
      sor_resid<true><<<grid, block, 0, s>>>(x, x_out, cf, partials, h, w, colour, omega);
    } else {
      sor_resid<false><<<grid, block, 0, s>>>(x, x_out, cf, partials, h, w, colour, omega);
    }
  }
  return (int)cudaGetLastError();
}
