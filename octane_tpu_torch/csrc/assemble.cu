// The linearised Euler-Lagrange system of one GNC round, in two store
// layouts: the SOR coefficient stack (assemble_cf) and the PCG system
// (assemble_pcg).
//
// Replaces the Pallas TPU kernel _kernel of octane_tpu/ops/pallas/assemble.py
// (:52, called at :265): the Zimmer-normalised data terms of the warped
// samples, the robust psi smoothness weights blended by al1, the
// mirror-at-1 stencil coefficients, the rhs, and per-block partials that
// seed the solver's stopping rule.  The JAX package's PCG round runs the
// same arithmetic as XLA fusions (octane_tpu/flow/variational.py:78-103);
// assemble_pcg is its counterpart.
//
// SOR layout (ops/sor.py build_cf): [a1, a4, a2, bu, bv, rdet] in the
// quadratic step (al1 == 1; the off-diagonals are the scalar -1), else
// [a1, a4, a2, bu, bv, a5, a6, a7, a8, rdet], with the hoisted reciprocal
// block determinant rdet, and one ||b||^2 partial per block.
// PCG layout (ops/pcg.py pcg_solve_fused's stack): cf = [a1, a4, a2] or
// [a1, a4, a2, a5, a6, a7, a8], b = [bu, bv], and per block the three
// first sums of ops/pcg.py initial_partials: bu * (bu / a1),
// bv * (bv / a4) and bu^2 + bv^2.  It takes a row range [r_begin, r_end)
// of the slab it reads (a band's rows and the stencil's ghost rows) and
// writes those rows only, row r_begin first, with partials in 32 x 8
// blocks from r_begin (octane_sor_pass_band's convention); the whole image
// is the range [0, h).
//
// The arithmetic is flow/stencil.py assemble_samples, op for op and
// channel by channel, each product and sum rounded on its own (-fmad=false,
// __f*_rn), with the rounding PyTorch's CUDA kernels give its scalar forms:
// t / alpha is t times the float reciprocal of alpha (the wrapper passes
// it), 1 / t is a correctly rounded reciprocal, psi' is rsqrtf, and a
// tensor-by-tensor division (bu / a1) is IEEE-rounded (__fdiv_rn).  So
// both layouts equal their plain versions bit for bit.
//
// One thread per pixel in 32 x 8 blocks; the 4 neighbours of u and v (8 with
// the diagonals in the robust steps) come from global memory through L1/L2.
// Left behind from the TPU kernel: the shared zero-padded frame, the 8-row
// halo blocks, the 256-lane alignment and the identity padding rows (edges
// are index fix-ups), and the SMEM scalars (they are kernel arguments).
//
// Bound: memory.  Per pixel it reads 9C + 4 float planes and 2 flag bytes
// and writes 6 or 10 planes (SOR) or 5 or 9 (PCG): ~23 / ~22 planes in the
// robust steps with C = 1, ~2.7 GB at 5424^2.  Fusing the warp into it is
// the later optimisation.

#include "common.cuh"

namespace {

using octane::add;
using octane::mul;
using octane::sub;

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kWarps = kBX * kBY / 32;

struct Scalars {
  float al1, one_m_al1, lambdac, inv_alpha, lam_a;
};

// One pixel's equations: the diagonals, the coupling, the rhs and, in the
// robust steps, the off-diagonals [a5, a6, a7, a8] (west, north, east, south)
struct Pixel {
  float a1, a4, a2, bu, bv;
  float off[4];
};

__device__ __forceinline__ float sq(float x) { return mul(x, x); }

// psi'(x) = 1 / sqrt(x + 1e-6) (core/psi.py; torch.rsqrt is rsqrtf)
__device__ __forceinline__ float psi(float x) {
  return rsqrtf(add(x, static_cast<float>(1e-6)));
}

// the robust smoothness weight of one edge: the squared flow difference
// across it plus the squared quarter-sums of the differences along it
__device__ __forceinline__ float edge_weight(float du, float dut, float dv, float dvt) {
  const float q = 0.25f;
  return add(add(add(sq(du), sq(mul(q, dut))), sq(dv)), sq(mul(q, dvt)));
}

// The system at pixel (i, j) of the (h, w) slab: the arithmetic both
// layouts share.
template <bool QUAD>
__device__ __forceinline__ Pixel assemble_pixel(
    const float* __restrict__ g1s, const float* __restrict__ smp,
    const uint8_t* __restrict__ bcx, const uint8_t* __restrict__ bcy,
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ uhat, const float* __restrict__ vhat,
    int i, int j, int C, int h, int w, int dozim, const Scalars& s) {
  const size_t plane = (size_t)h * w;
  const octane::Stencil5 n = octane::stencil5(i, j, h, w);
  const size_t o = n.o;
  const float u = U[o], uW = U[n.ow], uE = U[n.oe], uN = U[n.on], uS = U[n.os];
  const float v = V[o], vW = V[n.ow], vE = V[n.oe], vN = V[n.on], vS = V[n.os];
  const float psisnmiuq = add(add(add(uW, uN), uE), uS);
  const float psisnmivq = add(add(add(vW, vN), vE), vS);

  // robust smoothness weights (stencil.py: the quadratic step skips them)
  float psis1 = 0.f, psis2 = 0.f, psis3 = 0.f, psis4 = 0.f;
  float psistot = 0.f, psisnmiu = 0.f, psisnmiv = 0.f;
  if (!QUAD) {
    const size_t rn = (size_t)n.in * w, rs = (size_t)n.is * w;
    const float uNE = U[rn + n.je], uSE = U[rs + n.je];
    const float uNW = U[rn + n.jw], uSW = U[rs + n.jw];
    const float vNE = V[rn + n.je], vSE = V[rs + n.je];
    const float vNW = V[rn + n.jw], vSW = V[rs + n.jw];
    const float u_ip1 = edge_weight(sub(uE, u), add(sub(uSE, uNE), sub(uS, uN)),
                                    sub(vE, v), add(sub(vSE, vNE), sub(vS, vN)));
    const float u_im1 = edge_weight(sub(u, uW), add(sub(uSW, uNW), sub(uS, uN)),
                                    sub(v, vW), add(sub(vSW, vNW), sub(vS, vN)));
    const float u_jp1 = edge_weight(sub(uS, u), add(sub(uSE, uSW), sub(uE, uW)),
                                    sub(vS, v), add(sub(vSE, vSW), sub(vE, vW)));
    const float u_jm1 = edge_weight(sub(u, uN), add(sub(uNE, uNW), sub(uE, uW)),
                                    sub(v, vN), add(sub(vNE, vNW), sub(vE, vW)));
    psis1 = psi(u_im1);   // west
    psis2 = psi(u_jm1);   // north
    psis3 = psi(u_ip1);   // east
    psis4 = psi(u_jp1);   // south
    psistot = add(add(add(psis1, psis2), psis3), psis4);
    psisnmiu = add(add(add(mul(psis1, uW), mul(psis2, uN)), mul(psis3, uE)), mul(psis4, uS));
    psisnmiv = add(add(add(mul(psis1, vW), mul(psis2, vN)), mul(psis3, vE)), mul(psis4, vS));
  }

  // warped data terms, accumulated over channels; the warped gradients are
  // zero where the warp clamped
  const bool bx = bcx[o] != 0, by = bcy[o] != 0, bxy = bx || by;
  float ic = 0.f, ic2 = 0.f;
  float vr1 = 0.f, vr2 = 0.f, vr4 = 0.f, vr5 = 0.f, vr6 = 0.f;
  float vr12 = 0.f, vr22 = 0.f, vr42 = 0.f, vr52 = 0.f, vr62 = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g2w = smp[(size_t)c * plane + o];
    const float ix = bx ? 0.f : smp[(size_t)(C + c) * plane + o];
    const float iy = by ? 0.f : smp[(size_t)(2 * C + c) * plane + o];
    const float ixx = bx ? 0.f : smp[(size_t)(3 * C + c) * plane + o];
    const float ixy = bxy ? 0.f : smp[(size_t)(4 * C + c) * plane + o];
    const float iyy = by ? 0.f : smp[(size_t)(5 * C + c) * plane + o];
    const float it = sub(g2w, g1s[(size_t)c * plane + o]);
    const float ixt = sub(ix, g1s[(size_t)(C + c) * plane + o]);
    const float iyt = sub(iy, g1s[(size_t)(2 * C + c) * plane + o]);
    float na = 1.f, nb = 1.f, nc = 1.f;
    if (dozim) {
      na = __frcp_rn(add(add(mul(ix, ix), mul(iy, iy)), 1.f));
      nb = __frcp_rn(add(add(mul(ixx, ixx), mul(ixy, ixy)), 1.f));
      nc = __frcp_rn(add(add(mul(ixy, ixy), mul(iyy, iyy)), 1.f));
    }
    ic = add(ic, mul(mul(na, it), it));
    ic2 = add(add(ic2, mul(mul(nb, ixt), ixt)), mul(mul(nc, iyt), iyt));
    vr1 = add(vr1, mul(mul(na, ix), ix));
    vr12 = add(add(vr12, mul(mul(nb, ixx), ixx)), mul(mul(nc, ixy), ixy));
    vr2 = add(vr2, mul(mul(na, ix), iy));
    vr22 = add(add(vr22, mul(mul(nb, ixx), ixy)), mul(mul(nc, iyy), ixy));
    vr4 = add(vr4, mul(mul(na, iy), iy));
    vr42 = add(add(vr42, mul(mul(nb, ixy), ixy)), mul(mul(nc, iyy), iyy));
    vr5 = add(vr5, mul(mul(-na, it), ix));
    vr52 = sub(vr52, add(mul(mul(nb, ixt), ixx), mul(mul(nc, iyt), ixy)));
    vr6 = add(vr6, mul(mul(-na, it), iy));
    vr62 = sub(vr62, add(mul(mul(nb, ixt), ixy), mul(mul(nc, iyt), iyy)));
  }

  const float ia = s.inv_alpha, la = s.lam_a, lc = s.lambdac;
  const float hint_u = mul(lc, sub(u, uhat[o]));
  const float hint_v = mul(lc, sub(v, vhat[o]));
  // the quadratic system (the whole of it in the quadratic step)
  Pixel p;
  p.a1 = add(add(add(mul(vr1, ia), mul(la, vr12)), lc), 4.f);
  p.a2 = add(mul(vr2, ia), mul(la, vr22));
  p.a4 = add(add(add(mul(vr4, ia), mul(la, vr42)), lc), 4.f);
  p.bu = sub(add(sub(add(mul(vr5, ia), mul(la, vr52)), hint_u), psisnmiuq), mul(4.f, u));
  p.bv = sub(add(sub(add(mul(vr6, ia), mul(la, vr62)), hint_v), psisnmivq), mul(4.f, v));
  if (!QUAD) {
    const float al1 = s.al1, om = s.one_m_al1;
    const float psid = mul(psi(ic), ia);
    const float psid2 = mul(la, psi(ic2));
    p.a1 = add(mul(al1, p.a1),
               mul(om, add(add(add(mul(psid, vr1), mul(psid2, vr12)), lc), psistot)));
    p.a2 = add(mul(al1, p.a2), mul(om, add(mul(psid, vr2), mul(psid2, vr22))));
    p.a4 = add(mul(al1, p.a4),
               mul(om, add(add(add(mul(psid, vr4), mul(psid2, vr42)), lc), psistot)));
    p.bu = add(mul(al1, p.bu),
               mul(om, sub(add(sub(add(mul(psid, vr5), mul(psid2, vr52)), hint_u), psisnmiu),
                           mul(psistot, u))));
    p.bv = add(mul(al1, p.bv),
               mul(om, sub(add(sub(add(mul(psid, vr6), mul(psid2, vr62)), hint_v), psisnmiv),
                           mul(psistot, v))));
    p.off[0] = -add(al1, mul(om, psis1));
    p.off[1] = -add(al1, mul(om, psis2));
    p.off[2] = -add(al1, mul(om, psis3));
    p.off[3] = -add(al1, mul(om, psis4));
  }
  return p;
}

template <bool QUAD>
__global__ void __launch_bounds__(kBX * kBY) assemble_cf(
    const float* __restrict__ g1s, const float* __restrict__ smp,
    const uint8_t* __restrict__ bcx, const uint8_t* __restrict__ bcy,
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ uhat, const float* __restrict__ vhat,
    float* __restrict__ cf, float* __restrict__ partials,
    int C, int h, int w, int dozim, Scalars s) {
  __shared__ float scratch[kWarps];
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const size_t plane = (size_t)h * w;
  float part = 0.f;
  if (i < h && j < w) {
    const Pixel p = assemble_pixel<QUAD>(g1s, smp, bcx, bcy, U, V, uhat, vhat, i, j, C, h,
                                         w, dozim, s);
    float* out = cf + (size_t)i * w + j;
    if (!QUAD) {
      for (int k = 0; k < 4; ++k) out[(5 + k) * plane] = p.off[k];
    }
    out[0] = p.a1;
    out[plane] = p.a4;
    out[2 * plane] = p.a2;
    out[3 * plane] = p.bu;
    out[4 * plane] = p.bv;
    out[(QUAD ? 5 : 9) * plane] = __frcp_rn(sub(mul(p.a1, p.a4), mul(p.a2, p.a2)));
    part = add(mul(p.bu, p.bu), mul(p.bv, p.bv));
  }
  const float sum = octane::block_sum<kWarps>(part, tid, scratch);
  if (tid == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = sum;
}

template <bool QUAD>
__global__ void __launch_bounds__(kBX * kBY) assemble_pcg(
    const float* __restrict__ g1s, const float* __restrict__ smp,
    const uint8_t* __restrict__ bcx, const uint8_t* __restrict__ bcy,
    const float* __restrict__ U, const float* __restrict__ V,
    const float* __restrict__ uhat, const float* __restrict__ vhat,
    float* __restrict__ cf, float* __restrict__ b, float* __restrict__ partials,
    int C, int h, int w, int r_begin, int r_end, int dozim, Scalars s) {
  __shared__ float scratch[3][kWarps];
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = r_begin + blockIdx.y * kBY + threadIdx.y;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const size_t plane = (size_t)(r_end - r_begin) * w;     // of the outputs
  float zu = 0.f, zv = 0.f, bb = 0.f;
  if (i < r_end && j < w) {
    const Pixel p = assemble_pixel<QUAD>(g1s, smp, bcx, bcy, U, V, uhat, vhat, i, j, C, h,
                                         w, dozim, s);
    const size_t o = (size_t)(i - r_begin) * w + j;
    cf[o] = p.a1;
    cf[plane + o] = p.a4;
    cf[2 * plane + o] = p.a2;
    if (!QUAD) {
      for (int k = 0; k < 4; ++k) cf[(3 + k) * plane + o] = p.off[k];
    }
    b[o] = p.bu;
    b[plane + o] = p.bv;
    zu = mul(p.bu, __fdiv_rn(p.bu, p.a1));
    zv = mul(p.bv, __fdiv_rn(p.bv, p.a4));
    bb = add(mul(p.bu, p.bu), mul(p.bv, p.bv));
  }
  const float s_zu = octane::block_sum<kWarps>(zu, tid, scratch[0]);
  const float s_zv = octane::block_sum<kWarps>(zv, tid, scratch[1]);
  const float s_bb = octane::block_sum<kWarps>(bb, tid, scratch[2]);
  if (tid == 0) {
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partials[3 * blk] = s_zu;
    partials[3 * blk + 1] = s_zv;
    partials[3 * blk + 2] = s_bb;
  }
}

}  // namespace

// The SOR coefficient stack cf (6 or 10, h, w) and one ||b||^2 partial per
// 32 x 8 block of pixels (row-major over the blocks).  g1s is the (3C, h, w)
// level stack [geo1, gx1, gy1], smp the warp's (6C, h, w) samples, bcx/bcy
// its clamp flags (one byte per pixel).
extern "C" int octane_assemble_cf(const float* g1s, const float* smp,
                                  const uint8_t* bcx, const uint8_t* bcy,
                                  const float* u, const float* v,
                                  const float* uhat, const float* vhat,
                                  float* cf, float* partials, int c, int h, int w,
                                  int quad, int dozim, float al1, float one_m_al1,
                                  float lambdac, float inv_alpha, float lam_a,
                                  void* stream) {
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  const dim3 block(kBX, kBY);
  const Scalars s{al1, one_m_al1, lambdac, inv_alpha, lam_a};
  const cudaStream_t st = (cudaStream_t)stream;
  if (quad) {
    assemble_cf<true><<<grid, block, 0, st>>>(g1s, smp, bcx, bcy, u, v, uhat, vhat,
                                              cf, partials, c, h, w, dozim, s);
  } else {
    assemble_cf<false><<<grid, block, 0, st>>>(g1s, smp, bcx, bcy, u, v, uhat, vhat,
                                               cf, partials, c, h, w, dozim, s);
  }
  return (int)cudaGetLastError();
}

// The PCG system of rows [r_begin, r_end) of the (h, w) slab that g1s, smp,
// bcx, bcy, u, v, uhat and vhat hold (inputs as octane_assemble_cf's): cf
// (3 or 7, r_end - r_begin, w), b (2, r_end - r_begin, w) and the (n, 3)
// first-sum partials per 32 x 8 block from row r_begin (row-major over the
// blocks).  The slab's edges take the mirror-at-1 neighbours, so a row next
// to a slab edge that is not the image's is only right as a ghost row.
extern "C" int octane_assemble_pcg(const float* g1s, const float* smp,
                                   const uint8_t* bcx, const uint8_t* bcy,
                                   const float* u, const float* v,
                                   const float* uhat, const float* vhat,
                                   float* cf, float* b, float* partials, int c, int h, int w,
                                   int r_begin, int r_end, int quad, int dozim, float al1,
                                   float one_m_al1, float lambdac, float inv_alpha,
                                   float lam_a, void* stream) {
  if (h < 2 || w < 2 || r_begin < 0 || r_end > h || r_begin >= r_end) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((w + kBX - 1) / kBX, (r_end - r_begin + kBY - 1) / kBY);
  const dim3 block(kBX, kBY);
  const Scalars s{al1, one_m_al1, lambdac, inv_alpha, lam_a};
  const cudaStream_t st = (cudaStream_t)stream;
  if (quad) {
    assemble_pcg<true><<<grid, block, 0, st>>>(g1s, smp, bcx, bcy, u, v, uhat, vhat, cf, b,
                                               partials, c, h, w, r_begin, r_end, dozim, s);
  } else {
    assemble_pcg<false><<<grid, block, 0, st>>>(g1s, smp, bcx, bcy, u, v, uhat, vhat, cf, b,
                                                partials, c, h, w, r_begin, r_end, dozim, s);
  }
  return (int)cudaGetLastError();
}
