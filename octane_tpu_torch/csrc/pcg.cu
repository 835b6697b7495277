// The two passes of one Jacobi-preconditioned CG iteration on the coupled
// 5-point system.
//
// Replaces the Pallas TPU kernels of octane_tpu/ops/pallas/cg.py:
//   * _pass_a (:94): x += alpha_prev p (lagged update); p' = M^-1 r + beta p;
//     ap = A p' with the mirror-at-1 edges of _apply_strip (:56); per-block
//     partials of <p', ap>;
//   * _pass_b (:141): r -= alpha ap; per-block partials of <r, M^-1 r> and
//     <r, r>.
// The update order and the two reduction points are those of the TPU
// kernels (single-reduction rewrites were measured unstable, cg.py:17-24).
//
// Layout: x, r, p, ap are (2, h, w) planes (u then v); the coefficients are
// (nc, h, w) planes [a1, a4, a2] (quad: the off-diagonals are the scalar -1)
// or [a1, a4, a2, a5, a6, a7, a8] (robust).  alpha and beta arrive as
// device scalars by pointer, so the host never has to read them.
//
// One thread per pixel; a 32 x 8 block writes one partial per reduction,
// summed in a fixed shuffle order (no atomics).  On the TPU each band
// recomputed p' over a halo frame; here each thread recomputes p' at its
// four neighbours from r, p and the diagonals, and writes p' to a separate
// buffer because neighbouring blocks still read the old p.
//
// Bound: memory.  Pass A reads 2x(x, r, p) + nc coefficient planes and
// writes 3x2 planes (the neighbour reads hit L1/L2); pass B reads 2x(r, ap)
// + 2 diagonals and writes 2 planes.  The per-pixel math is a few dozen
// flops; the kernels are written for correctness first.

#include "common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kWarps = kBX * kBY / 32;

// Pass A's kernel, whole image (BAND false) or band form (BAND true: the
// counterpart of octane_tpu/parallel/cg.py make_sharded_fused_cg :59, which
// ran _pass_a on a row band with 8 ghost rows and a row0).  In band form x,
// r, p and cf are the band's rows [row0, row0 + h) of a true_h-row image,
// and gr, gp, gd (2, 2, w) hold r, p and the diagonals [a1, a4] of global
// rows row0 - 1 (index 0) and row0 + h (index 1), where those exist: p' is
// recomputed at the neighbours from them, so a band's outputs equal the
// whole-image pass's rows bit for bit (its partials cover the band's own
// 32 x 8 blocks).  Only the image's edge rows take the mirror-at-1
// neighbours.
template <bool QUAD, bool BAND>
__global__ void __launch_bounds__(kBX * kBY) pcg_pass_a(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ p, const float* __restrict__ cf,
    const float* __restrict__ ab, const float* __restrict__ gr,
    const float* __restrict__ gp, const float* __restrict__ gd,
    float* __restrict__ x_out, float* __restrict__ p_out, float* __restrict__ ap_out,
    float* __restrict__ partials, int h, int w, int row0, int true_h) {
  __shared__ float scratch[kWarps];
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const size_t plane = (size_t)h * w;
  float part = 0.f;
  if (i < h && j < w) {
    const float alpha = ab[0], beta = ab[1];
    // p' = M^-1 r + beta p of component c at band row ii (-1 and h: the
    // ghost rows), column jj (the TPU's minv * r + beta * p)
    auto p_next = [&](int c, int ii, int jj) {
      float rv, pv, dv;
      if (BAND && (ii < 0 || ii >= h)) {
        const size_t g = ((size_t)c * 2 + (ii < 0 ? 0 : 1)) * w + jj;
        rv = gr[g];
        pv = gp[g];
        dv = gd[g];
      } else {
        const size_t q = c * plane + (size_t)ii * w + jj;   // cf planes 0, 1: a1, a4
        rv = r[q];
        pv = p[q];
        dv = cf[q];
      }
      const float minv = __frcp_rn(dv);
      return __fadd_rn(__fmul_rn(minv, rv), __fmul_rn(beta, pv));
    };
    // mirror-at-1 neighbours: row 0's north is row 1, column w-1's east is
    // column w-2 (core/bc.py mirror_shift)
    const int g = row0 + i;
    const int jw = j == 0 ? 1 : j - 1;
    const int je = j == w - 1 ? w - 2 : j + 1;
    const int in = (g == 0 ? 1 : g - 1) - row0;
    const int is = (g == true_h - 1 ? true_h - 2 : g + 1) - row0;
    const size_t o = (size_t)i * w + j;

    const float cu = p_next(0, i, j), cv = p_next(1, i, j);
    const float wu = p_next(0, i, jw), wv = p_next(1, i, jw);
    const float eu = p_next(0, i, je), ev = p_next(1, i, je);
    const float nu = p_next(0, in, j), nv = p_next(1, in, j);
    const float su = p_next(0, is, j), sv = p_next(1, is, j);
    float off_u, off_v;
    if (QUAD) {
      off_u = -__fadd_rn(__fadd_rn(__fadd_rn(wu, eu), nu), su);
      off_v = -__fadd_rn(__fadd_rn(__fadd_rn(wv, ev), nv), sv);
    } else {
      const float a5 = cf[3 * plane + o], a6 = cf[4 * plane + o];
      const float a7 = cf[5 * plane + o], a8 = cf[6 * plane + o];
      off_u = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a5, wu), __fmul_rn(a7, eu)),
                                  __fmul_rn(a6, nu)), __fmul_rn(a8, su));
      off_v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a5, wv), __fmul_rn(a7, ev)),
                                  __fmul_rn(a6, nv)), __fmul_rn(a8, sv));
    }
    const float c1 = cf[o], c4 = cf[plane + o], c2 = cf[2 * plane + o];
    const float au = __fadd_rn(__fadd_rn(__fmul_rn(c1, cu), __fmul_rn(c2, cv)), off_u);
    const float av = __fadd_rn(__fadd_rn(__fmul_rn(c2, cu), __fmul_rn(c4, cv)), off_v);
    x_out[o] = __fadd_rn(x[o], __fmul_rn(alpha, p[o]));
    x_out[plane + o] = __fadd_rn(x[plane + o], __fmul_rn(alpha, p[plane + o]));
    p_out[o] = cu;
    p_out[plane + o] = cv;
    ap_out[o] = au;
    ap_out[plane + o] = av;
    part = __fadd_rn(__fmul_rn(cu, au), __fmul_rn(cv, av));
  }
  const float s = octane::block_sum<kWarps>(part, tid, scratch);
  if (tid == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kBX * kBY) pcg_pass_b(
    const float* __restrict__ r, const float* __restrict__ ap,
    const float* __restrict__ cf, const float* __restrict__ alpha_p,
    float* __restrict__ r_out, float* __restrict__ partials, int h, int w) {
  __shared__ float scratch[2][kWarps];
  const int j = blockIdx.x * kBX + threadIdx.x;
  const int i = blockIdx.y * kBY + threadIdx.y;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const size_t plane = (size_t)h * w;
  float rz = 0.f, rr = 0.f;
  if (i < h && j < w) {
    const float alpha = alpha_p[0];
    const size_t o = (size_t)i * w + j;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const size_t q = c * plane + o;
      const float rn = __fsub_rn(r[q], __fmul_rn(alpha, ap[q]));
      r_out[q] = rn;
      const float minv = __frcp_rn(cf[q]);        // cf planes 0, 1: a1, a4
      rz = __fadd_rn(rz, __fmul_rn(rn, __fmul_rn(minv, rn)));
      rr = __fadd_rn(rr, __fmul_rn(rn, rn));
    }
  }
  const float s_rz = octane::block_sum<kWarps>(rz, tid, scratch[0]);
  const float s_rr = octane::block_sum<kWarps>(rr, tid, scratch[1]);
  if (tid == 0) {
    const size_t b = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * b] = s_rz;
    partials[2 * b + 1] = s_rr;
  }
}

dim3 pcg_grid(int h, int w) { return dim3((w + kBX - 1) / kBX, (h + kBY - 1) / kBY); }

template <bool BAND>
int launch_a(const float* x, const float* r, const float* p, const float* cf, const float* ab,
             const float* gr, const float* gp, const float* gd, float* x_out, float* p_out,
             float* ap_out, float* partials, int h, int w, int row0, int true_h, int quad,
             cudaStream_t s) {
  const dim3 block(kBX, kBY);
  if (quad) {
    pcg_pass_a<true, BAND><<<pcg_grid(h, w), block, 0, s>>>(
        x, r, p, cf, ab, gr, gp, gd, x_out, p_out, ap_out, partials, h, w, row0, true_h);
  } else {
    pcg_pass_a<false, BAND><<<pcg_grid(h, w), block, 0, s>>>(
        x, r, p, cf, ab, gr, gp, gd, x_out, p_out, ap_out, partials, h, w, row0, true_h);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int octane_pcg_pass_a(const float* x, const float* r, const float* p,
                                 const float* cf, const float* ab, float* x_out,
                                 float* p_out, float* ap_out, float* partials,
                                 int h, int w, int quad, void* stream) {
  return launch_a<false>(x, r, p, cf, ab, nullptr, nullptr, nullptr, x_out, p_out, ap_out,
                         partials, h, w, 0, h, quad, (cudaStream_t)stream);
}

// Pass A on the band [row0, row0 + h) of a true_h-row image with the ghost
// rows gr, gp, gd (see the kernel); a band of one row needs h >= 1 and an
// image of at least 2 rows.
extern "C" int octane_pcg_pass_a_band(const float* x, const float* r, const float* p,
                                      const float* cf, const float* ab, const float* gr,
                                      const float* gp, const float* gd, float* x_out,
                                      float* p_out, float* ap_out, float* partials, int h,
                                      int w, int row0, int true_h, int quad, void* stream) {
  if (h < 1 || true_h < 2 || row0 < 0 || row0 + h > true_h) return (int)cudaErrorInvalidValue;
  return launch_a<true>(x, r, p, cf, ab, gr, gp, gd, x_out, p_out, ap_out, partials, h, w,
                        row0, true_h, quad, (cudaStream_t)stream);
}

extern "C" int octane_pcg_pass_b(const float* r, const float* ap, const float* cf,
                                 const float* alpha, float* r_out, float* partials,
                                 int h, int w, void* stream) {
  pcg_pass_b<<<pcg_grid(h, w), dim3(kBX, kBY), 0, (cudaStream_t)stream>>>(
      r, ap, cf, alpha, r_out, partials, h, w);
  return (int)cudaGetLastError();
}
