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
// The partials are one per 32 x 8 block of pixels, summed in a fixed order
// (no atomics): a block row's 32 lanes by common.cuh's shuffle tree, then
// the block's 8 row sums in row order.  Each product and sum is rounded on
// its own (-fmad=false) in the expressions of the plain versions, so both
// passes equal them bit for bit.
//
// Pass A computes p' once per pixel.  A thread block owns a tile of kTX
// partial blocks side by side and kRY stacked (64 columns by 16 rows, 512
// threads; a thread takes the rows ty and ty + 8 of its column).  Every
// thread issues all of its loads first: its pixels' r, p, x and
// coefficients, and, on the tile's edge, the r, p and diagonals of its
// frame (the row above and below the tile, the column left and right of
// it).  It then computes p' of those pixels into shared memory; after one
// barrier each pixel reads its four neighbours' p' from there.  p' goes to
// a separate buffer because neighbouring tiles still read the old p.  The
// frame is the only work done twice: 160 of 1184 p' a tile (on the TPU
// each band recomputed p' over a halo frame as well).  A tile, not a warp
// walking down a column strip with p' in registers: the walk measured
// 72-77 % of the bound at 5424^2 and twice the time at a sector's small
// shapes, where its rows run one after another and a tile's run at once.
//
// Pass B needs no neighbours: one thread per pixel, one partial block per
// thread block, all loads before the arithmetic.
//
// Bound: memory.  Pass A reads x, r, p (2 planes each) and the nc
// coefficient planes and writes x, p', ap: 19 / 15 planes (robust / quad),
// 0.667 / 0.527 ms at 5424^2 on 3.35 TB/s (its frame's reads come from the
// L2); pass B reads r, ap and the two diagonals and writes r: 8 planes,
// 0.281 ms.  Their arithmetic (a few dozen flops and 2 correctly rounded
// reciprocals a pixel) is well under that.  Measured at 5424^2 on an H100
// 80GB HBM3 at 700 W: pass A 88 % / 86 % of its bound (robust / quad),
// pass B 92 %.

#include "common.cuh"

namespace {

using octane::add;
using octane::mul;
using octane::sub;

constexpr int kBX = 32;      // a partial's block: 32 columns (one warp) ...
constexpr int kBY = 8;       // ... by 8 rows
constexpr int kTX = 2;       // pass A's tile: kTX partial blocks side by side ...
constexpr int kRY = 2;       // ... and kRY stacked
constexpr int kTW = kBX * kTX, kTH = kBY * kRY;      // the tile's columns and rows
constexpr int kThreadsA = kTW * kBY;

// r, p and the diagonal (a1 | a4) of both components at one pixel; the
// defaults are what an idle thread computes with (a diagonal of 1, so its
// reciprocal takes no slow path)
struct Raw {
  float ru = 0.f, rv = 0.f, pu = 0.f, pv = 0.f, du = 1.f, dv = 1.f;
};

// p' = M^-1 r + beta p of both components (the TPU's minv * r + beta * p)
__device__ __forceinline__ float2 p_next(const Raw& a, float beta) {
  return make_float2(add(mul(__frcp_rn(a.du), a.ru), mul(beta, a.pu)),
                     add(mul(__frcp_rn(a.dv), a.rv), mul(beta, a.pv)));
}

// Pass A's kernel, whole image (BAND false) or band form (BAND true: the
// counterpart of octane_tpu/parallel/cg.py make_sharded_fused_cg :59, which
// ran _pass_a on a row band with 8 ghost rows and a row0).  In band form x,
// r, p and cf are the band's rows [row0, row0 + h) of a true_h-row image,
// and gr, gp, gd (2, 2, w) hold r, p and the diagonals [a1, a4] of global
// rows row0 - 1 (index 0) and row0 + h (index 1), where those exist: the
// tile's frame takes p' of those rows from them as of any other, so a
// band's outputs equal the whole-image pass's rows bit for bit (its
// partials cover the band's own 32 x 8 blocks).  Only the image's edge rows
// take the mirror-at-1 neighbours.
template <bool QUAD, bool BAND>
__global__ void __launch_bounds__(kThreadsA) pcg_pass_a(
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ p, const float* __restrict__ cf,
    const float* __restrict__ ab, const float* __restrict__ gr,
    const float* __restrict__ gp, const float* __restrict__ gd,
    float* __restrict__ x_out, float* __restrict__ p_out, float* __restrict__ ap_out,
    float* __restrict__ partials, int h, int w, int row0, int true_h) {
  // p' of the tile and its frame: tile row t, column c at [t + 1][c + 1]
  __shared__ float2 pn[kTH + 2][kTW + 2];
  __shared__ float scratch[kRY][kTX][kBY];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const int j = j0 + tx;
  const size_t plane = (size_t)h * w;
  const float alpha = ab[0], beta = ab[1];
  // band-local row ii has a p' (an image row: the band's, or a ghost row)
  auto exists = [&](int ii) { return row0 + ii >= 0 && row0 + ii < true_h; };
  // the sources of p' at band-local row ii (-1 and h: the ghost rows), column jj
  auto load_raw = [&](int ii, int jj) {
    Raw a;
    if (BAND && (ii < 0 || ii >= h)) {
      const size_t g = (size_t)(ii < 0 ? 0 : 1) * w + jj;
      a.ru = gr[g];
      a.rv = gr[2 * (size_t)w + g];
      a.pu = gp[g];
      a.pv = gp[2 * (size_t)w + g];
      a.du = gd[g];
      a.dv = gd[2 * (size_t)w + g];
    } else {
      const size_t q = (size_t)ii * w + jj;     // cf planes 0, 1: a1, a4
      a.ru = r[q];
      a.rv = r[plane + q];
      a.pu = p[q];
      a.pv = p[plane + q];
      a.du = cf[q];
      a.dv = cf[plane + q];
    }
    return a;
  };

  // every load of the thread first: its rows' sources, x and coefficients,
  // then the frame pixels it computes
  Raw own[kRY];
  float xs[kRY][2], c2[kRY], off[kRY][QUAD ? 1 : 4];
#pragma unroll
  for (int k = 0; k < kRY; ++k) {
    const int i = i0 + ty + kBY * k;
    xs[k][0] = xs[k][1] = c2[k] = 0.f;
#pragma unroll
    for (int q = 0; q < (QUAD ? 1 : 4); ++q) off[k][q] = 0.f;
    if (i < h && j < w) {
      own[k] = load_raw(i, j);
      const size_t o = (size_t)i * w + j;
      xs[k][0] = x[o];
      xs[k][1] = x[plane + o];
      c2[k] = cf[2 * plane + o];
      if (!QUAD) {
#pragma unroll
        for (int q = 0; q < 4; ++q) off[k][q] = cf[(3 + q) * plane + o];   // a5, a6, a7, a8
      }
    }
  }
  // the frame: ty 0 takes the row above the tile, ty 1 the row below its
  // last image row, column tx; tx 0 and kTW - 1 the columns beside the tile
  // at their rows
  const int last = min(i0 + kTH, h) - 1;
  const int frame_row = ty == 0 ? i0 - 1 : last + 1;
  const bool row_frame = ty < 2 && j < w && exists(frame_row);
  Raw fr;
  if (row_frame) fr = load_raw(frame_row, j);
  const int side_j = tx == 0 ? j0 - 1 : j0 + kTW;
  const bool side = (tx == 0 && j0 > 0) || (tx == kTW - 1 && side_j < w);
  Raw sides[kRY];
  if (side) {
#pragma unroll
    for (int k = 0; k < kRY; ++k) {
      const int i = i0 + ty + kBY * k;
      if (i < h) sides[k] = load_raw(i, side_j);
    }
  }

  // (a tile row past the band's last may hold the ghost row below it)
#pragma unroll
  for (int k = 0; k < kRY; ++k) {
    if (i0 + ty + kBY * k < h) pn[ty + kBY * k + 1][tx + 1] = p_next(own[k], beta);
  }
  if (row_frame) pn[frame_row - i0 + 1][tx + 1] = p_next(fr, beta);
  if (side) {
#pragma unroll
    for (int k = 0; k < kRY; ++k) {
      pn[ty + kBY * k + 1][tx == 0 ? 0 : kTW + 1] = p_next(sides[k], beta);
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kRY; ++k) {
    const int t = ty + kBY * k;            // tile row
    const int i = i0 + t;
    float part = 0.f;
    if (i < h && j < w) {
      // mirror-at-1 neighbours: row 0's north is row 1, column w-1's east
      // is column w-2 (core/bc.py mirror_shift)
      const int g = row0 + i;
      const float2 c = pn[t + 1][tx + 1];
      const float2 n = pn[g == 0 ? t + 2 : t][tx + 1];
      const float2 s = pn[g == true_h - 1 ? t : t + 2][tx + 1];
      const float2 wp = pn[t + 1][j == 0 ? tx + 2 : tx];
      const float2 ep = j == w - 1 ? wp : pn[t + 1][tx + 2];
      float off_u, off_v;
      if (QUAD) {
        off_u = -add(add(add(wp.x, ep.x), n.x), s.x);
        off_v = -add(add(add(wp.y, ep.y), n.y), s.y);
      } else {
        const float a5 = off[k][0], a6 = off[k][1], a7 = off[k][2], a8 = off[k][3];
        off_u = add(add(add(mul(a5, wp.x), mul(a7, ep.x)), mul(a6, n.x)), mul(a8, s.x));
        off_v = add(add(add(mul(a5, wp.y), mul(a7, ep.y)), mul(a6, n.y)), mul(a8, s.y));
      }
      const float c1 = own[k].du, c4 = own[k].dv;
      const float au = add(add(mul(c1, c.x), mul(c2[k], c.y)), off_u);
      const float av = add(add(mul(c2[k], c.x), mul(c4, c.y)), off_v);
      const size_t o = (size_t)i * w + j;
      x_out[o] = add(xs[k][0], mul(alpha, own[k].pu));
      x_out[plane + o] = add(xs[k][1], mul(alpha, own[k].pv));
      p_out[o] = c.x;
      p_out[plane + o] = c.y;
      ap_out[o] = au;
      ap_out[plane + o] = av;
      part = add(mul(c.x, au), mul(c.y, av));
    }
    // a pixel past the image adds 0, and a row past it the 0 of its warp
    part = octane::warp_sum(part);
    if ((tx & 31) == 0) scratch[k][tx >> 5][ty] = part;
  }
  __syncthreads();
  // one thread a partial block: its 8 row sums in row order (block_sum's)
  const int tid = ty * kTW + tx;
  if (tid < kRY * kTX) {
    const int k = tid / kTX, bx = tid % kTX;
    const int brow = i0 / kBY + k, bcol = j0 / kBX + bx;
    const int nbx = (w + kBX - 1) / kBX;
    if (brow * kBY < h && bcol < nbx) {
      float s = scratch[k][bx][0];
      for (int q = 1; q < kBY; ++q) s = add(s, scratch[k][bx][q]);
      partials[(size_t)brow * nbx + bcol] = s;
    }
  }
}

// Pass B's kernel: one thread per pixel, a thread block per partial block;
// all loads come before the arithmetic.
__global__ void __launch_bounds__(kBX * kBY) pcg_pass_b(
    const float* __restrict__ r, const float* __restrict__ ap,
    const float* __restrict__ cf, const float* __restrict__ alpha_p,
    float* __restrict__ r_out, float* __restrict__ partials, int h, int w) {
  __shared__ float scratch[2][kBY];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * kBY + ty, j = blockIdx.x * kBX + tx;
  const size_t plane = (size_t)h * w, o = (size_t)i * w + j;
  const bool in = i < h && j < w;
  float rs[2] = {0.f, 0.f}, as[2] = {0.f, 0.f}, ds[2] = {1.f, 1.f};
  if (in) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      rs[c] = r[c * plane + o];
      as[c] = ap[c * plane + o];
      ds[c] = cf[c * plane + o];        // cf planes 0, 1: a1, a4
    }
  }
  const float alpha = alpha_p[0];
  float rz = 0.f, rr = 0.f;
  if (in) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float rn = sub(rs[c], mul(alpha, as[c]));
      r_out[c * plane + o] = rn;
      const float minv = __frcp_rn(ds[c]);
      rz = add(rz, mul(rn, mul(minv, rn)));
      rr = add(rr, mul(rn, rn));
    }
  }
  // a pixel past the image adds 0; the block's 8 row sums in row order
  rz = octane::warp_sum(rz);
  rr = octane::warp_sum(rr);
  if (tx == 0) {
    scratch[0][ty] = rz;
    scratch[1][ty] = rr;
  }
  __syncthreads();
  if (tx == 0 && ty == 0) {
    float s_rz = scratch[0][0], s_rr = scratch[1][0];
    for (int q = 1; q < kBY; ++q) {
      s_rz = add(s_rz, scratch[0][q]);
      s_rr = add(s_rr, scratch[1][q]);
    }
    const size_t b = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * b] = s_rz;
    partials[2 * b + 1] = s_rr;
  }
}

template <bool BAND>
int launch_a(const float* x, const float* r, const float* p, const float* cf, const float* ab,
             const float* gr, const float* gp, const float* gd, float* x_out, float* p_out,
             float* ap_out, float* partials, int h, int w, int row0, int true_h, int quad,
             cudaStream_t s) {
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH), block(kTW, kBY);
  if (quad) {
    pcg_pass_a<true, BAND><<<grid, block, 0, s>>>(
        x, r, p, cf, ab, gr, gp, gd, x_out, p_out, ap_out, partials, h, w, row0, true_h);
  } else {
    pcg_pass_a<false, BAND><<<grid, block, 0, s>>>(
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
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  pcg_pass_b<<<grid, dim3(kBX, kBY), 0, (cudaStream_t)stream>>>(r, ap, cf, alpha, r_out,
                                                                 partials, h, w);
  return (int)cudaGetLastError();
}
