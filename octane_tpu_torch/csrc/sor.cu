// Red-black SOR: one launch per pass of k red+black sweeps, temporally
// blocked in shared memory.
//
// Replaces the Pallas TPU kernel _kernel of octane_tpu/ops/pallas/sor.py
// (:257, called at :421): S = k sweeps per streaming pass over the grid,
// exact by the overlap argument of sor.py:18-26, plus the full-grid
// residual ||b - A x||^2 of the pass's incoming iterate for the stopping
// rule.  The update is that kernel's (and the reference loop flow/cg.py
// sor_solve's): the residual r = b - A x under the mirror-at-1 edges, the
// exact 2 x 2 block solve (a1 a2; a2 a4) with the hoisted reciprocal
// determinant, and x += omega * block solve on one colour ((row + column)
// even is red).  Each product and sum is rounded on its own in the order of
// ops/sor.py sor_sweep_plain, so the kernel equals the plain pass
// (sor_pass_plain: 2k plain half-sweeps) bit for bit.
//
// Layout: x is (2, h, w) (u then v); cf is the coefficient stack of
// ops/sor.py build_cf, [a1, a4, a2, bu, bv, rdet] (quad: off-diagonals the
// scalar -1) or [a1, a4, a2, bu, bv, a5, a6, a7, a8, rdet].
//
// Bound: memory.  A pass must read x and the nc coefficient planes once
// and write x once: 14 planes (robust, nc = 10) or 10 (quad), 0.49 / 0.35
// ms at 5424^2 on 3.35 TB/s; its ~8 G single-rounded flops are under that.
// A kernel per half-sweep reads all of them 2k times.
//
// Design: streaming temporal blocking.  A block owns a strip of `strip`
// interior columns (a multiple of 32) and a segment of `seg` interior rows
// (a multiple of 8), and loads 2k halo columns and rows on each side,
// clipped to the grid; at a real edge the mirror-at-1 neighbours apply.  A
// cell next to a cut (a halo edge that is not a grid edge) is never
// updated, so the stale region grows one cell per half-sweep and the
// interior, 2k cells in, is exact.  The block walks down its rows with a
// ring of R = 4k + 4 rows of x and the coefficients in dynamic shared
// memory (up to 227 KB: one block of 512 threads per SM); at step s it
//   * reads local row s + 2 into registers (16-byte loads where the rows
//     allow), two steps ahead of its use: row s + 1, read a step earlier,
//     goes into the ring at the end of the step;
//   * takes the residual of local row s - 1 on the incoming iterate (rows
//     s - 2 .. s are untouched yet): per interior row, a 32-column warp sum
//     (the shuffle tree of common.cuh, deferred one step) added to the row
//     block's running sum in row order, so each 32 x 8 partial is
//     block_sum's, bit for bit.  The first warps take it; the staging of
//     rows and the write-out go to the last ones, since the step waits for
//     its slowest warp;
//   * runs half-sweep t = 1 .. 2k on local row s - 2t - 1.  Half-sweep t at
//     row j needs half-sweep t - 1 at rows j - 1 .. j + 1, which ran in the
//     steps before; within a step the updated rows are all of one parity
//     and read only rows of the other, so one barrier per step is enough
//     and all 2k half-sweeps of a step run in parallel.  A thread takes the
//     half-sweeps 2p + 1 and 2p + 2 at one column: the column is red on one
//     of their two rows and black on the other, so every lane works and a
//     warp reads consecutive words;
//   * writes out local row s - 4k - 2, final since step s - 1.
// Read amplification is (strip + 4k) / strip on columns and (seg + 4k) /
// seg on rows (1.39 at k = 8, strip 96, seg 608).  What limits it on the
// H100: one block per SM (the ring fills shared memory) and the fixed cost
// of each barrier-separated row step, most of a step's time even without
// its cell updates; so default_geometry sizes the segments to the fewest
// steps on the busiest SM (see PERF.md).  Left behind from the TPU kernel: the colour packing
// (_deinterleave/_interleave), the 256-lane alignment, the band-height VMEM
// model and the identity padding rows.

#include <algorithm>

#include "common.cuh"

namespace {

using octane::add;
using octane::mul;
using octane::sub;

constexpr int kThreads = 512;
constexpr int kMaxItems = 4;      // cells per thread and step: k (strip + 4k) <= 2048
constexpr int kMaxStage = 4;      // floats per thread of a prefetched row: (2 + nc) (strip + 4k) <= 2048

struct Cell {
  float xu, xv, ru, rv;
};

// The values one cell update reads: x at the cell and its four
// neighbours, and the nc coefficients [a1, a4, a2, bu, bv, (a5 .. a8,)
// rdet] of the cell.
template <bool QUAD>
struct Taps {
  float xu, xv, wu, eu, nu, su, wv, ev, nv, sv;
  float c[QUAD ? 6 : 10];
};

// The taps at column q of a ring row; rn / rs are the north and south rows,
// qw / qe the west and east columns (mirror-at-1 applied).  Plane p of a
// ring row starts WS floats after plane p - 1: x_u, x_v, then the nc
// coefficient planes.  WS is a compile-time constant, so every load of a
// cell is one address and an immediate offset.
template <bool QUAD, int WS>
__device__ __forceinline__ Taps<QUAD> gather(const float* row, const float* rn,
                                             const float* rs, int q, int qw, int qe) {
  constexpr int ws = WS;
  const float* xu = row;
  const float* xv = row + ws;
  Taps<QUAD> t;
  t.xu = xu[q];
  t.xv = xv[q];
  t.wu = xu[qw];
  t.eu = xu[qe];
  t.nu = rn[q];
  t.su = rs[q];
  t.wv = xv[qw];
  t.ev = xv[qe];
  t.nv = rn[ws + q];
  t.sv = rs[ws + q];
#pragma unroll
  for (int p = 0; p < (QUAD ? 6 : 10); ++p) t.c[p] = row[(2 + p) * ws + q];
  return t;
}

// x and the pre-update residual b - A x of a cell
template <bool QUAD>
__device__ __forceinline__ Cell residual(const Taps<QUAD>& t) {
  float off_u, off_v;
  if (QUAD) {
    off_u = add(add(add(-t.wu, -t.eu), -t.nu), -t.su);
    off_v = add(add(add(-t.wv, -t.ev), -t.nv), -t.sv);
  } else {
    const float a5 = t.c[5], a6 = t.c[6], a7 = t.c[7], a8 = t.c[8];
    off_u = add(add(add(mul(a5, t.wu), mul(a7, t.eu)), mul(a6, t.nu)), mul(a8, t.su));
    off_v = add(add(add(mul(a5, t.wv), mul(a7, t.ev)), mul(a6, t.nv)), mul(a8, t.sv));
  }
  const float a1 = t.c[0], a4 = t.c[1], a2 = t.c[2];
  const float au = add(add(mul(a1, t.xu), mul(a2, t.xv)), off_u);
  const float av = add(add(mul(a2, t.xu), mul(a4, t.xv)), off_v);
  return Cell{t.xu, t.xv, sub(t.c[3], au), sub(t.c[4], av)};
}

__device__ __forceinline__ float& component(float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// ring slot arithmetic, 0 <= d < n
__device__ __forceinline__ int add_slot(int a, int d, int n) { return a + d >= n ? a + d - n : a + d; }
__device__ __forceinline__ int sub_slot(int a, int d, int n) { return a < d ? a - d + n : a - d; }

template <bool QUAD, int WS>
__global__ void __launch_bounds__(kThreads, 1) sor_pass(
    const float* __restrict__ x, float* __restrict__ x_out,
    const float* __restrict__ cf, float* __restrict__ partials,
    int h, int w, int row0, int true_h, int r_begin, int r_end, size_t out_plane,
    int k, int strip, int seg, float omega) {
  extern __shared__ float smem[];
  constexpr int kNc = QUAD ? 6 : 10;
  constexpr int kNp = 2 + kNc;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)h * w;

  // interior [c0, c1) x [r0, r1) of the rows [r_begin, r_end) to write,
  // loaded [lc, rc) x [lr, rr); the slab's first and last rows are cuts
  // unless they are the image's (global rows 0 and true_h - 1), and only
  // the image's edge rows take the mirror-at-1 neighbours (top, bot)
  const int c0 = blockIdx.x * strip, c1 = min(c0 + strip, w);
  const int r0 = r_begin + blockIdx.y * seg, r1 = min(r0 + seg, r_end);
  const int halo = 2 * k;
  const int lc = max(0, c0 - halo), rc = min(w, c1 + halo);
  const int lr = max(0, r0 - halo), rr = min(h, r1 + halo);
  const int wl = rc - lc, nl = rr - lr;
  const int top = row0 == 0 ? 0 : -1, bot = row0 + h == true_h ? h - 1 : -1;
  const bool cut_w = lc > 0, cut_e = rc < w;
  const bool cut_n = lr > 0 || top < 0, cut_s = rr < h || bot < 0;
  constexpr int ws = WS;                    // floats per plane of a ring row, >= wl
  const int nring = 2 * halo + 4;           // ring rows: local row l in slot l % nring
  auto ring_row = [&](int slot) { return smem + slot * (kNp * ws); };

  // The next row is read into registers while a step computes and stored
  // into the ring at the end of the step.  Element m of this thread is
  // plane p, loaded column q of the row: 16 bytes (register m) where every
  // row of the window starts on 16 bytes, else 4 bytes (component m % 4 of
  // register m / 4).
  const bool vec = (w & 3) == 0 && (lc & 3) == 0 && (wl & 3) == 0;
  const int vw = vec ? 4 : 1;
  const int row_elems = kNp * (wl / vw);
  const int n_stage = vec ? kMaxStage / 4 : kMaxStage;
  // from the last thread down, so that the residual's warps stage nothing
  const int stid = kThreads - 1 - tid;
  const float* st_src[kMaxStage];
  int st_dst[kMaxStage];
#pragma unroll
  for (int m = 0; m < kMaxStage; ++m) {
    const int e = stid + m * kThreads;
    const int p = e / (wl / vw), q = (e - p * (wl / vw)) * vw;
    st_src[m] = (p < 2 ? x + p * plane : cf + (p - 2) * plane) + lc + q;
    st_dst[m] = p * ws + q;
  }
  using Stage = float4[kMaxStage / 4];
  auto fetch_row = [&](int l, Stage& buf) {
    if (l >= nl) return;
    const size_t row = (size_t)(lr + l) * w;
#pragma unroll
    for (int m = 0; m < kMaxStage; ++m) {
      if (m >= n_stage || stid + m * kThreads >= row_elems) break;
      if (vec) {
        buf[m] = __ldg(reinterpret_cast<const float4*>(st_src[m] + row));
      } else {
        component(buf[m / 4], m % 4) = __ldg(st_src[m] + row);
      }
    }
  };
  auto store_row = [&](int l, int slot, Stage& buf) {
    if (l >= nl) return;
    float* dst = ring_row(slot);
#pragma unroll
    for (int m = 0; m < kMaxStage; ++m) {
      if (m >= n_stage || stid + m * kThreads >= row_elems) break;
      if (vec) {
        *reinterpret_cast<float4*>(dst + st_dst[m]) = buf[m];
      } else {
        dst[st_dst[m]] = component(buf[m / 4], m % 4);
      }
    }
  };

  // This thread's cells: item m is the pair of half-sweeps 2tp + 1 (red)
  // and 2tp + 2 (black) at loaded column q, the same for every step.  At
  // step s they run on local rows l1 = s - 4tp - 3 and l1 - 2, of one
  // parity, so column q is red on one of them and black on the other: the
  // thread updates that cell, and the lanes of a warp read consecutive
  // columns of two rows an even number of floats apart (no bank conflicts).
  const int n_items = k * wl;
  int it_l1[kMaxItems], it_q[kMaxItems], it_qw[kMaxItems], it_qe[kMaxItems];
  int it_slot[kMaxItems];
#pragma unroll
  for (int m = 0; m < kMaxItems; ++m) {
    const int item = tid + m * kThreads;
    const int tp = item / wl;
    const int q = item - tp * wl, j = lc + q;
    it_l1[m] = -4 * tp - 3;                 // row l1 at step 0
    it_slot[m] = (it_l1[m] % nring + nring) % nring;
    // a cell next to a cut column, or past the last item, is never updated
    const bool live = item < n_items && !(cut_w && j == lc) && !(cut_e && j == rc - 1);
    it_q[m] = live ? q : -1;
    it_qw[m] = (j == 0 ? 1 : j - 1) - lc;
    it_qe[m] = (j == w - 1 ? w - 2 : j + 1) - lc;
  }

  const int gw = (w + 31) / 32;
  const int lane = tid & 31, warp = tid >> 5;
  const bool resid_warp = warp < strip / 32;
  float racc = 0.f;                         // lane 0: the row block's sum so far
  float pend = 0.f;                         // the last step's residual term
  int pend_i = -1;                          // and its row (-1: none)

  // Rows are read two steps ahead: at step s row s + 2 goes into one
  // register buffer while row s + 1, read at step s - 1, waits in the
  // other to be stored at the end of the step, so each load has two steps
  // to arrive.  The loop is unrolled by two to keep the buffers in
  // registers.
  Stage ahead0, ahead1;
  fetch_row(0, ahead0);
  store_row(0, 0, ahead0);
  fetch_row(1, ahead0);
  const int nsteps = nl + 2 * halo + 2;
  int s_slot = 0;                           // s % nring
  auto step = [&](int s, Stage& cur, Stage& nxt) {
    __syncthreads();
    fetch_row(s + 2, nxt);

    // the sum of the last step's residual row (deferred a step so that its
    // shuffle chain overlaps the next row's terms)
    if (resid_warp && pend_i >= 0) {
      const float rsum = octane::warp_sum(pend);
      const int i = pend_i - r_begin;       // the row blocks start at r_begin
      if (lane == 0) {
        racc = (i & 7) == 0 ? rsum : add(racc, rsum);
        if (((i & 7) == 7 || pend_i == r_end - 1) && c0 + 32 * warp < w) {
          partials[(size_t)(i >> 3) * gw + (c0 >> 5) + warp] = racc;
        }
      }
      pend_i = -1;
    }

    // the residual terms of the incoming iterate at local row s - 1
    const int lres = s - 1;
    if (resid_warp && lres >= 0 && lres < nl && lr + lres >= r0 && lr + lres < r1) {
      const int i = lr + lres;
      const int col = c0 + tid;
      float part = 0.f;
      if (col < w) {
        const int sp = sub_slot(s_slot, 2, nring);
        const float* row = ring_row(sub_slot(s_slot, 1, nring));
        const float* rn = ring_row(i == top ? s_slot : sp);
        const float* rs = ring_row(i == bot ? sp : s_slot);
        const int cw = col == 0 ? 1 : col - 1, ce = col == w - 1 ? w - 2 : col + 1;
        const Cell c = residual<QUAD>(gather<QUAD, WS>(row, rn, rs, col - lc, cw - lc, ce - lc));
        part = add(mul(c.ru, c.ru), mul(c.rv, c.rv));
      }
      pend = part;
      pend_i = i;
    }

    // half-sweeps 2tp + 1 and 2tp + 2 on local rows s - 4tp - 3, - 5
#pragma unroll
    for (int m = 0; m < kMaxItems; ++m) {
      const int sl1 = it_slot[m];
      it_slot[m] = add_slot(sl1, 1, nring);
      const int q = it_q[m];
      const int l1 = it_l1[m] + s;
      const bool red = ((row0 + lr + l1 + lc + q) & 1) == 0;
      const int l = red ? l1 : l1 - 2;
      if (q < 0 || l < 0 || l >= nl || (cut_n && l == 0) || (cut_s && l == nl - 1)) continue;
      const int i = lr + l;
      const int sl = red ? sl1 : sub_slot(sl1, 2, nring);
      const int sn = sub_slot(sl, 1, nring), ss = add_slot(sl, 1, nring);
      float* row = ring_row(sl);
      const Taps<QUAD> t = gather<QUAD, WS>(row, ring_row(i == top ? ss : sn),
                                            ring_row(i == bot ? sn : ss), q, it_qw[m],
                                            it_qe[m]);
      const Cell c = residual<QUAD>(t);
      const float a1 = t.c[0], a4 = t.c[1], a2 = t.c[2], rdet = t.c[kNc - 1];
      const float ndu = mul(sub(mul(a4, c.ru), mul(a2, c.rv)), rdet);
      const float ndv = mul(sub(mul(a1, c.rv), mul(a2, c.ru)), rdet);
      row[q] = add(c.xu, mul(omega, ndu));
      row[ws + q] = add(c.xv, mul(omega, ndv));
    }

    // local row s - 4k - 2 (slot (s + 2) % nring) is final: write its
    // interior columns
    const int lw = s - 2 * halo - 2;
    if (lw >= 0 && lw < nl && lr + lw >= r0 && lr + lw < r1) {
      const size_t orow = (size_t)(lr + lw - r_begin) * w;
      const float* src = ring_row(add_slot(s_slot, 2, nring)) - lc;
      // by the last warps: the first ones take the residual
      for (int j = c0 + kThreads - 1 - tid; j < c1; j += kThreads) {
        x_out[orow + j] = src[j];
        x_out[out_plane + orow + j] = src[ws + j];
      }
    }
    s_slot = add_slot(s_slot, 1, nring);
    store_row(s + 1, s_slot, cur);
  };
  for (int s = 0; s < nsteps; s += 2) {
    step(s, ahead0, ahead1);
    if (s + 1 < nsteps) step(s + 1, ahead1, ahead0);
  }
}

// floats per plane of a ring row: one of two compile-time widths
int ring_ws(int sweeps, int strip) { return strip + 4 * sweeps <= 128 ? 128 : 160; }

size_t ring_bytes(int quad, int sweeps, int strip) {
  return (size_t)(4 * sweeps + 4) * (2 + (quad ? 6 : 10)) * ring_ws(sweeps, strip)
         * sizeof(float);
}

bool strip_fits(int quad, int sweeps, int strip, int optin) {
  const int np = 2 + (quad ? 6 : 10), wl = strip + 4 * sweeps;
  return strip >= 32 && strip % 32 == 0 && wl <= 160 && sweeps * wl <= kMaxItems * kThreads
         && np * wl <= kMaxStage * kThreads && ring_bytes(quad, sweeps, strip) <= (size_t)optin;
}

// The default block geometry: the widest strip whose ring fits, and the
// segment height with the fewest row steps on the busiest SM.  One block
// runs per SM (512 threads of ~120 registers fill the register file), and
// a block of seg interior rows takes about seg + 8k + 2 steps of nearly
// fixed cost, so the launch takes waves x steps of them; each count n of
// row segments is tried with its least height, ceil(h / n) rounded up to 8.
void default_geometry(int h, int w, int quad, int sweeps, int optin, int sms, int* strip,
                      int* seg) {
  constexpr int kStrips[] = {128, 96, 64, 32};
  *strip = 0;
  for (int s : kStrips) {
    if (strip_fits(quad, sweeps, s, optin)) {
      *strip = s;
      break;
    }
  }
  if (*strip == 0) return;
  const long strips = (w + *strip - 1) / *strip;
  long best = -1;
  for (int n = 1; n <= (h + 7) / 8; ++n) {
    const int sg = ((h + n - 1) / n + 7) / 8 * 8;
    if ((h + sg - 1) / sg != n) continue;     // the height of a smaller n
    const long waves = (strips * n + sms - 1) / sms;
    const long cost = waves * (std::min(h, sg + 4 * sweeps) + 4 * sweeps + 2);
    if (best < 0 || cost < best) {
      best = cost;
      *seg = sg;
    }
  }
}

struct Band {
  int row0, true_h, r_begin, r_end;
  size_t out_plane;
};

template <bool QUAD, int WS>
void launch(dim3 grid, size_t bytes, cudaStream_t s, int optin, const float* x, float* x_out,
            const float* cf, float* partials, int h, int w, Band b, int sweeps, int strip,
            int seg, float omega) {
  cudaFuncSetAttribute(sor_pass<QUAD, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  sor_pass<QUAD, WS><<<grid, kThreads, bytes, s>>>(x, x_out, cf, partials, h, w, b.row0,
                                                   b.true_h, b.r_begin, b.r_end, b.out_plane,
                                                   sweeps, strip, seg, omega);
}

}  // namespace

// Band form (the counterpart of octane_tpu/parallel/sor.py
// make_sharded_fused_sor :44, which ran _kernel on a row band with 2S ghost
// rows and sc = [row0, col0, ns]): x (2, h, w) and cf (nc, h, w) are a slab
// of global rows [row0, row0 + h) of a true_h-row image, holding the band's
// rows [r_begin, r_end) and its ghost rows; x_out receives the band's rows
// only (row r_begin first, out_plane floats from u to v), and the partials
// cover the band's rows in 32 x 8 blocks from row r_begin.  The colour
// parity is global (row0 + row + column), a slab edge that is not the
// image's is a cut, and the overlap argument needs 2 sweeps ghost rows on
// each cut side: the band's rows then equal the whole-image pass's bit for
// bit.
extern "C" int octane_sor_pass_band(const float* x, float* x_out, const float* cf,
                                    float* partials, int h, int w, int row0, int true_h,
                                    int r_begin, int r_end, long long out_plane, int quad,
                                    int sweeps, int strip, int seg, float omega, void* stream) {
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sweeps < 1 || sweeps > 8 || h < 2 || w < 2 || r_begin < 0 || r_end > h ||
      r_begin >= r_end || row0 < 0 || row0 + h > true_h) {
    return (int)cudaErrorInvalidValue;
  }
  const int hb = r_end - r_begin;
  if (strip == 0 && seg == 0) default_geometry(hb, w, quad, sweeps, optin, sms, &strip, &seg);
  if (!strip_fits(quad, sweeps, strip, optin) || seg < 8 || seg % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = ring_bytes(quad, sweeps, strip);
  const dim3 grid((w + strip - 1) / strip, (hb + seg - 1) / seg);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool narrow = ring_ws(sweeps, strip) == 128;
  const Band b{row0, true_h, r_begin, r_end, (size_t)out_plane};
  if (quad) {
    (narrow ? launch<true, 128> : launch<true, 160>)(grid, bytes, s, optin, x, x_out, cf,
                                                     partials, h, w, b, sweeps, strip, seg,
                                                     omega);
  } else {
    (narrow ? launch<false, 128> : launch<false, 160>)(grid, bytes, s, optin, x, x_out, cf,
                                                       partials, h, w, b, sweeps, strip, seg,
                                                       omega);
  }
  return (int)cudaGetLastError();
}

// One pass of `sweeps` red+black sweeps (1 .. 8) of x into x_out (another
// buffer), and one ||r||^2 partial of the incoming x per 32 x 8 block of
// pixels (row-major over the blocks) into partials.  The blocks are
// `strip` columns (a multiple of 32, strip + 4 sweeps <= 160, its ring
// within the card's shared memory) by `seg` rows (a multiple of 8); 0 for
// both takes default_geometry's, which the solver uses (other values serve
// tuning and tests).  The whole image is the band form's slab and band.
extern "C" int octane_sor_pass(const float* x, float* x_out, const float* cf,
                               float* partials, int h, int w, int quad, int sweeps,
                               int strip, int seg, float omega, void* stream) {
  return octane_sor_pass_band(x, x_out, cf, partials, h, w, 0, h, 0, h, (long long)h * w, quad,
                              sweeps, strip, seg, omega, stream);
}
