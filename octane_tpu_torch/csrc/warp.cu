// Bilinear warp of the solver's sample stack, with its per-tile window
// statistics.
//
// Replaces the two Pallas TPU kernels of octane_tpu/ops/pallas/warp.py:
//   * _kernel (:80), the bilinear gather of the (K, H, W) stack
//     [geo2, gx2, gy2, gxx, gxy, gyy] at (column + u, row + v) with the
//     reference's conditional clamp and the bc_x / bc_y clamp flags;
//   * _stats_kernel (:284), the per-block window statistics.  On the TPU a
//     prefetched scalar pass placed each block's DMA window; here each block
//     computes the same integers for its own tile with a block reduction.
//
// One block owns a bh x 128 output tile (bh = 64, or 32 below 64 rows, as
// _pick_bh in warp.py).  Step 1 computes the clamp flags and the tile's
// statistics.  Step 2 samples: when the tile's source window (the rows and
// columns its bilinear taps touch) fits the shared-memory budget, the
// window is staged one plane at a time and sampled from shared memory;
// otherwise each pixel reads its four taps of each plane from global
// memory.  Either way the displacement is unbounded: there is no window
// slack to overflow.
//
// Bound: memory.  Per pixel the kernel moves 6 planes x 4 B out, the flow
// in, and (staged) about 6 x 4 B of window in; it does a few dozen flops.
// The staging turns the four scattered tap reads of smooth flow into one
// coalesced read of the window.
//
// Arithmetic follows warp_bilinear_dense (flow/stencil.py of octane_tpu,
// :91-98 and :124) in the same order with round-to-nearest intrinsics and
// no contraction, so results are bit-identical to the plain PyTorch
// version on the card.

#include "common.cuh"

namespace {

constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kTileW;
// staging budget: 47.5 KB, which with the reduction scratch stays under the
// 48 KB of static shared memory a block may declare
constexpr int kSmemFloats = 12160;
constexpr int kBig = 1 << 30;

struct Coefs {
  int iv1, jv1;
  float p1, p2, p3, p4;
  bool bx, by;
};

__device__ __forceinline__ Coefs sample_coefs(int row, int col, float uu, float vv,
                                              int h, int w) {
  Coefs c;
  const float px = __fadd_rn((float)col, uu);
  const float py = __fadd_rn((float)row, vv);
  const float fw = (float)w, fh = (float)h;
  c.bx = (px < 0.f) || (px >= fw);
  c.by = (py < 0.f) || (py >= fh);
  // oct_bc: clamp to n-1 only when >= n; values in (n-1, n) pass through
  const float iv = px < 0.f ? 0.f : (px >= fw ? (float)(w - 1) : px);
  const float jv = py < 0.f ? 0.f : (py >= fh ? (float)(h - 1) : py);
  c.iv1 = min((int)iv, w - 2);            // truncation, iv >= 0
  c.jv1 = min((int)jv, h - 2);
  c.p1 = __fsub_rn((float)(c.iv1 + 1), iv);
  c.p2 = __fsub_rn(iv, (float)c.iv1);
  c.p3 = __fsub_rn((float)(c.jv1 + 1), jv);
  c.p4 = __fsub_rn(jv, (float)c.jv1);
  return c;
}

__device__ __forceinline__ float bilerp(const Coefs& c, float f11, float f21,
                                        float f12, float f22) {
  return __fadd_rn(
      __fmul_rn(c.p3, __fadd_rn(__fmul_rn(c.p1, f11), __fmul_rn(c.p2, f21))),
      __fmul_rn(c.p4, __fadd_rn(__fmul_rn(c.p1, f12), __fmul_rn(c.p2, f22))));
}

__global__ void __launch_bounds__(kThreads) warp_bilinear(
    const float* __restrict__ fields, const float* __restrict__ u,
    const float* __restrict__ v, float* __restrict__ out,
    uint8_t* __restrict__ bcx, uint8_t* __restrict__ bcy,
    int32_t* __restrict__ stats, uint8_t* __restrict__ staged,
    int k, int h, int w, int bh) {
  __shared__ float win[kSmemFloats];
  __shared__ int wred[7][kThreads / 32];
  __shared__ int bred[7];

  const int tid = threadIdx.x;
  const int cb = blockIdx.x, rb = blockIdx.y;
  const int gw = gridDim.x, gh = gridDim.y;
  const int col = cb * kTileW + (tid % kTileW);
  const int lj0 = tid / kTileW;
  const size_t plane = (size_t)h * w;
  const bool col_ok = col < w;

  // ---- step 1: flags and tile statistics --------------------------------
  // Row statistic as _block_stats: jv1 + bh - lj over pixels whose sample
  // row is not clamped; column statistic: iv1 over all pixels (the TPU
  // layout's CPAD offset is not added); eflag: any row-clamped pixel.
  // jmin/jmax (all pixels) bound the staging window.
  int rmin = kBig, rmax = -kBig, cmin = kBig, cmax = -kBig, ef = 0;
  int jmin = kBig, jmax = -kBig;
  for (int lj = lj0; lj < bh; lj += kRowStep) {
    const int row = rb * bh + lj;
    if (!col_ok || row >= h) continue;
    const size_t o = (size_t)row * w + col;
    const Coefs c = sample_coefs(row, col, u[o], v[o], h, w);
    bcx[o] = c.bx;
    bcy[o] = c.by;
    cmin = min(cmin, c.iv1);
    cmax = max(cmax, c.iv1);
    jmin = min(jmin, c.jv1);
    jmax = max(jmax, c.jv1);
    if (c.by) {
      ef = 1;
    } else {
      rmin = min(rmin, c.jv1 + bh - lj);
      rmax = max(rmax, c.jv1 + bh - lj);
    }
  }
  // all seven as min-reductions
  int vals[7] = {rmin, -rmax, cmin, -cmax, -ef, jmin, -jmax};
#pragma unroll
  for (int i = 0; i < 7; ++i) vals[i] = octane::warp_min(vals[i]);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 7; ++i) wred[i][tid >> 5] = vals[i];
  }
  __syncthreads();
  if (tid < 7) {
    int m = wred[tid][0];
    for (int j = 1; j < kThreads / 32; ++j) m = min(m, wred[tid][j]);
    bred[tid] = m;
  }
  __syncthreads();
  jmin = bred[5];
  jmax = -bred[6];
  cmin = bred[2];
  cmax = -bred[3];
  const int win_h = jmax - jmin + 2;
  const int win_w = cmax - cmin + 2;
  const bool stage = (long long)win_h * win_w <= kSmemFloats;
  if (tid == 0) {
    const size_t nb = (size_t)gh * gw, b = (size_t)rb * gw + cb;
    stats[b] = bred[0];
    stats[nb + b] = -bred[1];
    stats[2 * nb + b] = cmin;
    stats[3 * nb + b] = cmax;
    stats[4 * nb + b] = -bred[4];
    staged[b] = stage;
  }

  // ---- step 2: sample ---------------------------------------------------
  if (stage) {
    for (int ch = 0; ch < k; ++ch) {
      const float* f = fields + ch * plane;
      __syncthreads();                     // previous plane's readers done
      for (int i = tid; i < win_h * win_w; i += kThreads) {
        const int r = i / win_w;
        win[i] = f[(size_t)(jmin + r) * w + cmin + (i - r * win_w)];
      }
      __syncthreads();
      for (int lj = lj0; lj < bh; lj += kRowStep) {
        const int row = rb * bh + lj;
        if (!col_ok || row >= h) continue;
        const size_t o = (size_t)row * w + col;
        const Coefs c = sample_coefs(row, col, u[o], v[o], h, w);
        const float* t = win + (c.jv1 - jmin) * win_w + (c.iv1 - cmin);
        out[ch * plane + o] = bilerp(c, t[0], t[1], t[win_w], t[win_w + 1]);
      }
    }
  } else {
    for (int lj = lj0; lj < bh; lj += kRowStep) {
      const int row = rb * bh + lj;
      if (!col_ok || row >= h) continue;
      const size_t o = (size_t)row * w + col;
      const Coefs c = sample_coefs(row, col, u[o], v[o], h, w);
      const size_t base = (size_t)c.jv1 * w + c.iv1;
      for (int ch = 0; ch < k; ++ch) {
        const float* f = fields + ch * plane + base;
        out[ch * plane + o] = bilerp(c, f[0], f[1], f[w], f[w + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int octane_warp(const float* fields, const float* u, const float* v,
                           float* out, uint8_t* bcx, uint8_t* bcy,
                           int32_t* stats, uint8_t* staged, int k, int h, int w,
                           int bh, void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + bh - 1) / bh);
  warp_bilinear<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      fields, u, v, out, bcx, bcy, stats, staged, k, h, w, bh);
  return (int)cudaGetLastError();
}

extern "C" const char* octane_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
