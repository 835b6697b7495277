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
// One pass per pixel: a block owns a bh x 128 output tile (bh = 64, or 32
// below 64 rows, as _pick_bh in warp.py) and each thread takes every other
// row of one column of it.  Per pixel the thread reads u and v once,
// computes its bilinear cell and weights once (sample_coefs), writes its
// two clamp flags once, folds the pixel into the tile's statistics, and
// produces all K planes from registers: the four taps of each plane come
// through the read-only data path (__ldg).  For smooth flow the 32 lanes of a warp
// read neighbouring addresses, so a tap row of a plane is one or two cache
// lines, and the window of a tile is read from device memory about once;
// for any other flow the taps are scattered reads, so the reach is
// unbounded.  After its rows the block reduces the statistics.
//
// Bound: memory.  Per pixel the card must read u, v and the K source
// values and write K samples and two flag bytes: 14.5 planes at K = 6,
// 1.71 GB and 0.51 ms at 5424^2 on 3.35 TB/s; the few dozen flops per
// pixel are far under that.
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
    int32_t* __restrict__ stats, int k, int h, int w, int bh) {
  __shared__ int wred[5][kThreads / 32];

  const int tid = threadIdx.x;
  const int cb = blockIdx.x, rb = blockIdx.y;
  const int gw = gridDim.x, gh = gridDim.y;
  const int col = cb * kTileW + (tid % kTileW);
  const int lj0 = tid / kTileW;
  const size_t plane = (size_t)h * w;

  // Row statistic as _block_stats: jv1 + bh - lj over pixels whose sample
  // row is not clamped; column statistic: iv1 over all pixels (the TPU
  // layout's CPAD offset is not added); eflag: any row-clamped pixel.
  int rmin = kBig, rmax = -kBig, cmin = kBig, cmax = -kBig, ef = 0;
  if (col < w) {
    for (int lj = lj0; lj < bh; lj += kRowStep) {
      const int row = rb * bh + lj;
      if (row >= h) break;
      const size_t o = (size_t)row * w + col;
      const Coefs c = sample_coefs(row, col, __ldg(u + o), __ldg(v + o), h, w);
      bcx[o] = c.bx;
      bcy[o] = c.by;
      cmin = min(cmin, c.iv1);
      cmax = max(cmax, c.iv1);
      if (c.by) {
        ef = 1;
      } else {
        rmin = min(rmin, c.jv1 + bh - lj);
        rmax = max(rmax, c.jv1 + bh - lj);
      }
      const float* f = fields + (size_t)c.jv1 * w + c.iv1;
      float* dst = out + o;
#pragma unroll 6
      for (int ch = 0; ch < k; ++ch, f += plane, dst += plane) {
        *dst = bilerp(c, __ldg(f), __ldg(f + 1), __ldg(f + w), __ldg(f + w + 1));
      }
    }
  }

  // the tile's statistics, all five as min-reductions
  int vals[5] = {rmin, -rmax, cmin, -cmax, -ef};
#pragma unroll
  for (int i = 0; i < 5; ++i) vals[i] = octane::warp_min(vals[i]);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) wred[i][tid >> 5] = vals[i];
  }
  __syncthreads();
  if (tid < 5) {
    int m = wred[tid][0];
    for (int j = 1; j < kThreads / 32; ++j) m = min(m, wred[tid][j]);
    const size_t nb = (size_t)gh * gw, b = (size_t)rb * gw + cb;
    stats[tid * nb + b] = (tid == 0 || tid == 2) ? m : -m;   // max = -min(-x)
  }
}

// Band form (the counterpart of octane_tpu/parallel/sharded.py
// make_sharded_warp :68, which ran _kernel over a halo-padded shard block):
// output rows [r0, r0 + hb) of the true (th, w) image, sampled from a slab
// that holds global rows [s0, s0 + hs) of the stack.  Positions, clamps and
// flags are those of the whole-image kernel in global coordinates
// (sample_coefs at row r0 + lrow against th), and the taps are read at slab
// row jv1 - s0, so the samples and flags equal the whole-image kernel's rows
// bit for bit.  The caller's reach test (parallel/sharded.py) warps the
// band again from the whole level wherever the slab may miss a sample row;
// the clamp only keeps the first warp's reads inside the slab then.  No
// tile statistics: the slab replaces the window.
// Bound: memory, as the whole-image kernel, on the band's pixels.
__global__ void __launch_bounds__(kThreads) warp_band(
    const float* __restrict__ slab, const float* __restrict__ u,
    const float* __restrict__ v, float* __restrict__ out,
    uint8_t* __restrict__ bcx, uint8_t* __restrict__ bcy, int k, int hb, int w, int hs,
    int s0, int r0, int th, int bh) {
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kTileW + (tid % kTileW);
  if (col >= w) return;
  const size_t splane = (size_t)hs * w, oplane = (size_t)hb * w;
  for (int lj = tid / kTileW; lj < bh; lj += kRowStep) {
    const int row = blockIdx.y * bh + lj;
    if (row >= hb) break;
    const size_t o = (size_t)row * w + col;
    const Coefs c = sample_coefs(r0 + row, col, __ldg(u + o), __ldg(v + o), th, w);
    bcx[o] = c.bx;
    bcy[o] = c.by;
    const int sr = min(max(c.jv1 - s0, 0), hs - 2);
    const float* f = slab + (size_t)sr * w + c.iv1;
    float* dst = out + o;
#pragma unroll 6
    for (int ch = 0; ch < k; ++ch, f += splane, dst += oplane) {
      *dst = bilerp(c, __ldg(f), __ldg(f + 1), __ldg(f + w), __ldg(f + w + 1));
    }
  }
}

}  // namespace

extern "C" int octane_warp_band(const float* slab, const float* u, const float* v, float* out,
                                uint8_t* bcx, uint8_t* bcy, int k, int hb, int w, int hs,
                                int s0, int r0, int th, int bh, void* stream) {
  if (hs < 2 || hb < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (hb + bh - 1) / bh);
  warp_band<<<grid, kThreads, 0, (cudaStream_t)stream>>>(slab, u, v, out, bcx, bcy, k, hb, w,
                                                         hs, s0, r0, th, bh);
  return (int)cudaGetLastError();
}

extern "C" int octane_warp(const float* fields, const float* u, const float* v,
                           float* out, uint8_t* bcx, uint8_t* bcy,
                           int32_t* stats, int k, int h, int w, int bh,
                           void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + bh - 1) / bh);
  warp_bilinear<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      fields, u, v, out, bcx, bcy, stats, k, h, w, bh);
  return (int)cudaGetLastError();
}

extern "C" const char* octane_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
