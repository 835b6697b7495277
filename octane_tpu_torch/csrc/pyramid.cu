// One level of the solver pyramid: the Gaussian blur at full resolution
// and the point subsample, in one pass that computes only the pixels the
// level keeps.
//
// No Pallas kernel of the JAX package corresponds: octane_tpu builds the
// pyramid with plain XLA (core/zoom.py pyramid_downsample).  The port's
// plain version (core.zoom.pyramid_downsample_rows) blurs every
// full-resolution pixel, one eager op per tap and axis (a shifted copy, a
// multiply and an add), then keeps a quarter, a sixteenth, ... of them.
//
//   out[n, J, I] = sum_dy w[dy] * H(n, clamp(ridx[J] + dy), cidx[I])
//   H(n, r, c)   = sum_dx w[dx] * img[n, r, clamp(c + dx)]
//
// with dx and dy from -fs to fs - 1 in that order, each sum begun with its
// first product, each product and each sum rounded on its own, and the
// clamps to the input's own rows and columns (a band's slab's edges): the
// plain version's bits.
//
// A block owns 32 output columns (a lane each) and up to 32 output rows of
// one plane (the tile).  The pyramid's source rows do not decrease, so the
// rows that the tile's vertical windows reach lie between the first row's
// window and the last's; the wrapper sizes the tile so that these fit the
// shared memory (ops/pyramid.py tiling).  Each warp computes the
// horizontal sums of some of those rows at the tile's columns into shared
// memory, every lane its column's taps straight from device memory, and
// each output sums its window from there.  A warp's taps of one row span a
// few cache lines, which the L1 serves, so each row segment comes from
// device memory about once.  Only a tap at an edge goes through the clamp.
// Where the windows lie far apart (f <= 1/16) the rows between them are
// staged too, unused: correct, but slower there (the default four levels
// stop at f = 1/8).
//
// Bound: memory.  A level reads each of its N full-resolution planes once
// (at factors >= 1/16 every row and column is reached) and writes its N
// level planes: at 5424^2, N = 4 and f = 1/2, 0.59 GB, 0.176 ms on
// 3.35 TB/s.  The 2 x 2fs flops per output and 2fs per horizontal sum are
// far under that.
//
// octane_pyramid_level(...) returns a cudaError_t.

#include "common.cuh"

namespace {

using octane::add;
using octane::mul;

constexpr int kCols = 32;                  // output columns of a tile: a lane each
constexpr int kRowThreads = 8;             // warps down the tile
constexpr int kThreads = kCols * kRowThreads;
constexpr int kMaxRows = 32;               // output rows of a tile
constexpr int kHPitch = kCols + 1;         // words per staged row of horizontal sums
constexpr int kMaxTaps = 128;              // 2 fs

struct Taps {
  float w[kMaxTaps];
};

__device__ __forceinline__ int clampi(int x, int n) { return min(max(x, 0), n - 1); }

// Tap k's weight.  FS > 0: fs known at compile time, the taps unrolled from
// the parameter bank; FS == 0: fs at run time, the taps in shared memory.
template <int FS>
__device__ __forceinline__ float tap(const Taps& taps, const float* sw, int k) {
  if constexpr (FS > 0) {
    return taps.w[k];
  } else {
    return sw[k];
  }
}

// sum_k w[k] * x[(i(k) - base) * stride] over the 2 fs taps, in order,
// where i(k) = i0 + k, clamped to [0, n) where ``clamped`` (an edge's taps).
template <int FS>
__device__ __forceinline__ float taps_sum(const Taps& taps, const float* sw, int fs,
                                          const float* x, int i0, int base, int stride,
                                          bool clamped, int n) {
  float h = 0.f;
  if (clamped) {
#pragma unroll
    for (int k = 0; k < 2 * (FS > 0 ? FS : fs); ++k) {
      const float p = mul(tap<FS>(taps, sw, k), x[(clampi(i0 + k, n) - base) * stride]);
      h = k == 0 ? p : add(h, p);
    }
  } else {
    x += (i0 - base) * stride;
#pragma unroll
    for (int k = 0; k < 2 * (FS > 0 ? FS : fs); ++k) {
      const float p = mul(tap<FS>(taps, sw, k), x[k * stride]);
      h = k == 0 ? p : add(h, p);
    }
  }
  return h;
}

template <int FS>
__global__ void __launch_bounds__(kThreads)
pyramid_level_kernel(const float* __restrict__ img, const int64_t* __restrict__ ridx,
                     const int64_t* __restrict__ cidx, float* __restrict__ out, int hs, int w,
                     int ho, int wo, int fs_rt, int tile_rows, Taps taps) {
  extern __shared__ float hsum[];                 // the tile's source rows x kHPitch
  __shared__ float sw[FS > 0 ? 1 : kMaxTaps];

  const int fs = FS > 0 ? FS : fs_rt;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int j0 = blockIdx.y * tile_rows;
  const int j_end = min(j0 + tile_rows, ho);
  const int col = blockIdx.x * kCols + lane;
  const bool live = col < wo;
  const int c = live ? (int)cidx[col] : 0;
  const float* plane = img + (size_t)blockIdx.z * hs * w;
  float* oplane = out + (size_t)blockIdx.z * ho * wo;
  // the source rows [lo, lo + nrows): the first row's window to the last's
  const int lo = clampi((int)ridx[j0] - fs, hs);
  const int nrows = clampi((int)ridx[j_end - 1] + fs - 1, hs) - lo + 1;

  if constexpr (FS == 0) {
    if (warp == 0) {
      for (int k = lane; k < 2 * fs; k += kCols) sw[k] = taps.w[k];
    }
    __syncthreads();
  }

  // the horizontal sums of those rows at the tile's columns
  if (live) {
    const bool clamped = c - fs < 0 || c + fs > w;
    for (int s = warp; s < nrows; s += kRowThreads)
      hsum[s * kHPitch + lane] = taps_sum<FS>(taps, sw, fs, plane + (size_t)(lo + s) * w,
                                              c - fs, 0, 1, clamped, w);
  }
  __syncthreads();

  // each output row: its window's sums, in tap order
  if (live) {
    for (int j = j0 + warp; j < j_end; j += kRowThreads) {
      const int r = (int)ridx[j];
      oplane[(size_t)j * wo + col] = taps_sum<FS>(taps, sw, fs, hsum + lane, r - fs, lo,
                                                  kHPitch, r - fs < 0 || r + fs > hs, hs);
    }
  }
}

template <int FS>
cudaError_t launch(const float* img, const int64_t* ridx, const int64_t* cidx, float* out,
                   int n, int hs, int w, int ho, int wo, int fs, int tile_rows, int cap,
                   const Taps& taps, cudaStream_t stream) {
  const size_t smem = (size_t)cap * kHPitch * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((wo + kCols - 1) / kCols, (ho + tile_rows - 1) / tile_rows, n);
  pyramid_level_kernel<FS><<<grid, dim3(kCols, kRowThreads), smem, stream>>>(
      img, ridx, cidx, out, hs, w, ho, wo, fs, tile_rows, taps);
  return cudaGetLastError();
}

}  // namespace

// img (n, hs, w) float32, ridx (ho,) and cidx (wo,) int64 indices into its
// rows and columns, the pyramid's (ridx does not decrease), out (n, ho, wo)
// float32; weights: 2 fs host floats, copied into the launch's parameters
// (nothing is uploaded, so a captured launch keeps them).  tile_rows <= 32
// output rows a block, cap >= 2 fs source rows of horizontal sums, at least
// those a tile's windows reach (ops/pyramid.py tiling picks both).
extern "C" int octane_pyramid_level(const void* img, const void* ridx, const void* cidx,
                                    void* out, int n, int hs, int w, int ho, int wo, int fs,
                                    const void* weights, int tile_rows, int cap, void* stream) {
  if (fs < 1 || 2 * fs > kMaxTaps || tile_rows < 1 || tile_rows > kMaxRows || cap < 2 * fs)
    return (int)cudaErrorInvalidValue;
  Taps taps = {};
  for (int k = 0; k < 2 * fs; ++k) taps.w[k] = static_cast<const float*>(weights)[k];
  const float* x = static_cast<const float*>(img);
  const int64_t* ri = static_cast<const int64_t*>(ridx);
  const int64_t* ci = static_cast<const int64_t*>(cidx);
  float* y = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  // fs 5: every level at f >= 1/16
  return (int)(fs == 5 ? launch<5>(x, ri, ci, y, n, hs, w, ho, wo, fs, tile_rows, cap, taps, s)
                       : launch<0>(x, ri, ci, y, n, hs, w, ho, wo, fs, tile_rows, cap, taps, s));
}
