// Patch-match's zero-guess search: the spiral search of every pixel and its
// quadratic sub-pixel fit, in one launch.
//
// No Pallas kernel of the JAX package corresponds: octane_tpu's patch-match
// (flow/patch_match.py) is plain XLA.  The port's plain version
// (flow.patch_match._patch_match_local) builds, at each of the (2 srad + 1)^2
// spiral offsets, a plane of squared differences e^2 and a cost plane from
// (2 rad + 1)^2 shifted windows of it, then 45 more cost planes for the fit:
// about 70 x 26 passes over full-size planes through device memory.
//
//   cost(y, x; n, m) = sum_k sum_l d^2,
//   d = g2p[y + l + m + smax][x + k + n + smax] - g1p[y + l + rad][x + k + rad]
//
// with k (columns) outer and l (rows) inner, both from -rad to rad, the sum
// begun with its first square, each difference, square and sum rounded on
// its own; the winner is the first strict minimum in the spiral's order (it
// starts at (0, 0)); then along each axis, with the winner's cost c0 and its
// neighbours' c+ and c-, jquad_interp's vertex
//   denom = 2 ((c+ + c-) - 2 c0),  centre + (denom == 0 ? 0 : (c- - c+) / denom),
// kept where c0 < c+ and c0 < c-, else the centre: the plain version's bits.
//
// A block owns a tile of 32 columns (a lane each) and P * 4 rows (a warp
// owns P rows, a thread a column of P pixels).  It stages its tile of g1p
// (halo rad) and of g2p (halo smax = rad + srad + 1) in shared memory once.
// For each offset, in the spiral's order, it writes d^2 over the tile and
// its rad halo into shared memory (each square once, double-buffered: one
// barrier an offset), and each thread sums its pixels' windows from there
// in registers, a column of the window at a time, reusing it down its P
// pixels.  Every pixel's (2 srad + 1)^2 costs stay in registers (the loops
// are unrolled, so no local memory), indexed by their place in the search
// square.  The fit takes c0 and the neighbours inside the square from
// them; a winner on the square's edge needs a cost at |n| or |m| = srad + 1,
// which is computed fresh from the staged tiles by the same arithmetic
// (never at a corner).  Only u and v are written.
//
// Bound: operations.  Per pixel each offset costs a difference and a
// square (shared by the windows that hold the pixel) and (2 rad + 1)^2 - 1
// sums, plus a comparison: 674 at rad 2, srad 2, and 20 for the fit
// (octbench/rooflines.json "patch_match": 0.3047 ms at 5424^2 against 67
// TFLOP/s, which counts a multiply-add as two; built with -fmad=false these
// are separate adds and multiplies, so the card's rate for them is half
// that).  Device memory sees each image once and u, v once.  Shared memory
// serves (P + 2 rad) floats a column of the window for P pixels (10 reads a
// pixel an offset at rad 2, P = 4), and each offset ends at a barrier: those
// reads and that barrier, not the adds, hold the kernel back.
//
// Instances: rad 1 or 2 (OCTANE's default 2), srad 1, 2 or 3, with P = 8, 4,
// 2 at srad 1, 2, 3, which keeps a thread's P (2 srad + 1)^2 costs within
// 100 registers; each instance adds seconds to the build.  Every other
// radius (rad >= 0, srad >= 0) takes patch_match_search_any: a thread a
// pixel, each cost summed from device memory (the read-only cache) by the
// same arithmetic, a running minimum in the spiral's order, and the four
// probes of the fit computed fresh, so no cost is kept and any radius fits.
//
// octane_patch_match(...) returns a cudaError_t.

#include "common.cuh"

namespace {

using octane::add;
using octane::mul;
using octane::sub;

constexpr int kCols = 32;                  // tile columns: a lane each
constexpr int kWarps = 4;                  // warps down the tile
constexpr int kThreads = kCols * kWarps;

template <int RAD, int SRAD, int P>
struct Geometry {
  static constexpr int kSmax = RAD + SRAD + 1;                     // g2p's halo
  static constexpr int kSide = 2 * SRAD + 1;                       // the search square's side
  static constexpr int kOffsets = kSide * kSide;
  static constexpr int kRows = P * kWarps;                         // tile rows
  static constexpr int kEH = kRows + 2 * RAD, kEW = kCols + 2 * RAD;      // g1p's tile, e^2's
  static constexpr int kGH = kRows + 2 * kSmax, kGW = kCols + 2 * kSmax;  // g2p's tile
  static constexpr int kE = kEH * kEW, kG = kGH * kGW;
  static constexpr int kStage = (kE + kThreads - 1) / kThreads;   // squares a thread writes
};

// The spiral's offsets (n, m) in the reference's visit order
// (flow.patch_match.spiral_offsets).
template <int SRAD>
struct Spiral {
  int n[(2 * SRAD + 1) * (2 * SRAD + 1)];
  int m[(2 * SRAD + 1) * (2 * SRAD + 1)];
};

template <int SRAD>
__host__ __device__ constexpr Spiral<SRAD> spiral() {
  Spiral<SRAD> s{};
  int n = 0, m = 0, dn = 0, dm = -1;
  for (int i = 0; i < (2 * SRAD + 1) * (2 * SRAD + 1); ++i) {
    s.n[i] = n;
    s.m[i] = m;
    if (n == m || (n < 0 && n == -m) || (n > 0 && n == 1 - m)) {
      const int t = dn;
      dn = -dm;
      dm = t;
    }
    n += dn;
    m += dm;
  }
  return s;
}

// jquad_interp along one axis: the plain version's _refine.
__device__ __forceinline__ float refine(int centre, float c0, float cp, float cm) {
  const float x = static_cast<float>(centre);
  const float denom = mul(2.f, sub(add(cp, cm), mul(2.f, c0)));
  const float vertex = add(x, denom == 0.f ? 0.f : __fdiv_rn(sub(cm, cp), denom));
  return c0 < cp && c0 < cm ? vertex : x;
}

// The cost of offset (n, m) at the tile's pixel (y, x), from the staged tiles.
template <int RAD, int SRAD, int P>
__device__ __forceinline__ float fresh_cost(const float* g1, const float* g2, int y, int x, int n,
                                            int m) {
  using G = Geometry<RAD, SRAD, P>;
  const float* a = g2 + (y + G::kSmax - RAD + m) * G::kGW + x + G::kSmax - RAD + n;
  const float* b = g1 + y * G::kEW + x;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * RAD; ++k) {
#pragma unroll
    for (int l = 0; l <= 2 * RAD; ++l) {
      const float d = sub(a[l * G::kGW + k], b[l * G::kEW + k]);
      const float t = mul(d, d);
      acc = k == 0 && l == 0 ? t : add(acc, t);
    }
  }
  return acc;
}

template <int RAD, int SRAD, int P>
__global__ void __launch_bounds__(kThreads)
patch_match_search_kernel(const float* __restrict__ g1p, const float* __restrict__ g2p,
                          float* __restrict__ u, float* __restrict__ v, int hl, int wl) {
  using G = Geometry<RAD, SRAD, P>;
  constexpr Spiral<SRAD> sp = spiral<SRAD>();
  constexpr int W = G::kSide;
  __shared__ float g1[G::kE];
  __shared__ float g2[G::kG];
  __shared__ float e2[2][G::kE];

  const int tx = threadIdx.x, ty = threadIdx.y * P;       // the thread's first pixel in the tile
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int x0 = blockIdx.x * kCols, y0 = blockIdx.y * G::kRows;

  // the tiles; rows and columns past the block's repeat its last (they feed
  // only pixels past its edge, which are not stored)
  {
    const int w1 = wl + 2 * RAD, h1 = hl + 2 * RAD;
    for (int i = tid; i < G::kE; i += kThreads) {
      const int r = i / G::kEW, c = i - r * G::kEW;
      g1[i] = g1p[(size_t)min(y0 + r, h1 - 1) * w1 + min(x0 + c, w1 - 1)];
    }
    const int w2 = wl + 2 * G::kSmax, h2 = hl + 2 * G::kSmax;
    for (int i = tid; i < G::kG; i += kThreads) {
      const int r = i / G::kGW, c = i - r * G::kGW;
      g2[i] = g2p[(size_t)min(y0 + r, h2 - 1) * w2 + min(x0 + c, w2 - 1)];
    }
  }
  __syncthreads();

  // the squares this thread writes: element i = tid + j kThreads of the e^2
  // tile, its g1 value and the g2 element it subtracts at offset (0, 0)
  float own1[G::kStage];
  int own2[G::kStage];
#pragma unroll
  for (int j = 0; j < G::kStage; ++j) {
    const int i = min(tid + j * kThreads, G::kE - 1);
    const int r = i / G::kEW, c = i - r * G::kEW;
    own1[j] = g1[i];
    own2[j] = (r + G::kSmax - RAD) * G::kGW + c + G::kSmax - RAD;
  }

  // every offset's cost of the thread's P pixels, by place in the square:
  // (m + srad) W + n + srad
  float cost[P][G::kOffsets];
#pragma unroll
  for (int o = 0; o < G::kOffsets; ++o) {
    float* e = e2[o & 1];
    const int shift = sp.m[o] * G::kGW + sp.n[o];
#pragma unroll
    for (int j = 0; j < G::kStage; ++j) {
      if (j + 1 < G::kStage || tid + j * kThreads < G::kE) {
        const float d = sub(g2[own2[j] + shift], own1[j]);
        e[tid + j * kThreads] = mul(d, d);
      }
    }
    __syncthreads();
    float acc[P];
#pragma unroll
    for (int k = 0; k <= 2 * RAD; ++k) {
      float col[P + 2 * RAD];
#pragma unroll
      for (int q = 0; q < P + 2 * RAD; ++q) col[q] = e[(ty + q) * G::kEW + tx + k];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int l = 0; l <= 2 * RAD; ++l)
          acc[p] = k == 0 && l == 0 ? col[p] : add(acc[p], col[p + l]);
      }
    }
    const int g = (sp.m[o] + SRAD) * W + sp.n[o] + SRAD;
#pragma unroll
    for (int p = 0; p < P; ++p) cost[p][g] = acc[p];
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    // the first strict minimum in the spiral's order
    float best = cost[p][SRAD * W + SRAD];
    int win = SRAD * W + SRAD;
#pragma unroll
    for (int o = 1; o < G::kOffsets; ++o) {
      const int g = (sp.m[o] + SRAD) * W + sp.n[o] + SRAD;
      if (cost[p][g] < best) {
        best = cost[p][g];
        win = g;
      }
    }
    const int jw = win / W, iw = win - jw * W;            // m + srad, n + srad
    // the winner's row and column of the square, then their neighbours
    float row[W], column[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      row[i] = cost[p][i];
      column[i] = cost[p][i * W];
    }
#pragma unroll
    for (int j = 1; j < W; ++j) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        row[i] = jw == j ? cost[p][j * W + i] : row[i];
        column[i] = iw == j ? cost[p][i * W + j] : column[i];
      }
    }
    float su1 = 0.f, su2 = 0.f, sv1 = 0.f, sv2 = 0.f;      // (n + 1), (n - 1), (m + 1), (m - 1)
#pragma unroll
    for (int i = 0; i < W; ++i) {
      su1 = iw + 1 == i ? row[i] : su1;
      su2 = iw - 1 == i ? row[i] : su2;
      sv1 = jw + 1 == i ? column[i] : sv1;
      sv2 = jw - 1 == i ? column[i] : sv2;
    }
    // outside the square: fresh, where any lane of the warp needs one
    if (__any_sync(octane::kFullMask, iw == 0 || iw == W - 1)) {
      const float f = fresh_cost<RAD, SRAD, P>(g1, g2, ty + p, tx, iw == 0 ? -SRAD - 1 : SRAD + 1,
                                               jw - SRAD);
      su2 = iw == 0 ? f : su2;
      su1 = iw == W - 1 ? f : su1;
    }
    if (__any_sync(octane::kFullMask, jw == 0 || jw == W - 1)) {
      const float f = fresh_cost<RAD, SRAD, P>(g1, g2, ty + p, tx, iw - SRAD,
                                               jw == 0 ? -SRAD - 1 : SRAD + 1);
      sv2 = jw == 0 ? f : sv2;
      sv1 = jw == W - 1 ? f : sv1;
    }
    const int y = y0 + ty + p, x = x0 + tx;
    if (y < hl && x < wl) {
      u[(size_t)y * wl + x] = refine(iw - SRAD, best, su1, su2);
      v[(size_t)y * wl + x] = refine(jw - SRAD, best, sv1, sv2);
    }
  }
}

// The cost of offset (n, m) at the block's pixel (y, x), from the padded
// block in device memory: the instances' arithmetic at any radius.
__device__ __forceinline__ float cost_any(const float* __restrict__ g1p,
                                          const float* __restrict__ g2p, int w1, int w2, int y,
                                          int x, int rad, int smax, int n, int m) {
  const float* a = g2p + (size_t)(y + smax - rad + m) * w2 + x + smax - rad + n;
  const float* b = g1p + (size_t)y * w1 + x;
  float acc = 0.f;
  for (int k = 0; k <= 2 * rad; ++k) {
    for (int l = 0; l <= 2 * rad; ++l) {
      const float d = sub(__ldg(a + (size_t)l * w2 + k), __ldg(b + (size_t)l * w1 + k));
      const float t = mul(d, d);
      acc = k == 0 && l == 0 ? t : add(acc, t);
    }
  }
  return acc;
}

constexpr int kAnyRows = 8;                // a block of patch_match_search_any: 32 x 8 pixels

__global__ void __launch_bounds__(kCols * kAnyRows)
patch_match_search_any(const float* __restrict__ g1p, const float* __restrict__ g2p,
                       float* __restrict__ u, float* __restrict__ v, int hl, int wl, int rad,
                       int srad) {
  const int x = blockIdx.x * kCols + threadIdx.x, y = blockIdx.y * kAnyRows + threadIdx.y;
  if (x >= wl || y >= hl) return;
  const int smax = rad + srad + 1, w1 = wl + 2 * rad, w2 = wl + 2 * smax;
  // the spiral (flow.patch_match.spiral_offsets) from (0, 0), the first
  // strict minimum winning
  float best = cost_any(g1p, g2p, w1, w2, y, x, rad, smax, 0, 0);
  int nw = 0, mw = 0, n = 0, m = 0, dn = 0, dm = -1;
  const int offsets = (2 * srad + 1) * (2 * srad + 1);
  for (int i = 1; i < offsets; ++i) {
    if (n == m || (n < 0 && n == -m) || (n > 0 && n == 1 - m)) {
      const int t = dn;
      dn = -dm;
      dm = t;
    }
    n += dn;
    m += dm;
    const float c = cost_any(g1p, g2p, w1, w2, y, x, rad, smax, n, m);
    if (c < best) {
      best = c;
      nw = n;
      mw = m;
    }
  }
  const float su1 = cost_any(g1p, g2p, w1, w2, y, x, rad, smax, nw + 1, mw);
  const float su2 = cost_any(g1p, g2p, w1, w2, y, x, rad, smax, nw - 1, mw);
  const float sv1 = cost_any(g1p, g2p, w1, w2, y, x, rad, smax, nw, mw + 1);
  const float sv2 = cost_any(g1p, g2p, w1, w2, y, x, rad, smax, nw, mw - 1);
  u[(size_t)y * wl + x] = refine(nw, best, su1, su2);
  v[(size_t)y * wl + x] = refine(mw, best, sv1, sv2);
}

template <int RAD, int SRAD, int P>
cudaError_t launch(const float* g1p, const float* g2p, float* u, float* v, int hl, int wl,
                   cudaStream_t stream) {
  using G = Geometry<RAD, SRAD, P>;
  const dim3 grid((wl + kCols - 1) / kCols, (hl + G::kRows - 1) / G::kRows);
  patch_match_search_kernel<RAD, SRAD, P><<<grid, dim3(kCols, kWarps), 0, stream>>>(
      g1p, g2p, u, v, hl, wl);
  return cudaGetLastError();
}

}  // namespace

// g1p (hl + 2 rad, wl + 2 rad) and g2p (hl + 2 smax, wl + 2 smax) float32,
// a block of whole rows of the two images padded with their edge values;
// u, v (hl, wl) float32.  One launch: an instance's kernel where one is
// built for (rad, srad), else patch_match_search_any.
extern "C" int octane_patch_match(const void* g1p, const void* g2p, void* u, void* v, int hl,
                                  int wl, int rad, int srad, void* stream) {
  if (hl < 1 || wl < 1 || rad < 0 || srad < 0) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(g1p);
  const float* b = static_cast<const float*>(g2p);
  float* pu = static_cast<float*>(u);
  float* pv = static_cast<float*>(v);
  cudaStream_t s = (cudaStream_t)stream;
  if (rad == 1 && srad == 1) return (int)launch<1, 1, 8>(a, b, pu, pv, hl, wl, s);
  if (rad == 1 && srad == 2) return (int)launch<1, 2, 4>(a, b, pu, pv, hl, wl, s);
  if (rad == 1 && srad == 3) return (int)launch<1, 3, 2>(a, b, pu, pv, hl, wl, s);
  if (rad == 2 && srad == 1) return (int)launch<2, 1, 8>(a, b, pu, pv, hl, wl, s);
  if (rad == 2 && srad == 2) return (int)launch<2, 2, 4>(a, b, pu, pv, hl, wl, s);
  if (rad == 2 && srad == 3) return (int)launch<2, 3, 2>(a, b, pu, pv, hl, wl, s);
  const dim3 grid((wl + kCols - 1) / kCols, (hl + kAnyRows - 1) / kAnyRows);
  patch_match_search_any<<<grid, dim3(kCols, kAnyRows), 0, s>>>(a, b, pu, pv, hl, wl, rad,
                                                                 srad);
  return (int)cudaGetLastError();
}
