// The SRSAL cross-bilateral smoother of the flow (u, v), guided by cloud-top
// height.
//
// Replaces the Pallas TPU kernel _kernel of octane_tpu/ops/pallas/bilateral.py
// (:45, called at :119).  It computes what that kernel and the reference loop
// post/srsal.py _tap_loop compute (oct_srsal_cuda.cu:34-71): for each pixel,
// over the (2p+1) x (2p+1) window (p = 18: 37 x 37 = 1369 taps) with the
// reference's mixed reflect boundary,
//   a1 = gk[kc] * gk[lc] * exp((c_n - c_0)^2 * sigpix2)
//   au += u_n * a1;  av += v_n * a1;  a2 += a1
// and writes (au / a2, av / a2).  Budget: rel <= 1e-5 against the plain
// version ops/bilateral.py bilateral_plain (docs/PARITY.md:91), not bit for
// bit; the TPU kernel sits ~1e-6 from its XLA twin too.
//
// Bound: the SFU and the dispatch of its queue, ~40 G taps at 5424^2.  The
// design dispatches ~7.4 instructions per tap:
//  * the spatial weight is folded into the exponent,
//      a1 = 2^(L[kc][lc] - k d^2),  d = c_n - c_0 (metres),
//      L = log2 gk[kc] + log2 gk[lc],  k = -sigpix2 log2(e),
//    L and k summed in double and rounded to float once (the host takes the
//    logs; the block sums each pair); per tap FADD d, FMUL t = k d,
//    FFMA arg = L - t d, one MUFU.EX2 (ex2.approx.ftz), two FFMAs and an
//    FADD.  Heights are subtracted in metres before any scaling: two heights
//    within a factor of 2 differ exactly, where pre-scaled heights would
//    carry ~3e-5 of rounding into d.  ex2.approx.ftz flushes weights below
//    2^-126 to 0, invisible beside the centre weight gk[p]^2 (~2e-3);
//  * register blocking: a thread owns R output pixels of one column, so a
//    window row's cth and (u, v) pair, two shared loads, serve up to R taps:
//    2 (R + 2p) / (R (2p + 1)) loads per tap (0.38 at R = 6, p = 18), and
//    the row of L for a column offset kc sits in registers.  Shared loads
//    queue with the MUFU ops, so fewer loads per tap are faster;
//  * p = 18, every caller's, is a template parameter, so the source-row and
//    pixel loops unroll and each tap's L is a register; one instantiation
//    with a run-time p (its L from shared memory) serves every other p.
// Each pixel sums its taps column offset kc outer, row offset lc inner, as
// _tap_loop does; only the weight's arithmetic differs.  The build's global
// -fmad=false stays: this file uses explicit intrinsics, no -use_fast_math.
// The MUFU rate (16 ex2 per clock per SM) puts the floor at ~9.6 ms at
// 5424^2 and 1.98 GHz.
//
// Layout: a block of 32 x BY threads owns 32 columns x BY R rows (32 x 48 at
// p = 18, 32 x 16 at any other p).  It stages its (32 + 2p) x
// (BY R + 2p) window of cth and of the (u, v) pairs in shared memory, with
// indices through the reference's boundary map as it loads (oct_bc_cuda:
// -k -> k, n-1+k -> n-k), so no padded copy is made; the wrapper requires
// h, w >= p + 1, where one reflection is enough.  Rows and columns past the
// grid's edge load a clamped window and write nothing.
//
// Band form (octane_tpu/parallel/post.py sharded_srsal :104 ran the XLA tap
// loop per block on a reflect-fixed halo): the output is rows [r0, r0 + h)
// of a th-row image, and the inputs are a slab of global rows [s0, s0 + hs)
// that holds every row the band's windows reach through the boundary map,
// taken in global coordinates (reflect(r0 + row, th) - s0).  The whole
// image is the slab and the band at once, so a band's rows equal the
// whole-image kernel's bit for bit.
//
// Left behind from the TPU kernel: the (BH, 128) lane tiles, the 8-row DMA
// chunks visited centre-chunk-first, the 384-wide roll chain, the host-side
// reflect pad and 128-column pad.

#include <math.h>

#include "common.cuh"

// The p = 18 block geometry: R rows per thread, BY rows of 32 threads.  6 x 8
// (32 x 48 pixels, 74.5 KB of shared memory, 3 blocks and 24 warps per SM,
// <= 80 registers) was the fastest of the geometries that
// tools/bilateral_geometry.py times by compiling this file alone with other
// values.
#ifndef OCTANE_BILATERAL_R
#define OCTANE_BILATERAL_R 6
#endif
#ifndef OCTANE_BILATERAL_BY
#define OCTANE_BILATERAL_BY 8
#endif

namespace {

constexpr int kBX = 32;
constexpr int kMaxP = 48;
constexpr int kMaxTaps = 2 * kMaxP + 1;
constexpr double kLog2E = 1.4426950408889634;  // log2(e)

struct LogTaps {
  double lg[kMaxTaps];  // log2 gk[k], in double
};

// 2^x: one MUFU.EX2; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// oct_bc_cuda's boundary map, then a clamp that only the windows of threads
// past the grid's edge reach
__device__ __forceinline__ int reflect(int x, int n) {
  if (x < 0) x = -x;
  if (x >= n) x = 2 * n - x - 1;
  return min(max(x, 0), n - 1);
}

// One tap of a pixel with centre height c0: weight 2^(lw - k d^2).
__device__ __forceinline__ void tap(float c, float un, float vn, float c0, float lw, float k,
                                    float& au, float& av, float& a2) {
  const float d = __fsub_rn(c, c0);
  const float a = ex2(__fmaf_rn(-__fmul_rn(k, d), d, lw));
  au = __fmaf_rn(un, a, au);
  av = __fmaf_rn(vn, a, av);
  a2 = __fadd_rn(a2, a);
}

// Row stride of the shared L table: a multiple of 4 floats, so a row loads
// as float4s.
__host__ __device__ constexpr int l_stride(int n) { return (n + 3) & ~3; }

// Floats of shared memory for half-width p, R rows per thread, BY rows of
// threads: the L table, the cth window and the (u, v) window.
__host__ __device__ constexpr int smem_floats(int p, int rows, int by) {
  return 3 * (kBX + 2 * p) * (by * rows + 2 * p) + (2 * p + 1) * l_stride(2 * p + 1);
}

// The most blocks of a geometry that one SM holds by its shared memory (228
// KB, 1 KB of it reserved per block) and its 2048 threads: the kernel's
// __launch_bounds__ caps the registers so that they hold as many.
__host__ __device__ constexpr int min_blocks(int p, int rows, int by) {
  const int by_smem = 233472 / (4 * smem_floats(p, rows, by) + 1024);
  const int by_threads = 2048 / (kBX * by);
  return by_smem < by_threads ? by_smem : by_threads;
}

// P > 0: half-width P at compile time; P == 0: half-width p_rt.
template <int P, int R, int BY>
__global__ void __launch_bounds__(kBX * BY, min_blocks(P > 0 ? P : kMaxP, R, BY))
bilateral_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ cth, float* __restrict__ out, int h, int w, int hs,
                 int s0, int r0, int th, int p_rt, float k, LogTaps taps) {
  extern __shared__ __align__(16) float smem[];
  const int p = P > 0 ? P : p_rt;
  const int n = 2 * p + 1;
  const int nl = l_stride(n);
  const int ww = kBX + 2 * p;
  const int win = ww * (BY * R + 2 * p);
  float* sl = smem;  // sl[kc * nl + lc] = L[kc][lc]
  float* sc = sl + n * nl;
  float2* suv = reinterpret_cast<float2*>(sc + win);  // (u, v); win is even
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int row0 = r0 + blockIdx.y * (BY * R) - p;   // global row of window row 0
  const int col0 = blockIdx.x * kBX - p;
  for (int e = tid; e < win; e += kBX * BY) {
    const int r = e / ww;
    const int c = e - r * ww;
    const int sr = min(max(reflect(row0 + r, th) - s0, 0), hs - 1);
    const size_t g = (size_t)sr * w + reflect(col0 + c, w);
    sc[e] = cth[g];
    suv[e] = make_float2(u[g], v[g]);
  }
  for (int e = tid; e < n * n; e += kBX * BY) {
    const int kc = e / n;
    const int lc = e - kc * n;
    sl[kc * nl + lc] = __double2float_rn(__dadd_rn(taps.lg[kc], taps.lg[lc]));
  }
  __syncthreads();

  const int col = blockIdx.x * kBX + threadIdx.x;
  const int rb = blockIdx.y * (BY * R) + threadIdx.y * R;   // the thread's first band row
  if (col >= w || rb >= h) return;
  const int base = threadIdx.y * R * ww + threadIdx.x;  // tap (0, 0) of row rb
  float c0[R], au[R], av[R], a2[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    c0[i] = sc[base + (i + p) * ww + p];
    au[i] = av[i] = a2[i] = 0.f;
  }
#pragma unroll 1
  for (int kc = 0; kc < n; ++kc) {
    const float* pc = sc + base + kc;
    const float2* puv = suv + base + kc;
    const float* lrow = sl + kc * nl;
    if constexpr (P > 0) {
      constexpr int N = 2 * P + 1;
      float lr[l_stride(N)];
#pragma unroll
      for (int j = 0; j < l_stride(N); j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(lrow + j);
        lr[j] = q.x;
        lr[j + 1] = q.y;
        lr[j + 2] = q.z;
        lr[j + 3] = q.w;
      }
      // window row s serves pixel i at row offset lc = s - i
#pragma unroll
      for (int s = 0; s < R + 2 * P; ++s) {
        const float c = pc[s * ww];
        const float2 uv = puv[s * ww];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (s - i >= 0 && s - i < N)
            tap(c, uv.x, uv.y, c0[i], lr[s - i], k, au[i], av[i], a2[i]);
        }
      }
    } else {
#pragma unroll 1
      for (int s = 0; s < R + 2 * p; ++s) {
        const float c = pc[s * ww];
        const float2 uv = puv[s * ww];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int lc = s - i;
          if (lc >= 0 && lc < n) tap(c, uv.x, uv.y, c0[i], lrow[lc], k, au[i], av[i], a2[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (rb + i < h) {
      const size_t o = (size_t)(rb + i) * w + col;
      out[o] = __fdiv_rn(au[i], a2[i]);
      out[(size_t)h * w + o] = __fdiv_rn(av[i], a2[i]);
    }
  }
}

template <int P, int R, int BY>
int launch(const float* u, const float* v, const float* cth, float* out, int h, int w, int hs,
           int s0, int r0, int th, int p, float k, const LogTaps& taps, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(p, R, BY);
  auto kernel = bilateral_kernel<P, R, BY>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kBX, BY);
  const dim3 grid((w + kBX - 1) / kBX, (h + BY * R - 1) / (BY * R));
  kernel<<<grid, block, bytes, stream>>>(u, v, cth, out, h, w, hs, s0, r0, th, p, k, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// out (2, h, w) = the smoothed (u, v) of the band's h rows from global row
// r0 of a th-row image, from a slab of rows [s0, s0 + hs) (see the band form
// above); gk_host is the host array of the 2p+1 spatial taps.  p = 18 runs
// its own instantiation; every other p the run-time-p one, 4 rows per thread
// and 32 x 4 threads, whose window fits the card's shared memory up to p =
// 48 (~210 KB).  Requires p + 1 <= th, w, p <= kMaxP and a slab that holds
// the band's window rows (the wrappers check all three).
extern "C" int octane_bilateral_band(const float* u, const float* v, const float* cth,
                                     float* out, const float* gk_host, int h, int w, int hs,
                                     int s0, int r0, int th, int p, float sigpix2,
                                     void* stream) {
  if (p < 0 || p > kMaxP || h < 1 || s0 < 0 || s0 + hs > th || r0 < s0 || r0 + h > s0 + hs)
    return (int)cudaErrorInvalidValue;
  LogTaps taps;
  for (int j = 0; j < 2 * p + 1; ++j) taps.lg[j] = log2((double)gk_host[j]);
  const float k = (float)(-(double)sigpix2 * kLog2E);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p == 18)
    return launch<18, OCTANE_BILATERAL_R, OCTANE_BILATERAL_BY>(u, v, cth, out, h, w, hs, s0, r0,
                                                               th, p, k, taps, s);
  return launch<0, 4, 4>(u, v, cth, out, h, w, hs, s0, r0, th, p, k, taps, s);
}

// The whole image: the slab and the band are its h rows.
extern "C" int octane_bilateral(const float* u, const float* v, const float* cth, float* out,
                                const float* gk_host, int h, int w, int p, float sigpix2,
                                void* stream) {
  return octane_bilateral_band(u, v, cth, out, gk_host, h, w, h, 0, 0, h, p, sigpix2, stream);
}
