// The SRSAL cross-bilateral smoother of the flow (u, v), guided by cloud-top
// height.
//
// Replaces the Pallas TPU kernel _kernel of octane_tpu/ops/pallas/bilateral.py
// (:45, called at :119).  It computes what that kernel and the reference loop
// post/srsal.py _tap_loop compute (oct_srsal_cuda.cu:34-71): for each pixel,
// over the (2p+1) x (2p+1) window (p = 18: 37 x 37 = 1369 taps),
//   a1 = (gk[kc] * gk[lc]) * expf((dmc * dmc) * sigpix2),  dmc = cth_n - cth_0
//   au += u_n * a1;  av += v_n * a1;  a2 += a1
// and writes (au / a2, av / a2).  Taps run column offset kc outer, row
// offset lc inner, as _tap_loop does; every op rounds on its own (the build
// has -fmad=false; add/mul are __fadd_rn/__fmul_rn), expf is the accurate
// one (not __expf) and the division is IEEE, so the kernel equals the plain
// version ops/bilateral.py bilateral_plain bit for bit where PyTorch's CUDA
// exp is expf.
//
// Layout: one thread per output pixel in a 32 x 8 block.  The block stages
// its (32 + 2p) x (8 + 2p) window of u, v and cth in shared memory (35.9 KB
// at p = 18) and the (2p+1)^2 products gk[kc] * gk[lc] (5.5 KB).  The
// window's indices go through the reference's boundary map as it loads
// (oct_bc_cuda: -k -> k, n-1+k -> n-k), so no padded copy is made; the
// wrapper requires h, w >= p + 1, where one reflection is enough.  Threads
// past the grid's edge load a clamped window and write nothing.
//
// Left behind from the TPU kernel: the (BH, 128) lane tiles, the 8-row DMA
// chunks visited centre-chunk-first, the 384-wide roll chain, the host-side
// reflect pad and 128-column pad, and its row-outer accumulation order.
//
// Bound: FP32 issue.  ~20 single-rounded FP32 ops and one expf per tap,
// 1369 taps per pixel (~40 G taps at 5424^2); each input is read from
// device memory once per block window.  Sharing the cth differences between
// the pixels of a block (fewer expf) and packed math are later work.

#include "common.cuh"

namespace {

using octane::add;
using octane::mul;
using octane::sub;

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kMaxP = 48;
constexpr int kMaxTaps = 2 * kMaxP + 1;

struct Taps {
  float g[kMaxTaps];
};

// oct_bc_cuda's boundary map, then a clamp that only the windows of threads
// past the grid's edge reach
__device__ __forceinline__ int reflect(int x, int n) {
  if (x < 0) x = -x;
  if (x >= n) x = 2 * n - x - 1;
  return min(max(x, 0), n - 1);
}

__global__ void __launch_bounds__(kBX * kBY)
bilateral_kernel(const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ cth, float* __restrict__ out, int h, int w,
                 int p, float sigpix2, Taps taps) {
  extern __shared__ float smem[];
  const int n = 2 * p + 1;
  const int ww = kBX + 2 * p;
  const int win = ww * (kBY + 2 * p);
  float* su = smem;
  float* sv = su + win;
  float* sc = sv + win;
  float* swt = sc + win;  // swt[kc * n + lc] = gk[kc] * gk[lc]
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int row0 = blockIdx.y * kBY - p;
  const int col0 = blockIdx.x * kBX - p;
  for (int k = tid; k < win; k += kBX * kBY) {
    const int r = k / ww;
    const int c = k - r * ww;
    const size_t g = (size_t)reflect(row0 + r, h) * w + reflect(col0 + c, w);
    su[k] = u[g];
    sv[k] = v[g];
    sc[k] = cth[g];
  }
  for (int k = tid; k < n * n; k += kBX * kBY) {
    const int kc = k / n;
    swt[k] = mul(taps.g[kc], taps.g[k - kc * n]);
  }
  __syncthreads();

  const int row = blockIdx.y * kBY + threadIdx.y;
  const int col = blockIdx.x * kBX + threadIdx.x;
  if (row >= h || col >= w) return;
  const int base = threadIdx.y * ww + threadIdx.x;  // tap (kc, lc) = (0, 0)
  const float c0 = sc[base + p * ww + p];
  float au = 0.f, av = 0.f, a2 = 0.f;
  for (int kc = 0; kc < n; ++kc) {
    const float* wt = swt + kc * n;
    const int col_off = base + kc;
    for (int lc = 0; lc < n; ++lc) {
      const int o = col_off + lc * ww;
      const float dmc = sub(sc[o], c0);
      const float a1 = mul(wt[lc], expf(mul(mul(dmc, dmc), sigpix2)));
      au = add(au, mul(su[o], a1));
      av = add(av, mul(sv[o], a1));
      a2 = add(a2, a1);
    }
  }
  const size_t o = (size_t)row * w + col;
  out[o] = __fdiv_rn(au, a2);
  out[(size_t)h * w + o] = __fdiv_rn(av, a2);
}

}  // namespace

// out (2, h, w) = the smoothed (u, v); gk_host is the host array of the
// 2p+1 spatial taps (passed to the kernel by value).  Requires
// p + 1 <= h, w and p <= kMaxP (the wrapper checks both).
extern "C" int octane_bilateral(const float* u, const float* v, const float* cth,
                                float* out, const float* gk_host, int h, int w, int p,
                                float sigpix2, void* stream) {
  if (p < 0 || p > kMaxP) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int k = 0; k < 2 * p + 1; ++k) taps.g[k] = gk_host[k];
  const size_t bytes = sizeof(float) * (3 * (size_t)(kBX + 2 * p) * (kBY + 2 * p)
                                        + (size_t)(2 * p + 1) * (2 * p + 1));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bilateral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  bilateral_kernel<<<grid, block, bytes, (cudaStream_t)stream>>>(u, v, cth, out, h, w, p,
                                                                 sigpix2, taps);
  return (int)cudaGetLastError();
}
