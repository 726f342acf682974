// TrIM conv2d weight gradient for Hopper (sm_90a): the port of the Pallas
// kernel `_trim_conv2d_wgrad_kernel` (src/repro/kernels/trim_conv2d_vjp.py:92).
//
// What it computes, in fp32 on the CUDA cores (IEEE, no TF32):
//   dw[kh, kw, c, f] = sum_{n, ho, wo} x[n, ho*S - p + kh, wo*S - p + kw, c]
//                                      * g[n, ho, wo, f]
// over NHWC activations x (N,H,W,C) and the output cotangent g
// (N,H_O,W_O,F), giving dw (K,K,C,F).  Input pixels outside the image
// count as zero: the haloed window is zero-filled as it is loaded, so no
// padded copy of x exists.
//
// The TrIM dataflow of the Pallas body, kept:
// - A block owns one (Cb channels x Fb filters) tile of dw for all K*K
//   taps; its (K,K,Cb,Fb) accumulator lives in registers (each thread
//   holds NT taps x 4 filters of one channel) across the block's whole
//   share of the (image, output tile) reduction.
// - For each output tile, the haloed input window ((TH-1)*S+K) x
//   ((TW-1)*S+K) x Cb is loaded into shared memory once, beside the
//   resident cotangent tile (TH*TW x Fb), and read K*K times through
//   stride-S shifted views (one per tap).
// - Output rows or columns past H_O/W_O are never visited, so input rows
//   that no output reads (when (H+2p-K) % S > 0) contribute nothing.
//
// What the TPU did in order and Hopper cannot: the Pallas grid carries the
// dw scratch across the sequential batch/spatial axes.  Here the
// reduction over (image, output tile) items is cut into n_split ranges so
// that the card has enough blocks when dw has only a few tiles (VGG-16
// CL1 has one channel tile and two filter tiles).  Each range writes its
// fp32 partial dw to a workspace slab exactly once, and a second kernel
// sums the slabs in a fixed order: no atomics, so the result is the same
// on every run.  With n_split == 1 the block writes dw itself.
//
// What bounds it: like the forward conv, every VGG-16 layer does far more
// operations per byte than the H100's fp32 ridge (about 20 FLOP/byte), so
// the work is bound by operations.  Per pixel a thread issues one 16-byte
// shared load of the cotangent and NT scalar loads of the window for 4*NT
// FMAs; wgmma and register tiling over pixels are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 16;   // taps per thread (NT) compiled
constexpr int kFiltTile = 32;  // Fb must not exceed this

struct WgradArgs {
  const float* x;
  const float* g;
  float* out;  // dw (n_split == 1) or the workspace's n_split partial slabs
  int N, H, W, C, K, F, H_O, W_O, S, pad;
  int TH, TW, n_th, n_tw, Cb, Fb, G, n_f, n_split;
};

template <int NT>
__global__ void __launch_bounds__(kThreads)
trim_conv2d_wgrad_kernel(const WgradArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int K = a.K, S = a.S, KK = K * K, Cb = a.Cb, Fb = a.Fb;
  const int rows = (a.TH - 1) * S + K;
  const int cols = (a.TW - 1) * S + K;
  const int win = rows * cols;
  float* xs = smem;                               // [Cb][rows][cols]
  float* gs = smem + ((Cb * win + 3) & ~3);       // [TH*TW][Fb], 16B-aligned

  const int c0 = (blockIdx.x / a.n_f) * Cb;
  const int f0 = (blockIdx.x % a.n_f) * Fb;
  const int split = blockIdx.y;
  // Thread -> (tap group, channel, 4 filters).  L lanes cover Cb x Fb/4;
  // G groups of L threads split the K*K taps: group grp owns taps
  // grp, grp + G, ... (NT of them, the last ones possibly past K*K).
  const int fq = Fb / 4;
  const int L = Cb * fq;
  const int grp = threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const bool active = grp < a.G;
  const int cl = lane / fq;
  const int fl = (lane % fq) * 4;

  int toff[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int tap = grp + j * a.G;
    toff[j] = (active && tap < KK) ? (tap / K) * cols + tap % K : 0;
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const long long per_img = static_cast<long long>(a.n_th) * a.n_tw;
  const long long items = per_img * a.N;
  const long long i0 = items * split / a.n_split;
  const long long i1 = items * (split + 1) / a.n_split;
  for (long long it = i0; it < i1; ++it) {
    const int n = static_cast<int>(it / per_img);
    const int t = static_cast<int>(it % per_img);
    const int oh0 = (t / a.n_tw) * a.TH, ow0 = (t % a.n_tw) * a.TW;
    const int vh = min(a.TH, a.H_O - oh0), vw = min(a.TW, a.W_O - ow0);
    const int ih0 = oh0 * S - a.pad, iw0 = ow0 * S - a.pad;
    const float* x = a.x + static_cast<size_t>(n) * a.H * a.W * a.C;
    const float* g = a.g + static_cast<size_t>(n) * a.H_O * a.W_O * a.F;
    __syncthreads();  // the previous item's reads are done
    // Haloed input window, zero outside the image and past C.
    for (int i = threadIdx.x; i < Cb * win; i += kThreads) {
      const int c = i % Cb;
      const int rq = i / Cb;
      const int q = rq % cols, r = rq / cols;
      const int h = ih0 + r, w = iw0 + q, cc = c0 + c;
      float v = 0.f;
      if (h >= 0 && h < a.H && w >= 0 && w < a.W && cc < a.C)
        v = x[(static_cast<size_t>(h) * a.W + w) * a.C + cc];
      xs[c * win + r * cols + q] = v;
    }
    // Cotangent tile, zero past F (pixels past H_O/W_O are never read).
    for (int i = threadIdx.x; i < a.TH * a.TW * Fb; i += kThreads) {
      const int f = i % Fb;
      const int pix = i / Fb;
      const int lh = pix / a.TW, lw = pix % a.TW, ff = f0 + f;
      float v = 0.f;
      if (lh < vh && lw < vw && ff < a.F)
        v = g[(static_cast<size_t>(oh0 + lh) * a.W_O + ow0 + lw) * a.F + ff];
      gs[pix * Fb + f] = v;
    }
    __syncthreads();
    if (!active) continue;
    const float* xc = xs + cl * win;
    for (int lh = 0; lh < vh; ++lh) {
      for (int lw = 0; lw < vw; ++lw) {
        const float4 gv =
            *reinterpret_cast<const float4*>(gs + (lh * a.TW + lw) * Fb + fl);
        const float* xp = xc + lh * S * cols + lw * S;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float xv = xp[toff[j]];
          acc[j][0] = fmaf(xv, gv.x, acc[j][0]);
          acc[j][1] = fmaf(xv, gv.y, acc[j][1]);
          acc[j][2] = fmaf(xv, gv.z, acc[j][2]);
          acc[j][3] = fmaf(xv, gv.w, acc[j][3]);
        }
      }
    }
  }

  // One write per element: this range's partial (or dw itself).
  const int cc = c0 + cl;
  if (!active || cc >= a.C) return;
  float* out = a.out + static_cast<size_t>(split) * KK * a.C * a.F;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int tap = grp + j * a.G;
    if (tap >= KK) continue;
    const size_t base = (static_cast<size_t>(tap) * a.C + cc) * a.F + f0 + fl;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (fl + i < Fb && f0 + fl + i < a.F) out[base + i] = acc[j][i];
  }
}

// dw[i] = sum over the n_split slabs in slab order (fixed, no atomics).
__global__ void trim_conv2d_wgrad_reduce(const float* __restrict__ ws,
                                         float* __restrict__ dw, long long M,
                                         int n_split) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < M; i += stride) {
    float s = 0.f;
    for (int k = 0; k < n_split; ++k) s += ws[k * M + i];
    dw[i] = s;
  }
}

template <int NT>
int launch(const WgradArgs& a, int n_c, int smem_bytes, cudaStream_t stream) {
  auto* kern = trim_conv2d_wgrad_kernel<NT>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_c * a.n_f, a.n_split);
  kern<<<grid, kThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Limits the wrapper validates against.
int trim_conv2d_wgrad_max_taps() { return kMaxTaps; }
int trim_conv2d_wgrad_filt_tile() { return kFiltTile; }
int trim_conv2d_wgrad_threads() { return kThreads; }

const char* trim_conv2d_wgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (N,H,W,C) f32, g (N,H_O,W_O,F) f32 -> dw (K,K,C,F) f32.  With
// n_split > 1, ws holds n_split * K*K*C*F floats of scratch.  The caller
// (the Python wrapper) picks the geometry: TH x TW output tiles, Cb
// channels and Fb filters per block, G tap groups of NT taps per thread.
// Returns the first launch error's cudaError_t, or 0.
int trim_conv2d_wgrad_f32(const void* x, const void* g, void* dw, void* ws,
                          int N, int H, int W, int C, int K, int F, int H_O,
                          int W_O, int stride, int pad, int TH, int TW,
                          int Cb, int Fb, int G, int NT, int n_split,
                          int smem_bytes, void* stream) {
  if (NT < 1 || NT > kMaxTaps || Fb > kFiltTile || Fb % 4 != 0 ||
      Cb * (Fb / 4) * G > kThreads || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WgradArgs a;
  a.x = static_cast<const float*>(x);
  a.g = static_cast<const float*>(g);
  a.out = static_cast<float*>(n_split > 1 ? ws : dw);
  a.N = N; a.H = H; a.W = W; a.C = C; a.K = K; a.F = F;
  a.H_O = H_O; a.W_O = W_O; a.S = stride; a.pad = pad;
  a.TH = TH; a.TW = TW;
  a.n_th = (H_O + TH - 1) / TH;
  a.n_tw = (W_O + TW - 1) / TW;
  a.Cb = Cb; a.Fb = Fb; a.G = G;
  a.n_f = (F + Fb - 1) / Fb;
  a.n_split = n_split;
  const int n_c = (C + Cb - 1) / Cb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (NT) {
#define TRIM_WGRAD_CASE(n) \
  case n:                  \
    rc = launch<n>(a, n_c, smem_bytes, s); \
    break;
    TRIM_WGRAD_CASE(1) TRIM_WGRAD_CASE(2) TRIM_WGRAD_CASE(3)
    TRIM_WGRAD_CASE(4) TRIM_WGRAD_CASE(5) TRIM_WGRAD_CASE(6)
    TRIM_WGRAD_CASE(7) TRIM_WGRAD_CASE(8) TRIM_WGRAD_CASE(9)
    TRIM_WGRAD_CASE(10) TRIM_WGRAD_CASE(11) TRIM_WGRAD_CASE(12)
    TRIM_WGRAD_CASE(13) TRIM_WGRAD_CASE(14) TRIM_WGRAD_CASE(15)
    TRIM_WGRAD_CASE(16)
#undef TRIM_WGRAD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0 || n_split == 1) return rc;
  const long long M = static_cast<long long>(K) * K * C * F;
  const int blocks = static_cast<int>(
      (M + kThreads - 1) / kThreads < 4096 ? (M + kThreads - 1) / kThreads
                                           : 4096);
  trim_conv2d_wgrad_reduce<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), M, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
