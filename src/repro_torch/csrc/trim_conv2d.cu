// TrIM conv2d for Hopper (sm_90a): the port of the Pallas kernel
// `_trim_conv2d_kernel` (src/repro/kernels/trim_conv2d.py:283).
//
// What it computes: the strided direct convolution
//   out[n, ho, wo, f] = sum_{kh, kw, c} x[n, ho*S - p + kh, wo*S - p + kw, c]
//                                       * w[kh, kw, c, f]
// over NHWC activations and (K, K, C, F) weights, only at the H_O x W_O
// strided outputs, followed by the fused epilogue (bias -> ReLU -> either
// clip(acc >> shift, 0, 255) or the per-channel multiplier+shift requant
// clip((acc * m + 2^(s-1)) >> s, 0, 255)), written once.
//
// Two type lanes share one body: fp32 x fp32 -> fp32 accumulate (IEEE fp32
// on the CUDA cores, no TF32), and uint8 x int8 -> int32 accumulate with an
// int32 or uint8 (requantized) output.
//
// What the TPU kernel keeps out of device memory, and how this one does it:
// - Each block owns TH x TW outputs x Fb filters of one image. The channel
//   sum runs as a loop over chunks of Cb channels inside the block (the
//   Pallas kernel's sequential C_in grid axis and its VMEM scratch).
// - Per chunk, the haloed input window ((TH-1)*S+K) x ((TW-1)*S+K) x Cb is
//   copied into shared memory once, zero-filled outside the image (this is
//   the padding; no padded copy of x exists), next to the K x K x Cb x Fb
//   weight chunk. Every tap then reads the same resident window through a
//   stride-S shifted view: the paper's triangular input reuse, K*K reads of
//   one fetch. The overlapping window is loaded directly, so the TPU's
//   four-pass ll/lh/hl/hh halo assembly has no counterpart here.
// - Sums stay in registers (4 pixels x 4 filters per thread) and the
//   epilogue runs in registers; each output is written exactly once.
// - No split of the channel sum across blocks and no atomics: an image's
//   result never depends on the batch it was served in.
//
// What bounds it: every VGG-16 layer does 27-2300 operations per byte it
// must move, far above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s,
// about 20 FLOP/byte), so the work is bound by operations. This first
// version issues one shared-memory load per two FMAs per thread, so it is
// bound by shared-memory issue well before the fp32 peak; register tiling
// over more pixels, and tensor cores for the int8 lane, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 filter groups x 32 pixel groups
constexpr int kPixSlots = 128;      // TH * TW must not exceed this
constexpr int kPixPerThread = 4;    // pixel slots ty, ty+32, ty+64, ty+96
constexpr int kFiltPerThread = 4;   // filters tx*4 .. tx*4+3
constexpr int kFiltTile = 32;       // Fb must not exceed this

enum RequantKind { kRqNone = 0, kRqShift = 1, kRqMultShift = 2 };

struct ConvArgs {
  const void* x;
  const void* w;
  const void* bias;      // (F,) in the accumulator type, or null
  const int32_t* mult;   // (F,) for kRqMultShift
  const int32_t* shift;  // (F,) for kRqMultShift
  void* out;
  int N, H, W, C, K, F, H_O, W_O, S, pad;
  int TH, TW, Cb, Fb, n_tw;
  int relu, rq_kind, rq_shift;
};

template <typename TAcc, typename TOut>
__device__ __forceinline__ TOut finish(TAcc r, const ConvArgs& a, int f) {
  if (a.bias != nullptr) r += static_cast<const TAcc*>(a.bias)[f];
  if (a.relu) r = r > TAcc(0) ? r : TAcc(0);
  return static_cast<TOut>(r);
}

// Integer lanes: the requantizing epilogues, both with arithmetic shifts.
template <>
__device__ __forceinline__ uint8_t finish<int32_t, uint8_t>(
    int32_t r, const ConvArgs& a, int f) {
  if (a.bias != nullptr) r += static_cast<const int32_t*>(a.bias)[f];
  if (a.relu) r = r > 0 ? r : 0;
  long long q;
  if (a.rq_kind == kRqShift) {
    q = static_cast<long long>(r >> a.rq_shift);
  } else {
    const long long m = a.mult[f];
    const int s = a.shift[f];
    q = (static_cast<long long>(r) * m + (1LL << (s - 1))) >> s;
  }
  q = q < 0 ? 0 : (q > 255 ? 255 : q);
  return static_cast<uint8_t>(q);
}

template <typename TX, typename TW, typename TAcc, typename TOut>
__global__ void __launch_bounds__(kThreads)
trim_conv2d_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.K, S = a.S, C = a.C, Cb = a.Cb;
  const int rows = (a.TH - 1) * S + K;
  const int cols = (a.TW - 1) * S + K;
  const int win = rows * cols;
  TAcc* xs = reinterpret_cast<TAcc*>(smem_raw);  // [Cb][rows][cols]
  TAcc* ws = xs + Cb * win;                      // [Cb][K*K][kFiltTile]

  const int th = blockIdx.x / a.n_tw;
  const int tw = blockIdx.x % a.n_tw;
  const int oh0 = th * a.TH, ow0 = tw * a.TW;
  const int f0 = blockIdx.y * a.Fb;
  const int n = blockIdx.z;
  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;
  const int ih0 = oh0 * S - a.pad;
  const int iw0 = ow0 * S - a.pad;

  int poff[kPixPerThread];
  bool pval[kPixPerThread];
  int po[kPixPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    const int pix = ty + 32 * j;
    const int lh = pix / a.TW, lw = pix % a.TW;
    const bool slot = pix < a.TH * a.TW;
    pval[j] = slot && (oh0 + lh) < a.H_O && (ow0 + lw) < a.W_O;
    poff[j] = slot ? (lh * S) * cols + lw * S : 0;
    po[j] = pval[j] ? (oh0 + lh) * a.W_O + (ow0 + lw) : 0;
  }

  TAcc acc[kPixPerThread][kFiltPerThread];
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j)
#pragma unroll
    for (int i = 0; i < kFiltPerThread; ++i) acc[j][i] = TAcc(0);

  const TX* x = static_cast<const TX*>(a.x) +
                static_cast<size_t>(n) * a.H * a.W * C;
  const TW* w = static_cast<const TW*>(a.w);
  const int KK = K * K;

  for (int c0 = 0; c0 < C; c0 += Cb) {
    __syncthreads();  // the previous chunk's reads are done
    // Haloed input window, zero outside the image and past C.
    for (int i = threadIdx.x; i < Cb * win; i += kThreads) {
      const int c = i % Cb;
      const int rq = i / Cb;
      const int q = rq % cols, r = rq / cols;
      const int h = ih0 + r, ww = iw0 + q, cc = c0 + c;
      TAcc v = TAcc(0);
      if (h >= 0 && h < a.H && ww >= 0 && ww < a.W && cc < C)
        v = static_cast<TAcc>(x[(static_cast<size_t>(h) * a.W + ww) * C + cc]);
      xs[c * win + r * cols + q] = v;
    }
    // Weight chunk, zero past C and past this block's filters.
    for (int i = threadIdx.x; i < Cb * KK * kFiltTile; i += kThreads) {
      const int fl = i % kFiltTile;
      const int rest = i / kFiltTile;
      const int c = rest % Cb, kk = rest / Cb;
      const int cc = c0 + c, ff = f0 + fl;
      TAcc v = TAcc(0);
      if (cc < C && fl < a.Fb && ff < a.F)
        v = static_cast<TAcc>(w[(static_cast<size_t>(kk) * C + cc) * a.F + ff]);
      ws[(c * KK + kk) * kFiltTile + fl] = v;
    }
    __syncthreads();

    const int cn = min(Cb, C - c0);
    for (int c = 0; c < cn; ++c) {
      const TAcc* xc = xs + c * win;
      const TAcc* wc = ws + c * KK * kFiltTile + tx * kFiltPerThread;
      for (int kh = 0; kh < K; ++kh) {
        for (int kw = 0; kw < K; ++kw) {
          const TAcc* wk = wc + (kh * K + kw) * kFiltTile;
          TAcc wv[kFiltPerThread];
#pragma unroll
          for (int i = 0; i < kFiltPerThread; ++i) wv[i] = wk[i];
          const int o = kh * cols + kw;
#pragma unroll
          for (int j = 0; j < kPixPerThread; ++j) {
            const TAcc xv = xc[poff[j] + o];
#pragma unroll
            for (int i = 0; i < kFiltPerThread; ++i) acc[j][i] += xv * wv[i];
          }
        }
      }
    }
  }

  TOut* out = static_cast<TOut*>(a.out);
#pragma unroll
  for (int j = 0; j < kPixPerThread; ++j) {
    if (!pval[j]) continue;
    const size_t base =
        (static_cast<size_t>(n) * a.H_O * a.W_O + po[j]) * a.F;
#pragma unroll
    for (int i = 0; i < kFiltPerThread; ++i) {
      const int fl = tx * kFiltPerThread + i;
      const int ff = f0 + fl;
      if (fl < a.Fb && ff < a.F)
        out[base + ff] = finish<TAcc, TOut>(acc[j][i], a, ff);
    }
  }
}

template <typename TX, typename TW, typename TAcc, typename TOut>
int launch(const ConvArgs& a, int smem_bytes, cudaStream_t stream) {
  auto* kern = trim_conv2d_kernel<TX, TW, TAcc, TOut>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_th = (a.H_O + a.TH - 1) / a.TH;
  const dim3 grid(n_th * a.n_tw, (a.F + a.Fb - 1) / a.Fb, a.N);
  kern<<<grid, kThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

ConvArgs make_args(const void* x, const void* w, const void* bias,
                   const void* mult, const void* shift, void* out, int N,
                   int H, int W, int C, int K, int F, int H_O, int W_O,
                   int stride, int pad, int TH, int TW, int Cb, int Fb,
                   int relu, int rq_kind, int rq_shift) {
  ConvArgs a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.mult = static_cast<const int32_t*>(mult);
  a.shift = static_cast<const int32_t*>(shift);
  a.out = out;
  a.N = N; a.H = H; a.W = W; a.C = C; a.K = K; a.F = F;
  a.H_O = H_O; a.W_O = W_O; a.S = stride; a.pad = pad;
  a.TH = TH; a.TW = TW; a.Cb = Cb; a.Fb = Fb;
  a.n_tw = (W_O + TW - 1) / TW;
  a.relu = relu; a.rq_kind = rq_kind; a.rq_shift = rq_shift;
  return a;
}

}  // namespace

extern "C" {

// Tile limits the wrapper validates against.
int trim_conv2d_pix_slots() { return kPixSlots; }
int trim_conv2d_filt_tile() { return kFiltTile; }

const char* trim_conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 lane: x (N,H,W,C) f32, w (K,K,C,F) f32, bias (F,) f32 or null,
// out (N,H_O,W_O,F) f32.  Returns the launch's cudaError_t.
int trim_conv2d_f32(const void* x, const void* w, const void* bias, void* out,
                    int N, int H, int W, int C, int K, int F, int H_O,
                    int W_O, int stride, int pad, int TH, int TW, int Cb,
                    int Fb, int relu, int smem_bytes, void* stream) {
  const ConvArgs a = make_args(x, w, bias, nullptr, nullptr, out, N, H, W, C,
                               K, F, H_O, W_O, stride, pad, TH, TW, Cb, Fb,
                               relu, kRqNone, 0);
  return launch<float, float, float, float>(
      a, smem_bytes, static_cast<cudaStream_t>(stream));
}

// uint8 x int8 lane: bias (F,) int32 or null.  rq_kind 0 writes int32
// psums; 1 (power-of-two shift rq_shift) and 2 (per-channel mult/shift
// (F,) int32 arrays) write uint8.
int trim_conv2d_u8s8(const void* x, const void* w, const void* bias,
                     const void* mult, const void* shift, void* out, int N,
                     int H, int W, int C, int K, int F, int H_O, int W_O,
                     int stride, int pad, int TH, int TW, int Cb, int Fb,
                     int relu, int rq_kind, int rq_shift, int smem_bytes,
                     void* stream) {
  const ConvArgs a = make_args(x, w, bias, mult, shift, out, N, H, W, C, K,
                               F, H_O, W_O, stride, pad, TH, TW, Cb, Fb,
                               relu, rq_kind, rq_shift);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rq_kind == kRqNone)
    return launch<uint8_t, int8_t, int32_t, int32_t>(a, smem_bytes, s);
  return launch<uint8_t, int8_t, int32_t, uint8_t>(a, smem_bytes, s);
}

}  // extern "C"
