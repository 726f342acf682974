// TrIM conv2d for Hopper (sm_90a): the port of the Pallas kernel
// `_trim_conv2d_kernel` (src/repro/kernels/trim_conv2d.py:283).
//
// What it computes: the strided direct convolution
//   out[n, ho, wo, f] = sum_{kh, kw, c} x[n, ho*S - p + kh, wo*S - p + kw, c]
//                                       * w[kh, kw, c, f]
// over NHWC activations and (K, K, C, F) weights, only at the H_O x W_O
// strided outputs, followed by the fused epilogue (bias -> ReLU -> either
// clip(acc >> shift, 0, 255) or the per-channel multiplier+shift requant
// clip((acc * m + 2^(s-1)) >> s, 0, 255)), written once.  Input pixels
// outside the image count as zero: the haloed window is zero-filled as it
// is loaded, so no padded copy of x exists.
//
// Two type lanes, two bodies:
//
// * fp32 x fp32 -> fp32 (IEEE fp32 FMAs on the CUDA cores, no TF32):
//   `trim_conv2d_f32_kernel`.  What bounds it: every VGG-16 layer does
//   27-2300 operations per byte it must move, far above the H100's fp32
//   ridge (67 TFLOP/s over 3.35 TB/s, about 20 FLOP/byte), so the work is
//   bound by fp32 operations, and the design keeps the FMA pipes fed from
//   registers:
//   - A block owns a TH x TW tile of output pixels (256 / TW rows of TW,
//     TW in {8, 16, 32, 64}) x 64 filters of one image: 256 threads, each
//     a run of 8 consecutive pixels of one row x 8 filters, 64
//     accumulators.  Lanes 0-7 of a quarter warp hold the same run and the
//     8 filter groups, so a window load is a broadcast and the 8 weight
//     quads of a tap are one 128-byte wavefront (the filter tile is kept
//     in shared memory as [half][group][4]: filters fg*8 + h*4 + j at
//     h*32 + fg*4 + j).
//   - The TrIM dataflow in registers (the paths K = 3 and K = 5 at stride
//     1: every VGG-16 conv and every dx of training): per (channel, kh) a
//     thread reads the 8 + K - 1 window values its run needs once (16-byte
//     loads of the channel plane's row) and uses them for all K taps kw,
//     the window sliding over the register array by kw; each tap's 8
//     weights are two 16-byte loads.  At K = 3 that is 9 shared loads for
//     192 FMAs.  Other K or S (AlexNet CL1, K = 11 at stride 4) take the
//     generic path: per (channel, kh, kw) 8 strided window values and the
//     tap's 8 weights, 10 loads for 64 FMAs.
//   - The channel sum runs over chunks of Cb channels (the Pallas kernel's
//     sequential C_in grid axis and its VMEM scratch) through a ring of 2
//     or 3 shared-memory stages filled by cp.async while earlier chunks
//     are consumed.  A stage holds the haloed window as Cb channel planes
//     [rows][RS] (RS the window's columns rounded up to a multiple of 4,
//     the plane padded to 4 mod 32 floats so that the 4-byte copies of
//     neighbouring channels land in different banks) and the weight chunk
//     [Cb][K*K][64].  The window comes in 4-byte copies (x holds channels
//     innermost, a plane holds columns innermost), the weights in 16-byte
//     copies where F % 4 == 0; the halo and anything past C or F are
//     zero-filled by a source size of 0.
//   - A fixed-order channel split for layers whose per-image tiles cannot
//     fill the card (VGG-16 CL5-CL13, 56^2 and below): the chunks are
//     cut into n_split contiguous ranges, none empty; each range's block
//     writes its fp32 partial to scratch exactly once, and
//     `trim_conv2d_f32_merge` adds the partials in split order, then bias
//     -> ReLU, and writes each output once.  No atomics on values.  The
//     geometry (tile, chunk, ranges) depends on the per-image shape alone,
//     never on N, so an output's sum runs in the same order in every batch
//     and every call: bucketed results equal unbatched ones bit for bit.
//
// * uint8 x int8 -> int32 (int32 or requantized uint8 out):
//   `trim_conv2d_kernel`, the first port's body.  Each block owns TH x TW
//   outputs x Fb filters; per chunk of Cb channels the haloed window and
//   the weight chunk are copied into shared memory once and every tap
//   reads the window through a stride-S shifted view; sums stay in
//   registers (4 pixels x 4 filters per thread).  It issues one shared
//   load per two multiply-adds and uses no tensor cores: its redesign is
//   later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- fp32 lane

constexpr int kF32Threads = 256;  // 32 runs x 8 filter groups
constexpr int kRun = 8;           // output pixels a thread owns on a row
constexpr int kGroups = 8;        // filter groups: threads sharing a run
constexpr int kF32Fb = 64;        // filters a block computes
constexpr int kMaxStages = 3;

// fp32 kernel paths (the wrapper's F32Tile.path): 0 the generic path, or
// the K (3 or 5) at stride 1 whose window slides in registers.
constexpr int kGeneric = 0;

struct F32Args {
  const float* x;
  const float* w;
  const float* bias;  // (F,) or null
  float* out;         // the output (n_split == 1) or the n_split partials
  int N, H, W, C, K, F, H_O, W_O, S, pad;
  int TH, TW, n_tw, n_f, Cb, n_chunks, n_split, stages;
  int rows, cols, RS, plane;  // the window: rows x cols in planes of
                              // ``plane`` floats, rows RS floats apart
  int stage_floats;           // Cb * plane + Cb * K * K * 64
  int vec_w, vec_out, relu;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most ``stages - 2`` groups are in flight: the oldest
// chunk of the ring has landed.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Issue the cp.async copies of chunk ``k`` (channels k*Cb ..) of image n's
// window at (ih0, iw0) and of filters f0 .. f0 + 63 into ``st``.  A
// thread's window copies are 256 apart; their (channel, column, row) is
// stepped by carries, not divided out for every copy.
__device__ __forceinline__ void load_chunk(const F32Args& a, float* st,
                                           const float* x, int ih0, int iw0,
                                           int k, int f0) {
  const int c0 = k * a.Cb;
  {
    const int total = a.Cb * a.rows * a.cols;
    const int pos = threadIdx.x / a.Cb, dpos = kF32Threads / a.Cb;
    const int dc = kF32Threads - dpos * a.Cb, dr = dpos / a.cols;
    const int dq = dpos - dr * a.cols;
    int c = threadIdx.x - pos * a.Cb, r = pos / a.cols, q = pos - r * a.cols;
    for (int i = threadIdx.x; i < total; i += kF32Threads) {
      const int h = ih0 + r, w = iw0 + q, cc = c0 + c;
      const bool ok = static_cast<unsigned>(h) < static_cast<unsigned>(a.H) &&
                      static_cast<unsigned>(w) < static_cast<unsigned>(a.W) &&
                      cc < a.C;
      const float* src =
          ok ? x + (static_cast<size_t>(h) * a.W + w) * a.C + cc : a.x;
      cp_async4(st + c * a.plane + r * a.RS + q, src, ok);
      c += dc;
      q += dq;
      r += dr;
      if (c >= a.Cb) { c -= a.Cb; ++q; }
      if (q >= a.cols) { q -= a.cols; ++r; }
    }
  }
  float* ws = st + a.Cb * a.plane;
  const int KK = a.K * a.K;
  if (a.vec_w) {
    // 16 quads a (channel, tap): quad j lands at j*4, filters
    // f0 + (j % 8)*8 + (j / 8)*4 .. + 3 (zero past C and F: F % 4 == 0)
    const int total = a.Cb * KK * 16;
    for (int i = threadIdx.x; i < total; i += kF32Threads) {
      const int j = i & 15, row = i >> 4;
      const int c = row / KK, kk = row - c * KK;
      const int f = f0 + (j & 7) * 8 + (j >> 3) * 4, cc = c0 + c;
      const bool ok = cc < a.C && f < a.F;
      const float* src =
          ok ? a.w + (static_cast<size_t>(kk) * a.C + cc) * a.F + f : a.w;
      cp_async16(ws + row * kF32Fb + j * 4, src, ok);
    }
  } else {
    const int total = a.Cb * KK * kF32Fb;
    for (int i = threadIdx.x; i < total; i += kF32Threads) {
      const int s = i & 63, row = i >> 6;
      const int c = row / KK, kk = row - c * KK;
      const int f = f0 + ((s & 31) >> 2) * 8 + (s >> 5) * 4 + (s & 3);
      const int cc = c0 + c;
      const bool ok = cc < a.C && f < a.F;
      const float* src =
          ok ? a.w + (static_cast<size_t>(kk) * a.C + cc) * a.F + f : a.w;
      cp_async4(ws + i, src, ok);
    }
  }
}

__device__ __forceinline__ void fma8(float (&acc)[8], float v,
                                     const float4& wa, const float4& wb) {
  acc[0] = fmaf(v, wa.x, acc[0]);
  acc[1] = fmaf(v, wa.y, acc[1]);
  acc[2] = fmaf(v, wa.z, acc[2]);
  acc[3] = fmaf(v, wa.w, acc[3]);
  acc[4] = fmaf(v, wb.x, acc[4]);
  acc[5] = fmaf(v, wb.y, acc[5]);
  acc[6] = fmaf(v, wb.z, acc[6]);
  acc[7] = fmaf(v, wb.w, acc[7]);
}

// One chunk of ``cn`` channels at stride 1 with K a compile-time constant:
// per (channel, kh) the run's 8 + K - 1 window values come in once
// (16-byte loads, then one 8-byte load for the rest) and serve all K taps.
// ``xr`` points at the thread's first window value of channel 0, ``wc`` at
// its filter group's first quad of channel 0.
template <int K>
__device__ __forceinline__ void chunk_slide(float (&acc)[kRun][8],
                                            const float* xr, const float* wc,
                                            int cn, int RS, int plane) {
  constexpr int NV = kRun + K - 1;
  constexpr int NV4 = NV / 4 * 4;
#pragma unroll 1
  for (int c = 0; c < cn; ++c) {
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const float* xp = xr + kh * RS;
      float xv[NV4 + 4];
#pragma unroll
      for (int q = 0; q < NV4; q += 4) {
        const float4 t = *reinterpret_cast<const float4*>(xp + q);
        xv[q] = t.x; xv[q + 1] = t.y; xv[q + 2] = t.z; xv[q + 3] = t.w;
      }
      if constexpr (NV - NV4 == 1) {
        xv[NV4] = xp[NV4];
      } else if constexpr (NV - NV4 >= 2) {
        const float2 t = *reinterpret_cast<const float2*>(xp + NV4);
        xv[NV4] = t.x; xv[NV4 + 1] = t.y;
        if constexpr (NV - NV4 == 3) xv[NV4 + 2] = xp[NV4 + 2];
      }
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const float* wk = wc + (kh * K + kw) * kF32Fb;
        const float4 wa = *reinterpret_cast<const float4*>(wk);
        const float4 wb = *reinterpret_cast<const float4*>(wk + 32);
#pragma unroll
        for (int p = 0; p < kRun; ++p) fma8(acc[p], xv[p + kw], wa, wb);
      }
    }
    xr += plane;
    wc += K * K * kF32Fb;
  }
}

// One chunk on the generic path (any K and S): per (channel, kh, kw) the
// run's 8 window values S apart and the tap's two weight quads.
__device__ __forceinline__ void chunk_generic(float (&acc)[kRun][8],
                                              const float* xr,
                                              const float* wc, int cn,
                                              const F32Args& a) {
  const int K = a.K, S = a.S;
#pragma unroll 1
  for (int c = 0; c < cn; ++c) {
#pragma unroll 1
    for (int kh = 0; kh < K; ++kh) {
#pragma unroll 1
      for (int kw = 0; kw < K; ++kw) {
        const float* xp = xr + kh * a.RS + kw;
        const float* wk = wc + (kh * K + kw) * kF32Fb;
        const float4 wa = *reinterpret_cast<const float4*>(wk);
        const float4 wb = *reinterpret_cast<const float4*>(wk + 32);
        float xv[kRun];
#pragma unroll
        for (int p = 0; p < kRun; ++p) xv[p] = xp[p * S];
#pragma unroll
        for (int p = 0; p < kRun; ++p) fma8(acc[p], xv[p], wa, wb);
      }
    }
    xr += a.plane;
    wc += K * K * kF32Fb;
  }
}

// The fp32 conv.  Grid: (spatial tiles, filter tiles x n_split, N).
// ``KS`` > 0: the stride-1 path with K == KS; 0: the generic path.
template <int KS>
__global__ void __launch_bounds__(kF32Threads, 2)
trim_conv2d_f32_kernel(const F32Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockIdx.x;
  const int th = tile / a.n_tw, tw = tile - th * a.n_tw;
  const int ft = blockIdx.y % a.n_f, split = blockIdx.y / a.n_f;
  const int n = blockIdx.z;
  const int oh0 = th * a.TH, ow0 = tw * a.TW, f0 = ft * kF32Fb;
  const int ih0 = oh0 * a.S - a.pad, iw0 = ow0 * a.S - a.pad;
  const int k0 = static_cast<int>(
      static_cast<long long>(a.n_chunks) * split / a.n_split);
  const int k1 = static_cast<int>(
      static_cast<long long>(a.n_chunks) * (split + 1) / a.n_split);

  const int fg = threadIdx.x & (kGroups - 1);
  const int run = threadIdx.x / kGroups;
  const int rpr = a.TW / kRun;  // runs a row
  const int rr = run / rpr, rc = run - rr * rpr;
  // the thread's first window value in a plane, its group's first quad in
  // a chunk's weights
  const int xoff = rr * a.S * a.RS + rc * kRun * a.S;
  const int woff = fg * 4;

  const float* x = a.x + static_cast<size_t>(n) * a.H * a.W * a.C;
  float acc[kRun][8];
#pragma unroll
  for (int p = 0; p < kRun; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  const int st = a.stages;
  for (int s = 0; s < st - 1; ++s) {
    if (k0 + s < k1)
      load_chunk(a, smem + s * a.stage_floats, x, ih0, iw0, k0 + s, f0);
    cp_async_commit();
  }
  for (int k = k0; k < k1; ++k) {
    cp_async_wait_ring(st);
    __syncthreads();  // chunk k is visible; chunk k - 1's stage is free
    const int nxt = k + st - 1;
    if (nxt < k1)
      load_chunk(a, smem + ((nxt - k0) % st) * a.stage_floats, x, ih0, iw0,
                 nxt, f0);
    cp_async_commit();
    const float* stg = smem + ((k - k0) % st) * a.stage_floats;
    const int cn = min(a.Cb, a.C - k * a.Cb);
    const float* xr = stg + xoff;
    const float* wc = stg + a.Cb * a.plane + woff;
    if constexpr (KS > 0)
      chunk_slide<KS>(acc, xr, wc, cn, a.RS, a.plane);
    else
      chunk_generic(acc, xr, wc, cn, a);
  }

  // One write per output: the result (bias -> ReLU) or this range's
  // partial.
  const bool final_write = a.n_split == 1;
  float* out = a.out + static_cast<size_t>(split) * a.N * a.H_O * a.W_O * a.F;
  const int ho = oh0 + rr;
  if (ho >= a.H_O) return;
  const int f = f0 + fg * 8;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bv[j] = (final_write && a.bias != nullptr && f + j < a.F) ? a.bias[f + j]
                                                              : 0.f;
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    const int wo = ow0 + rc * kRun + p;
    if (wo >= a.W_O) break;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = acc[p][j];
      if (final_write) {
        v[j] += bv[j];
        if (a.relu) v[j] = v[j] > 0.f ? v[j] : 0.f;
      }
    }
    float* dst =
        out + ((static_cast<size_t>(n) * a.H_O + ho) * a.W_O + wo) * a.F + f;
    if (a.vec_out) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (f + h * 4 < a.F)
          *reinterpret_cast<float4*>(dst + h * 4) =
              make_float4(v[h * 4], v[h * 4 + 1], v[h * 4 + 2], v[h * 4 + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (f + j < a.F) dst[j] = v[j];
    }
  }
}

// out[i] = epilogue(p_0[i] + p_1[i] + ... + p_{n_split-1}[i]), summed in
// split order; M outputs, F filters (the bias index is i % F).  ``vec``:
// M and F are multiples of 4 and four outputs go at once.
__global__ void __launch_bounds__(256)
trim_conv2d_f32_merge(const float* __restrict__ parts,
                      const float* __restrict__ bias,
                      float* __restrict__ out, long long M, int F,
                      int n_split, int relu, int vec) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  if (vec) {
    const long long M4 = M / 4;
    for (long long i = first; i < M4; i += step) {
      float4 s = reinterpret_cast<const float4*>(parts)[i];
      for (int k = 1; k < n_split; ++k) {
        const float4 t = reinterpret_cast<const float4*>(parts + k * M)[i];
        s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
      }
      float v[4] = {s.x, s.y, s.z, s.w};
      const int f = static_cast<int>((i * 4) % F);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (bias != nullptr) v[j] += bias[f + j];
        if (relu) v[j] = v[j] > 0.f ? v[j] : 0.f;
      }
      reinterpret_cast<float4*>(out)[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (long long i = first; i < M; i += step) {
      float s = parts[i];
      for (int k = 1; k < n_split; ++k) s += parts[k * M + i];
      if (bias != nullptr) s += bias[i % F];
      if (relu) s = s > 0.f ? s : 0.f;
      out[i] = s;
    }
  }
}

// Raise a kernel's dynamic shared memory to ``bytes`` once (the attribute
// call costs host time on every launch otherwise), with the carveout at
// its most shared memory so that two blocks fit an SM.
int raise_smem(const void* kern, int& smem_set, int bytes) {
  if (bytes <= smem_set) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  smem_set = bytes;
  return 0;
}

// ------------------------------------------------------------ integer lane

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
int launch_int(const ConvArgs& a, int smem_bytes, cudaStream_t stream) {
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

}  // namespace

extern "C" {

// Tile limits the wrapper validates against.
int trim_conv2d_pix_slots() { return kPixSlots; }
int trim_conv2d_filt_tile() { return kFiltTile; }
int trim_conv2d_f32_threads() { return kF32Threads; }
int trim_conv2d_f32_filters() { return kF32Fb; }

const char* trim_conv2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// fp32 lane: x (N,H,W,C) f32, w (K,K,C,F) f32, bias (F,) f32 or null,
// out (N,H_O,W_O,F) f32; with n_split > 1, ``parts`` holds n_split *
// N*H_O*W_O*F floats of scratch.  The caller (the Python wrapper's
// planner) picks the geometry: the path (0 generic, 3 or 5: that K at
// stride 1), the TH x TW output tile (TW in {8, 16, 32, 64}, TH * TW ==
// 256), Cb channels a chunk, n_split ranges of chunks, 2 or 3 stages, the
// window's row stride RS and plane floats, and the shared memory, which
// must equal what the kernel computes.  ``vec_w``: 16-byte weight copies
// (F % 4 == 0, w 16-byte aligned).  Returns the first launch error's
// cudaError_t, or 0.
int trim_conv2d_f32(const void* x, const void* w, const void* bias, void* out,
                    void* parts, int N, int H, int W, int C, int K, int F,
                    int H_O, int W_O, int stride, int pad, int path, int TH,
                    int TW, int Cb, int n_split, int stages, int RS,
                    int plane, int vec_w, int relu, int smem_bytes,
                    void* stream) {
  F32Args a;
  a.rows = (TH - 1) * stride + K;
  a.cols = (TW - 1) * stride + K;
  const int n_chunks = (C + Cb - 1) / Cb;
  if ((path != kGeneric && (path != K || stride != 1 || (K != 3 && K != 5)))
      || TW % kRun != 0 || TH * TW != kRun * kF32Threads / kGroups ||
      Cb < 1 || stages < 2 || stages > kMaxStages || n_split < 1 ||
      n_split > n_chunks || RS % 4 != 0 || plane % 4 != 0 ||
      RS < a.cols || plane < a.rows * RS || (vec_w && F % 4 != 0) ||
      (n_split > 1 && parts == nullptr) || stride < 1 || K < 1 ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(n_split > 1 ? parts : out);
  a.N = N; a.H = H; a.W = W; a.C = C; a.K = K; a.F = F;
  a.H_O = H_O; a.W_O = W_O; a.S = stride; a.pad = pad;
  a.TH = TH; a.TW = TW;
  a.n_tw = (W_O + TW - 1) / TW;
  a.n_f = (F + kF32Fb - 1) / kF32Fb;
  a.Cb = Cb; a.n_chunks = n_chunks; a.n_split = n_split; a.stages = stages;
  a.RS = RS; a.plane = plane;
  a.stage_floats = Cb * plane + Cb * K * K * kF32Fb;
  a.vec_w = vec_w; a.vec_out = F % 4 == 0; a.relu = relu;
  if (smem_bytes != stages * a.stage_floats * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_th = (H_O + TH - 1) / TH;
  if (static_cast<long long>(a.n_f) * n_split > 65535 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_th * a.n_tw, a.n_f * n_split, N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int smem_set[3] = {0, 0, 0};  // per path: what has been raised
  void (*kern)(F32Args) = path == 3   ? &trim_conv2d_f32_kernel<3>
                          : path == 5 ? &trim_conv2d_f32_kernel<5>
                                      : &trim_conv2d_f32_kernel<0>;
  const int slot = path == 3 ? 1 : path == 5 ? 2 : 0;
  int rc = raise_smem(reinterpret_cast<const void*>(kern), smem_set[slot],
                      smem_bytes);
  if (rc != 0) return rc;
  kern<<<grid, kF32Threads, smem_bytes, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_split == 1) return rc;
  const long long M = static_cast<long long>(N) * H_O * W_O * F;
  const int vec = F % 4 == 0;
  const long long items = vec ? M / 4 : M;
  const int blocks =
      static_cast<int>((items + 255) / 256 < 4224 ? (items + 255) / 256 : 4224);
  trim_conv2d_f32_merge<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(parts), static_cast<const float*>(bias),
      static_cast<float*>(out), M, F, n_split, relu, vec);
  return static_cast<int>(cudaGetLastError());
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rq_kind == kRqNone)
    return launch_int<uint8_t, int8_t, int32_t, int32_t>(a, smem_bytes, s);
  return launch_int<uint8_t, int8_t, int32_t, uint8_t>(a, smem_bytes, s);
}

}  // extern "C"
