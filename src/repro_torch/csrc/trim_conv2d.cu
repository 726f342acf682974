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
// Three type lanes:
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
// * uint8 x int8 -> int32 (int32 or requantized uint8 out): an implicit
//   GEMM on the tensor cores, mma.sync m16n8k32 u8 x s8 -> s32 (exact
//   int32 sums).  What bounds it: per byte it must move (x, w and the
//   uint8 output once each) a VGG-16 conv does 745-1,683 operations at
//   batch 1 on CL3-CL10 and 765-3,368 at batch 8 on CL3-CL13, above the
//   H100's int8 ridge (1,979 TOP/s over 3.35 TB/s, about 590): there the
//   tensor-core rate bounds it.  CL1 (52: C = 3), CL2 (about 575) and, at
//   batch 1, CL11-CL13 (361: 2.4 MB of weights for 196 pixels) sit at or
//   below the ridge, where the bytes, the launch and the fill of 132 SMs
//   decide.  The design:
//   - The block owns output pixels of one image x 64 filters, 8 warps of
//     32 filters each; the depth runs in steps of 32 bytes, one mma
//     k-step; sums stay in registers and each output is written once.
//   - The weights w (K, K, C, F) are a (K*K*C) x F matrix whose k is not
//     contiguous, and both mma operands want k contiguous
//     (ldmatrix.trans moves 16-bit elements only), so a pre-pass,
//     `trim_conv2d_u8s8_wprep`, writes them as rows of 32-byte k-steps:
//     [tap][filter][channel] (window paths) or [filter][K*K*C] (gather
//     path).  It runs once per weight tensor: the wrapper keeps the
//     result for the tensor's later calls (serving weights are static),
//     so a call launches it only when the weights are new or have
//     changed.  The conv copies a step's 64 rows
//     straight into its ring stage, swizzled so that every ldmatrix phase
//     is free of bank conflicts.
//   - The window path (any K and S, C > 8): 128 pixels a block (a TH x TW
//     tile), each warp 32 pixels x 32 filters.  The depth runs over (32-
//     channel chunk, kh, kw); a ring stage holds the chunk's haloed window
//     as uint8 [rows][cols][32 channels] (channels innermost, as in x)
//     and every tap reads the one window through a shifted, strided view:
//     the A fragment's 16 row addresses for tap (kh, kw) are the window
//     pixels (r*S + kh, c*S + kw) of its 16 output pixels.  No im2col
//     copy exists.  The two 16-byte halves of a pixel swap places on every
//     fourth pixel, so the 8 rows of an ldmatrix phase at S = 1 hit 8
//     bank groups.
//   - The slide path (K = 3, S = 1, where its tiles fill the card): the
//     TrIM input movement in registers.  256 pixels a block (16 x 16);
//     warp (wm, wn) owns output rows 4 wm .. 4 wm + 3 x 32 filters.
//     Output row r at tap (kh, kw) reads window row r + kh, so per kw the
//     warp loads its 6 window rows once each and multiplies each by up to
//     3 taps' weights: 0.25 ldmatrix a mma where the window path needs
//     0.5, which bounds it by shared-memory bandwidth.
//   - The gather path (C <= 8: VGG-16 CL1, AlexNet CL1): a 32-channel
//     chunk would be mostly zeros, so the block keeps its whole haloed
//     window (all C channels) and gathers, per chunk of up to 4 steps, its
//     pixels' im2col rows ((kh, kw, c) order, zero past K*K*C) from it;
//     the depth is K*K*C rounded up to 32 bytes.  Built for 3 blocks an
//     SM: VGG-16 CL1's 392 tiles at batch 1 then run in one wave.
//   - A 2- or 3-stage cp.async ring over the chunks, one barrier a chunk
//     (two on the gather path); the halo and anything past C are zero-
//     filled by a source size of 0.
//   - Integer sums are exact in any order, so where the window path's
//     tiles cannot fill the card (batch 1, VGG-16 CL5-CL13) its chunks
//     are cut into n_split ranges; each range's block writes int32
//     partials once and `trim_conv2d_u8s8_merge` adds them and runs the
//     epilogue.  Unsplit, the epilogue (bias -> ReLU -> requant) runs on
//     the registers and a lane's two adjacent outputs go out in one
//     store.  The bits equal the plain version's on every path, at any
//     split and any batch.
//
// * bfloat16 x bfloat16 -> bfloat16 (fp32 accumulation, the epilogue in
//   fp32, one rounding to bf16 at the end: what `trim_conv2d_pallas`
//   returns for bf16 operands).  What bounds it: at half the int8 rate
//   (989 TFLOP/s dense) the ridge is about 295 FLOP/byte, which every
//   VGG-16 conv but CL1 passes at batch 8, so the tensor-core rate.  Two
//   paths:
//   - The window path on Hopper's wgmma and TMA (C > 8 and C, F
//     multiples of 8, the tensor maps' 16-byte strides):
//     `trim_conv2d_bf16_wgmma_kernel`, its own section further down.  A
//     block owns up to 128 output pixels of one image (two consumer
//     warpgroups of 64) x 64 or 128 filters and a producer warp; per
//     64-channel chunk one TMA copy brings the haloed window (the zero
//     fill outside the image is the padding), read by all K*K taps
//     through shifted views: ldmatrix puts each tap's A fragments in
//     registers and wgmma reads the tap's weights, streamed by TMA
//     through a ring of their own, from shared memory.  Where one image's
//     tiles cannot fill the card (VGG-16 CL5-CL13 at batch 1), the chunks
//     are cut over a cluster of up to 8 blocks that sum their fp32 sums
//     in rank order through distributed shared memory: no partial slab,
//     no merge launch.
//   - The gather path (C <= 8, or C or F not a multiple of 8: VGG-16
//     CL1, AlexNet CL1): the integer lane's `tc_conv` on mma.sync
//     m16n8k16 bf16 -> fp32 (`trim_conv2d_bf16_kernel`), its im2col rows
//     gathered from the whole window; the weights need no pre-pass
//     (ldmatrix.trans reads w's rows as they lie).  A split's fp32
//     partials are merged in split order (`trim_conv2d_bf16_merge`).
//   fp32 sums are not exact in every order, so the geometry (path, tile,
//   filters a block, split) comes from the per-image shape alone, as on
//   the fp32 lane: a batch of 8 equals 8 calls of one image bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

constexpr int kU8Threads = 256;  // 8 warps: 4 (pixels) x 2 (filters)
constexpr int kU8M = 128;        // output pixels a block (slide path: 256)
constexpr int kU8Fb = 64;        // filters a block
constexpr int kU8Step = 32;      // depth bytes a step (m16n8k32)
constexpr int kU8StepB = kU8Fb * kU8Step;  // one step's weights: 2048 B
constexpr int kU8AStepB = kU8M * kU8Step;  // one step's gathered A: 4096 B
constexpr int kU8MaxDepth = 65793;         // K*K*C: 255 * 128 * it < 2^31

// Integer kernel paths (the wrapper's U8Tile.path).
constexpr int kU8Window = 0;  // ldmatrix reads the window's shifted views
constexpr int kU8Gather = 1;  // C <= 8: im2col rows gathered from it
constexpr int kU8Slide = 2;   // K = 3, S = 1: window rows reused in registers
constexpr int kU8SlideT = 16; // the slide path's output tile: 16 x 16

enum RequantKind { kRqNone = 0, kRqShift = 1, kRqMultShift = 2 };

struct U8Epilogue {
  const int32_t* bias;   // (F,) or null
  const int32_t* mult;   // (F,) for kRqMultShift
  const int32_t* shift;  // (F,) for kRqMultShift
  int relu, rq_kind, rq_shift;
};

struct U8Args {
  const uint8_t* x;
  const int8_t* w;   // (K, K, C, F)
  const int8_t* wt;  // w transposed by trim_conv2d_u8s8_wprep: [G][Fp][L]
  void* out;         // (N, H_O, W_O, F): int32 or uint8
  int32_t* parts;    // n_split > 1: n_split x (N, H_O, W_O, F) int32
  U8Epilogue e;
  int N, H, W, C, K, F, H_O, W_O, S, pad;
  int TH, TW, n_tw, n_f;
  int rows, cols;    // the haloed window of one tile
  int steps;         // k32 steps an item (window: taps of a group)
  int n_tg;          // window path: tap groups a channel chunk
  int n_items, n_split, stages;
  int depth;         // K * K * C
  int Fp, L;         // wt: filters padded to 64, bytes a row
  int win_bytes;     // window: in every stage; gather: once, before the ring
  int stage_bytes;   // one ring stage
  int vec_x;         // 16-byte copies of x's channels
};

// bias -> ReLU, then (uint8 out) a power-of-two shift or the per-channel
// multiplier+shift requant, both arithmetic, clipped to [0, 255].
template <typename TOut>
__device__ __forceinline__ TOut u8_finish(int32_t r, const U8Epilogue& e,
                                          int f);

template <>
__device__ __forceinline__ int32_t u8_finish<int32_t>(int32_t r,
                                                      const U8Epilogue& e,
                                                      int f) {
  if (e.bias != nullptr) r += e.bias[f];
  if (e.relu) r = r > 0 ? r : 0;
  return r;
}

template <>
__device__ __forceinline__ uint8_t u8_finish<uint8_t>(int32_t r,
                                                      const U8Epilogue& e,
                                                      int f) {
  if (e.bias != nullptr) r += e.bias[f];
  if (e.relu) r = r > 0 ? r : 0;
  long long q;
  if (e.rq_kind == kRqShift) {
    q = static_cast<long long>(r >> e.rq_shift);
  } else {
    const long long m = e.mult[f];
    const int s = e.shift[f];
    q = (static_cast<long long>(r) * m + (1LL << (s - 1))) >> s;
  }
  q = q < 0 ? 0 : (q > 255 ? 255 : q);
  return static_cast<uint8_t>(q);
}

// Byte offset of 16-byte half h of row ``pix`` in a [rows][32 bytes]
// array (the window's pixels, the gathered A rows): the halves swap on
// every fourth row, so 8 consecutive rows land in 8 bank groups.
__device__ __forceinline__ int u8_row_off(int pix, int h) {
  return pix * 32 + ((h ^ ((pix >> 2) & 1)) << 4);
}

// Byte offset of 16-byte half u of filter row f in one step's weights
// [64 filters][32 bytes]: slot (2f + u) XOR h(f), h(f) the bits (f>>2)&1,
// (f>>2)&1, (f>>3)&1.  Rows f and f + 4 then differ in the slot's bank
// group, so an ldmatrix phase (8 rows, one half) is conflict-free.
__device__ __forceinline__ int u8_wt_off(int f, int u) {
  const int fb = f >> 2;
  const int hsw = (fb & 1) * 3 | ((fb & 2) << 1);
  return ((2 * f + u) ^ hsw) << 4;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x32 u8, row) * b (32x8 s8, col), exact int32 sums.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// w (K, K, C, F) -> wt [G][Fp][L]: row (g, f) holds w's rows g * Cin ..
// g * Cin + Cin - 1 at filter f, zero past Cin and F (window path: G =
// K*K taps, Cin = C, L = C rounded up to 32; gather path: G = 1, Cin =
// K*K*C, L its chunks' bytes).  One thread writes 16 bytes of a row;
// neighbouring threads take neighbouring filters, so w's rows are read
// 32 bytes a warp at a time.
__global__ void __launch_bounds__(256)
trim_conv2d_u8s8_wprep(const int8_t* __restrict__ w,
                       int8_t* __restrict__ wt, int G, int Cin, int F,
                       int Fp, int L) {
  const int units = L / 16;
  const long long total = static_cast<long long>(G) * Fp * units;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int f = static_cast<int>(i % Fp);
    const long long rest = i / Fp;
    const int u = static_cast<int>(rest % units);
    const int g = static_cast<int>(rest / units);
    const int l0 = u * 16;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (f < F) {
      const int8_t* src = w + (static_cast<long long>(g) * Cin + l0) * F + f;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (l0 + b < Cin)
          v[b >> 2] |= static_cast<uint32_t>(
                           static_cast<uint8_t>(src[b * F])) << (8 * (b & 3));
    }
    *reinterpret_cast<uint4*>(wt + (static_cast<long long>(g) * Fp + f) * L +
                              l0) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Issue the copies of item ``it`` into ring stage ``st``: on the window
// path the haloed window of its channel chunk and the weights of its tap
// group, on the gather path the weights of its depth chunk.  Step j's
// weights are the 32 bytes of wt's rows (g, f0 .. f0 + 63) from byte l0:
// (tap0 + j, c0) on the window path, (0, (it * steps + j) * 32) on the
// gather path, laid out [64 filters][32 bytes] by u8_wt_off.  A thread's
// weight copies are two steps apart: filter (tid >> 1) & 63, half tid &
// 1, steps (tid >> 7) + 2 t.
template <int kPath>
__device__ __forceinline__ void u8_load_item(const U8Args& a,
                                             unsigned char* st,
                                             const uint8_t* x, int ih0,
                                             int iw0, int it, int f0) {
  const int u = threadIdx.x & 1, fl = (threadIdx.x >> 1) & 63;
  const int j0 = threadIdx.x >> 7;
  unsigned char* dst = st + j0 * kU8StepB + u8_wt_off(fl, u);
  const int8_t* src;
  long long dsrc;  // source step between a thread's copies
  int jmax = a.steps;
  if (kPath == kU8Window) {
    const int cc = it / a.n_tg, tg = it - cc * a.n_tg;
    const int c0 = cc * kU8Step, tap0 = tg * a.steps;
    jmax = min(a.steps, a.K * a.K - tap0);
    src = a.wt + (static_cast<long long>(tap0 + j0) * a.Fp + f0 + fl) * a.L +
          c0 + u * 16;
    dsrc = 2LL * a.Fp * a.L;
    // the window: [rows * cols pixels][32 channels]
    const int total = a.rows * a.cols * 2;
    for (int i = threadIdx.x; i < total; i += kU8Threads) {
      const int pix = i >> 1, h = i & 1;
      const int wr = pix / a.cols, q = pix - wr * a.cols;
      const int gh = ih0 + wr, gw = iw0 + q, c = c0 + h * 16;
      const bool in = static_cast<unsigned>(gh) < static_cast<unsigned>(a.H) &&
                      static_cast<unsigned>(gw) < static_cast<unsigned>(a.W);
      const size_t off = (static_cast<size_t>(gh) * a.W + gw) * a.C;
      unsigned char* wd = st + u8_row_off(pix, h);
      if (a.vec_x) {
        const bool ok = in && c < a.C;
        cp_async16(wd, ok ? x + off + c : a.x, ok);
      } else {
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int b = 0; b < 16; ++b)
          if (in && c + b < a.C)
            v[b >> 2] |= static_cast<uint32_t>(x[off + c + b]) << (8 * (b & 3));
        *reinterpret_cast<uint4*>(wd) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    dst += a.win_bytes;
  } else {
    src = a.wt + static_cast<long long>(f0 + fl) * a.L +
          (it * a.steps + j0) * kU8Step + u * 16;
    dsrc = 2 * kU8Step;
  }
  for (int j = j0; j < jmax; j += 2) {
    cp_async16(dst, src, true);
    src += dsrc;
    dst += 2 * kU8StepB;
  }
}

// The gather path: the im2col rows of depth chunk ``it`` of the block's
// 128 pixels, from the window [rows][cols * C] of T (uint8 or bf16 bits)
// into [steps][128][32 bytes] (rows of u8_row_off).  A 16-byte half holds
// 16 / sizeof(T) depth values, a step twice that.  Depth d is (kh, kw, c)
// = (d / (K*C), (d / C) % K, d % C); within a row kh the K*C values (kw,
// c) are contiguous in the window, from column c*S of the pixel; zero past
// K*K*C.
template <typename T, typename A>
__device__ __forceinline__ void tc_gather(const A& a, const T* win,
                                          unsigned char* at, int it) {
  constexpr int kE = 16 / sizeof(T), kPer = 4 / sizeof(T);
  const int KC = a.K * a.C, RB = a.cols * a.C;
  const int npix = a.TH * a.TW;
  for (int i = threadIdx.x; i < a.steps * kU8M * 2; i += kU8Threads) {
    const int j = i >> 8, m = (i >> 1) & (kU8M - 1), h = i & 1;
    const int mm = m < npix ? m : 0;
    const int lh = mm / a.TW, lw = mm - lh * a.TW;
    const T* base = win + lh * a.S * RB + lw * a.S * a.C;
    int d = (it * a.steps + j) * 2 * kE + h * kE;
    int kh = d / KC, rem = d - kh * KC;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < kE; ++b) {
      if (d + b < a.depth)
        v[b / kPer] |= static_cast<uint32_t>(base[kh * RB + rem])
                       << (8 * sizeof(T) * (b % kPer));
      if (++rem == KC) { rem = 0; ++kh; }
    }
    *reinterpret_cast<uint4*>(at + j * kU8AStepB + u8_row_off(m, h)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// One k32 step of a warp: A rows from ``a0``/``a1`` (the shared
// addresses of its two m16 tiles' rows for this lane), B from the
// transposed weights at ``b`` (+ the lane's two x4 offsets).
__device__ __forceinline__ void u8_step(int (&acc)[2][4][4], uint32_t a0,
                                        uint32_t a1, uint32_t b,
                                        const int (&boff)[2]) {
  uint32_t af[2][4], bf[2][4];
  ldsm_x4(af[0], a0);
  ldsm_x4(af[1], a1);
  ldsm_x4(bf[0], b + boff[0]);
  ldsm_x4(bf[1], b + boff[1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_u8s8(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
               bf[nt >> 1][(nt & 1) * 2 + 1]);
}

// The lane's A row address for window pixel ``pix``, half ``hl``:
// u8_row_off(pix, hl) from the stage's shared address.
__device__ __forceinline__ uint32_t u8_a_addr(uint32_t base, int pix,
                                              int hl) {
  return base + ((pix << 5) ^ (hl << 4) ^ ((pix & 4) << 2));
}

// The pair of outputs (f, f + 1) of pixel ``pix`` (flat over N*H_O*W_O)
// that a lane's accumulators v0, v1 hold: the results (epilogue on the
// registers) or this range's int32 partials, in one store where both
// filters exist and F is even (the pair then lies aligned).
template <typename TOut>
__device__ __forceinline__ void u8_put2(const U8Args& a, int split,
                                        size_t pix, int f, int v0, int v1) {
  if (f >= a.F) return;
  const bool pair = f + 1 < a.F && (a.F & 1) == 0;
  if (a.n_split == 1) {
    TOut* o = static_cast<TOut*>(a.out) + pix * a.F + f;
    const TOut r0 = u8_finish<TOut>(v0, a.e, f);
    if (pair) {
      const TOut r1 = u8_finish<TOut>(v1, a.e, f + 1);
      if constexpr (sizeof(TOut) == 1)
        *reinterpret_cast<uint16_t*>(o) =
            static_cast<uint16_t>(r0 | (static_cast<uint16_t>(r1) << 8));
      else
        *reinterpret_cast<int2*>(o) = make_int2(r0, r1);
    } else {
      o[0] = r0;
      if (f + 1 < a.F) o[1] = u8_finish<TOut>(v1, a.e, f + 1);
    }
  } else {
    int32_t* o = a.parts +
                 (static_cast<size_t>(split) * a.N * a.H_O * a.W_O + pix) *
                     a.F + f;
    if (pair) {
      *reinterpret_cast<int2*>(o) = make_int2(v0, v1);
    } else {
      o[0] = v0;
      if (f + 1 < a.F) o[1] = v1;
    }
  }
}

// The tensor-core lanes' conv on the window and gather paths, the body of
// trim_conv2d_u8s8_kernel and (gather path) trim_conv2d_bf16_kernel.  ``L`` is the lane
// (U8Lane, Bf16Lane): its arguments, element and accumulator types, its
// copies of an item, its B offsets, its k-step and its stores.  Grid:
// (spatial tiles, filter tiles x n_split, N).
template <class L, int kPath>
__device__ __forceinline__ void tc_conv(const typename L::Args& a) {
  extern __shared__ __align__(128) unsigned char smem_u8[];
  const int tile = blockIdx.x;
  const int th = tile / a.n_tw, tw = tile - th * a.n_tw;
  const int ft = blockIdx.y % a.n_f, split = blockIdx.y / a.n_f;
  const int n = blockIdx.z;
  const int oh0 = th * a.TH, ow0 = tw * a.TW, f0 = ft * kU8Fb;
  const int ih0 = oh0 * a.S - a.pad, iw0 = ow0 * a.S - a.pad;
  const int k0 = static_cast<int>(
      static_cast<long long>(a.n_items) * split / a.n_split);
  const int k1 = static_cast<int>(
      static_cast<long long>(a.n_items) * (split + 1) / a.n_split);
  const int npix = a.TH * a.TW;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const auto* x = a.x + static_cast<size_t>(n) * a.H * a.W * a.C;

  // shared memory: gather path [window][ring (weights a stage)][A rows];
  // window path [ring (window + weights a stage)]
  unsigned char* win = smem_u8;
  unsigned char* ring = kPath == kU8Gather ? smem_u8 + a.win_bytes : smem_u8;
  unsigned char* at = ring + a.stages * a.stage_bytes;
  const int wstage = kPath == kU8Window ? a.win_bytes : 0;

  // A rows: lane l feeds row l & 15 of each of the warp's two m16 tiles,
  // half l >> 4.  Window path: the row's window pixel at tap (0, 0);
  // gather path: the row itself.  Rows past the tile read pixel 0.
  const int hl = lane >> 4;
  int arow[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = wm + mt * 16 + (lane & 15);
    if (kPath == kU8Window) {
      const int mm = m < npix ? m : 0;
      const int lh = mm / a.TW, lw = mm - lh * a.TW;
      arow[mt] = lh * a.S * a.cols + lw * a.S;
    } else {
      arow[mt] = m;
    }
  }
  // B: the lane's offsets of its two ldmatrix x4 loads a k-step
  int boff[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) boff[p] = L::boff(wn, lane, p);

  typename L::Acc acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  if (kPath == kU8Gather) {
    // the whole haloed window, all C channels: [rows][cols * C]
    using R = typename L::Raw;
    R* wr = reinterpret_cast<R*>(win);
    const R* xr = reinterpret_cast<const R*>(x);
    const int RB = a.cols * a.C, total = a.rows * RB;
    for (int i = threadIdx.x; i < total; i += kU8Threads) {
      const int r = i / RB, q = i - r * RB;
      const int pc = q / a.C, c = q - pc * a.C;
      const int gh = ih0 + r, gw = iw0 + pc;
      const bool ok = static_cast<unsigned>(gh) < static_cast<unsigned>(a.H) &&
                      static_cast<unsigned>(gw) < static_cast<unsigned>(a.W);
      wr[i] = ok ? xr[(static_cast<size_t>(gh) * a.W + gw) * a.C + c] : R(0);
    }
  }

  const int nst = a.stages;
  for (int s = 0; s < nst - 1; ++s) {
    if (k0 + s < k1)
      L::template load<kPath>(a, ring + s * a.stage_bytes, x, ih0, iw0,
                              k0 + s, f0);
    cp_async_commit();
  }
  for (int k = k0; k < k1; ++k) {
    cp_async_wait_ring(nst);
    __syncthreads();  // item k landed; item k - 1's reads are done
    unsigned char* stg = ring + ((k - k0) % nst) * a.stage_bytes;
    const uint32_t bs = smem_addr(stg + wstage);
    if (kPath == kU8Gather)
      tc_gather(a, reinterpret_cast<const typename L::Raw*>(win), at, k);
    const int nxt = k + nst - 1;
    if (nxt < k1)
      L::template load<kPath>(a, ring + ((nxt - k0) % nst) * a.stage_bytes,
                              x, ih0, iw0, nxt, f0);
    cp_async_commit();

    if (kPath == kU8Gather) {
      __syncthreads();  // the gathered A rows are visible
      const uint32_t ab = smem_addr(at);
#pragma unroll 1
      for (int j = 0; j < a.steps; ++j)
        L::step(acc, u8_a_addr(ab + j * kU8AStepB, arow[0], hl),
                u8_a_addr(ab + j * kU8AStepB, arow[1], hl),
                bs + j * kU8StepB, boff);
    } else {
      const uint32_t ab = smem_addr(stg);
      const int tap0 = (k % a.n_tg) * a.steps;
      const int nsteps = min(a.steps, a.K * a.K - tap0);
      int kh = tap0 / a.K, kw = tap0 - kh * a.K;
#pragma unroll 1
      for (int j = 0; j < nsteps; ++j) {
        const int o = kh * a.cols + kw;
        L::step(acc, u8_a_addr(ab, arow[0] + o, hl),
                u8_a_addr(ab, arow[1] + o, hl), bs + j * kU8StepB, boff);
        if (++kw == a.K) { kw = 0; ++kh; }
      }
    }
  }

  // One write per output: the result (epilogue on the registers) or this
  // range's partial.  Accumulator q of an m16n8 tile is row
  // (lane >> 2) + 8 * (q >> 1), column (lane & 3) * 2 + (q & 1).
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = wm + mt * 16 + (lane >> 2) + 8 * hr;
      if (m >= npix) continue;
      const int lh = m / a.TW, lw = m - lh * a.TW;
      const int ho = oh0 + lh, wo = ow0 + lw;
      if (ho >= a.H_O || wo >= a.W_O) continue;
      const size_t pix =
          (static_cast<size_t>(n) * a.H_O + ho) * a.W_O + wo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        L::put2(a, split, pix, f0 + wn + nt * 8 + (lane & 3) * 2,
                acc[mt][nt][hr * 2], acc[mt][nt][hr * 2 + 1]);
    }
}

// The u8 x s8 lane's parts of tc_conv (TOut: int32 or requantized uint8
// out).
template <typename TOut>
struct U8Lane {
  using Args = U8Args;
  using Raw = uint8_t;  // a window value's bits
  using Acc = int;
  template <int kPath>
  static __device__ __forceinline__ void load(const Args& a, unsigned char* st,
                                              const uint8_t* x, int ih0,
                                              int iw0, int it, int f0) {
    u8_load_item<kPath>(a, st, x, ih0, iw0, it, f0);
  }
  // ldmatrix x4 p covers n8 tiles 2p, 2p + 1 of the warp's four, lane l
  // feeding filter row l & 7 of tile 2p + (l >> 4), half (l >> 3) & 1
  static __device__ __forceinline__ int boff(int wn, int lane, int p) {
    return u8_wt_off(wn + (2 * p + (lane >> 4)) * 8 + (lane & 7),
                     (lane >> 3) & 1);
  }
  static __device__ __forceinline__ void step(int (&acc)[2][4][4],
                                              uint32_t a0, uint32_t a1,
                                              uint32_t b,
                                              const int (&boff)[2]) {
    u8_step(acc, a0, a1, b, boff);
  }
  static __device__ __forceinline__ void put2(const Args& a, int split,
                                              size_t pix, int f, int v0,
                                              int v1) {
    u8_put2<TOut>(a, split, pix, f, v0, v1);
  }
};

// The u8 x s8 conv on the window and gather paths.
template <int kPath, typename TOut>
__global__ void __launch_bounds__(kU8Threads, kPath == kU8Gather ? 3 : 2)
trim_conv2d_u8s8_kernel(const U8Args a) {
  tc_conv<U8Lane<TOut>, kPath>(a);
}

// The slide path (K = 3 at stride 1: every VGG-16 conv but the first):
// a block owns 16 x 16 output pixels x 64 filters; warp (wm, wn) owns
// output rows 4 wm .. 4 wm + 3 of the tile, one m16 tile of 16 pixels
// each, x 32 filters (64 int32 accumulators a thread).  Output row r at
// tap (kh, kw) reads window row r + kh from column kw, so per kw the
// warp loads its 6 window rows 4 wm .. 4 wm + 5 once each and multiplies
// each by the weights of up to 3 taps: the TrIM input movement across
// the rows, in registers.  A chunk costs 18 A and 18 B ldmatrix for 144
// mma (the window path's layout: 36 and 36).  The planner takes it only
// where its tiles fill the card, so it never splits.  Grid: (spatial
// tiles, filter tiles, N).
template <typename TOut>
__global__ void __launch_bounds__(kU8Threads, 2)
trim_conv2d_u8s8_slide_kernel(const U8Args a) {
  extern __shared__ __align__(128) unsigned char smem_u8[];
  const int tile = blockIdx.x;
  const int th = tile / a.n_tw, tw = tile - th * a.n_tw;
  const int ft = blockIdx.y, n = blockIdx.z;
  const int oh0 = th * kU8SlideT, ow0 = tw * kU8SlideT, f0 = ft * kU8Fb;
  const int ih0 = oh0 - a.pad, iw0 = ow0 - a.pad;
  const int k0 = 0, k1 = a.n_items;  // never split: its tiles fill the card

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = (warp >> 2) * 32;
  const uint8_t* x = a.x + static_cast<size_t>(n) * a.H * a.W * a.C;
  const int hl = lane >> 4;
  // lane l feeds row l & 15 (the pixel's column) of each A fragment
  const int arow = 4 * wm * a.cols + (lane & 15);
  int boff[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    boff[p] = u8_wt_off(wn + (2 * p + (lane >> 4)) * 8 + (lane & 7),
                        (lane >> 3) & 1);

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  const int nst = a.stages;
  for (int s = 0; s < nst - 1; ++s) {
    if (k0 + s < k1)
      u8_load_item<kU8Window>(a, smem_u8 + s * a.stage_bytes, x, ih0, iw0,
                              k0 + s, f0);
    cp_async_commit();
  }
  for (int k = k0; k < k1; ++k) {
    cp_async_wait_ring(nst);
    __syncthreads();  // item k landed; item k - 1's reads are done
    unsigned char* stg = smem_u8 + ((k - k0) % nst) * a.stage_bytes;
    const uint32_t ab = smem_addr(stg), bs = smem_addr(stg + a.win_bytes);
    const int nxt = k + nst - 1;
    if (nxt < k1)
      u8_load_item<kU8Window>(a, smem_u8 + ((nxt - k0) % nst) * a.stage_bytes,
                              x, ih0, iw0, nxt, f0);
    cp_async_commit();
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      uint32_t bf[3][2][4];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldsm_x4(bf[kh][p], bs + (kh * 3 + kw) * kU8StepB + boff[p]);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        uint32_t af[4];
        ldsm_x4(af, u8_a_addr(ab, arow + i * a.cols + kw, hl));
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int mt = i - kh;
          if (mt < 0 || mt > 3) continue;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_u8s8(acc[mt][nt], af, bf[kh][nt >> 1][(nt & 1) * 2],
                     bf[kh][nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }
  }

  // Accumulator q of m16n8 tile (mt, nt) is output row 4 wm + mt, column
  // (lane >> 2) + 8 (q >> 1), filter wn + nt * 8 + (lane & 3) * 2 + (q & 1).
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int ho = oh0 + 4 * wm + mt, wo = ow0 + (lane >> 2) + 8 * hr;
      if (ho >= a.H_O || wo >= a.W_O) continue;
      const size_t pix =
          (static_cast<size_t>(n) * a.H_O + ho) * a.W_O + wo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        u8_put2<TOut>(a, 0, pix, f0 + wn + nt * 8 + (lane & 3) * 2,
                      acc[mt][nt][hr * 2], acc[mt][nt][hr * 2 + 1]);
    }
}

// out[i] = epilogue(p_0[i] + ... + p_{n_split-1}[i]) over M outputs of F
// filters (the filter of output i is i % F).
template <typename TOut>
__global__ void __launch_bounds__(256)
trim_conv2d_u8s8_merge(const int32_t* __restrict__ parts, U8Epilogue e,
                       TOut* __restrict__ out, long long M, int F,
                       int n_split) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < M; i += step) {
    int32_t s = parts[i];
    for (int k = 1; k < n_split; ++k) s += parts[k * M + i];
    out[i] = u8_finish<TOut>(s, e, static_cast<int>(i % F));
  }
}

template <int kPath, typename TOut>
int launch_u8(const U8Args& a, int smem_bytes, cudaStream_t s) {
  static int smem_set = 0;  // per instantiation: what has been raised
  void (*kern)(U8Args);
  if constexpr (kPath == kU8Slide)
    kern = &trim_conv2d_u8s8_slide_kernel<TOut>;
  else
    kern = &trim_conv2d_u8s8_kernel<kPath, TOut>;
  int rc = raise_smem(reinterpret_cast<const void*>(kern), smem_set,
                      smem_bytes);
  if (rc != 0) return rc;
  const int n_th = (a.H_O + a.TH - 1) / a.TH;
  const dim3 grid(n_th * a.n_tw, a.n_f * a.n_split, a.N);
  kern<<<grid, kU8Threads, smem_bytes, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.n_split == 1) return rc;
  const long long M = static_cast<long long>(a.N) * a.H_O * a.W_O * a.F;
  const int blocks =
      static_cast<int>((M + 255) / 256 < 4224 ? (M + 255) / 256 : 4224);
  trim_conv2d_u8s8_merge<TOut><<<blocks, 256, 0, s>>>(
      a.parts, a.e, static_cast<TOut*>(a.out), M, a.F, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16 lane, gather path
//
// The u8 x s8 lane's gather path with m16n8k16 bf16 x bf16 -> fp32 (C <=
// 8, or C or F not a multiple of 8: no tensor map describes those rows): a
// k-step is still 32 bytes (16 channels), so the gathered A rows, the
// ldmatrix phases and the ring carry over as they are.  The weights need
// no pre-pass: ldmatrix.trans moves 16-bit elements, so a step's B tile
// is 16 rows of w (K, K, C, F) as they lie ([k][64 filters], 128 bytes a
// row, the 16-byte units swizzled by the row), read transposed.

constexpr int kBfStepC = 16;  // channels (depth values) a k-step

struct BfArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;  // (K, K, C, F): depth row d = (kh*K + kw)*C + c
  const void* bias;        // (F,) fp32 or bf16, or null
  __nv_bfloat16* out;      // (N, H_O, W_O, F)
  float* parts;            // n_split > 1: n_split x (N, H_O, W_O, F) fp32
  int bias_bf16, relu;
  int N, H, W, C, K, F, H_O, W_O, S, pad;
  int TH, TW, n_tw, n_f;
  int rows, cols;
  int steps, n_tg, n_items, n_split, stages;
  int depth;
  int win_bytes, stage_bytes;
  int vec_w;
};

// Byte offset of 16-byte unit u (filters 8u .. 8u + 7) of k-row r in one
// step's weights [16 rows][64 filters]: an ldmatrix.trans phase reads 8
// consecutive rows at one unit, which the XOR puts in 8 bank groups.
__device__ __forceinline__ int bf_wt_off(int r, int u) {
  return (r << 7) + ((u ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight bf16 values from ``src`` where ``ok(b)``, else zero, as 16 bytes.
template <typename Ok>
__device__ __forceinline__ uint4 bf_pack8(const __nv_bfloat16* src, Ok ok) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (ok(b)) v[b >> 1] |= static_cast<uint32_t>(s[b]) << (16 * (b & 1));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Issue the copies of gather item ``it`` into ring stage ``st``: the
// weights of its depth chunk.  Step j's weights are w's depth rows
// (it * steps + j) * 16 .. + 15 at filters f0 .. f0 + 63; rows past K*K*C
// and filters past F are zero.  A thread copies unit tid & 7 of row
// (tid >> 3) & 15 of steps (tid >> 7) + 2 t.
template <int kPath>
__device__ __forceinline__ void bf_load_item(const BfArgs& a,
                                             unsigned char* st,
                                             const __nv_bfloat16*, int, int,
                                             int it, int f0) {
  static_assert(kPath == kU8Gather, "the bf16 lane's window path is wgmma");
  const int u = threadIdx.x & 7, r = (threadIdx.x >> 3) & 15;
  const int j0 = threadIdx.x >> 7;
  unsigned char* dst = st + j0 * kU8StepB + bf_wt_off(r, u);
  long long row = static_cast<long long>(it * a.steps + j0) * kBfStepC + r;
  const long long drow = 2 * kBfStepC;
  const int f = f0 + u * 8;
  for (int j = j0; j < a.steps; j += 2) {
    const bool ok = row < a.depth && f < a.F;
    const __nv_bfloat16* src = a.w + row * a.F + f;
    if (a.vec_w) {
      cp_async16(dst, ok ? src : a.w, ok);
    } else {
      const int F = a.F;
      *reinterpret_cast<uint4*>(dst) =
          bf_pack8(src, [&](int b) { return ok && f + b < F; });
    }
    row += drow;
    dst += 2 * kU8StepB;
  }
}

// One k16 step of a warp: A rows from ``a0``/``a1`` as on the u8 lane, B
// by ldmatrix.trans from the step's [16][64] tile at ``b`` (+ the lane's
// two x4 offsets: n8 tiles 2p and 2p + 1, k rows 0-7 and 8-15 each).
__device__ __forceinline__ void bf_step(float (&acc)[2][4][4], uint32_t a0,
                                        uint32_t a1, uint32_t b,
                                        const int (&boff)[2]) {
  uint32_t af[2][4], bf[2][4];
  ldsm_x4(af[0], a0);
  ldsm_x4(af[1], a1);
  ldsm_x4_t(bf[0], b + boff[0]);
  ldsm_x4_t(bf[1], b + boff[1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_bf16(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2],
               bf[nt >> 1][(nt & 1) * 2 + 1]);
}

__device__ __forceinline__ float bf_finish(const BfArgs& a, float v, int f) {
  if (a.bias != nullptr)
    v += a.bias_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[f])
             : static_cast<const float*>(a.bias)[f];
  return a.relu ? (v > 0.f ? v : 0.f) : v;
}

// The pair of outputs (f, f + 1) of pixel ``pix`` that a lane's
// accumulators hold: bias -> ReLU in fp32, then one rounding to bf16 (in
// one store where both filters exist and F is even), or this range's
// fp32 partials.
__device__ __forceinline__ void bf_put2(const BfArgs& a, int split,
                                        size_t pix, int f, float v0,
                                        float v1) {
  if (f >= a.F) return;
  const bool pair = f + 1 < a.F && (a.F & 1) == 0;
  if (a.n_split == 1) {
    __nv_bfloat16* o = a.out + pix * a.F + f;
    v0 = bf_finish(a, v0, f);
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) =
          __floats2bfloat162_rn(v0, bf_finish(a, v1, f + 1));
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (f + 1 < a.F) o[1] = __float2bfloat16_rn(bf_finish(a, v1, f + 1));
    }
  } else {
    float* o = a.parts +
               (static_cast<size_t>(split) * a.N * a.H_O * a.W_O + pix) *
                   a.F + f;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (f + 1 < a.F) o[1] = v1;
    }
  }
}

// The bf16 lane's parts of tc_conv.
struct Bf16Lane {
  using Args = BfArgs;
  using Raw = unsigned short;  // a window value's bits
  using Acc = float;
  template <int kPath>
  static __device__ __forceinline__ void load(const Args& a, unsigned char* st,
                                              const __nv_bfloat16* x, int ih0,
                                              int iw0, int it, int f0) {
    bf_load_item<kPath>(a, st, x, ih0, iw0, it, f0);
  }
  // ldmatrix.trans x4 p reads matrices (n8 tile 2p + (l >> 4), k rows
  // 8 ((l >> 3) & 1) ..) at lane l's row l & 7
  static __device__ __forceinline__ int boff(int wn, int lane, int p) {
    return bf_wt_off(((lane >> 3) & 1) * 8 + (lane & 7),
                     (wn >> 3) + 2 * p + (lane >> 4));
  }
  static __device__ __forceinline__ void step(float (&acc)[2][4][4],
                                              uint32_t a0, uint32_t a1,
                                              uint32_t b,
                                              const int (&boff)[2]) {
    bf_step(acc, a0, a1, b, boff);
  }
  static __device__ __forceinline__ void put2(const Args& a, int split,
                                              size_t pix, int f, float v0,
                                              float v1) {
    bf_put2(a, split, pix, f, v0, v1);
  }
};

// The bf16 conv on the gather path (its only instance; the window path is
// trim_conv2d_bf16_wgmma_kernel): the u8 x s8 lane's blocks, warps and
// ring with fp32 accumulators.  The geometry comes from the per-image
// shape alone (the wrapper's bf16_tile), so an output's sum runs in one
// order at every batch.
template <int kPath>
__global__ void __launch_bounds__(kU8Threads, kPath == kU8Gather ? 3 : 2)
trim_conv2d_bf16_kernel(const BfArgs a) {
  tc_conv<Bf16Lane, kPath>(a);
}

// out[i] = bf16(epilogue(p_0[i] + ... + p_{n_split-1}[i])), summed in
// split order over M outputs of F filters.
__global__ void __launch_bounds__(256)
trim_conv2d_bf16_merge(const float* __restrict__ parts, const BfArgs a,
                       long long M) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < M; i += step) {
    float s = parts[i];
    for (int k = 1; k < a.n_split; ++k) s += parts[k * M + i];
    a.out[i] = __float2bfloat16_rn(bf_finish(a, s, static_cast<int>(i % a.F)));
  }
}

// The gather path's launch: the conv and, split, the merge.
int launch_bf16_gather(const BfArgs& a, int smem_bytes, cudaStream_t s) {
  static int smem_set = 0;
  void (*kern)(BfArgs) = &trim_conv2d_bf16_kernel<kU8Gather>;
  int rc = raise_smem(reinterpret_cast<const void*>(kern), smem_set,
                      smem_bytes);
  if (rc != 0) return rc;
  const int n_th = (a.H_O + a.TH - 1) / a.TH;
  const dim3 grid(n_th * a.n_tw, a.n_f * a.n_split, a.N);
  kern<<<grid, kU8Threads, smem_bytes, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || a.n_split == 1) return rc;
  const long long M = static_cast<long long>(a.N) * a.H_O * a.W_O * a.F;
  const int blocks =
      static_cast<int>((M + 255) / 256 < 4224 ? (M + 255) / 256 : 4224);
  trim_conv2d_bf16_merge<<<blocks, 256, 0, s>>>(a.parts, a, M);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- bf16 lane, wgmma window path
//
// A block owns TH x TW (<= 128) output pixels of one image x kFb filters
// (64 or 128): two consumer warpgroups of 64 pixels, each holding its 64 x
// kFb fp32 sums in registers, and a producer warp.  Two blocks an SM (at
// most 112 registers a thread, 113 KB of shared memory each): one block's
// loads, barrier waits and epilogue overlap the other's products.  256
// filters' 128 sums and the double-buffered A fragments would pass even
// one block's 168 registers.  The depth runs
// over 64-channel chunks and, within one, over the K*K taps: per chunk the
// producer brings the haloed window (64 channels x rows x cols of x (N,
// H, W, C), one TMA copy through a 4-d map whose zero fill outside the
// image and past C is the padding) into a 2-stage window ring, and per
// (chunk, tap) the tap's weights (w's rows (tap, c0 .. c0 + 63) x kFb
// filters, TMA through a 3-d map over w (K*K, C, F) as it lies, zero past
// C and F) into a ring of its own.  Every tap reads the one window through
// a shifted view: for tap (kh, kw) a consumer warp's A fragments (16
// pixels x 16 channels, four k16 steps a tap) come by ldmatrix from the
// window pixels (lh S + kh, lw S + kw) of its pixels, the row addresses
// XORed as TMA's 128-byte swizzle laid them; then wgmma with A in
// registers and B the weight stage read MN-major (filters contiguous).
// The A registers are double-buffered across taps: a tap's products run
// while the next tap's fragments load, and its weight stage (and, after
// a chunk's last tap, its window) is released when they are done.
// Epilogue: bias, then ReLU, in fp32, one rounding to bf16, staged in
// shared memory, written as 16-byte rows.  Where one image's tiles cannot
// fill the card, the chunks are cut into n_split contiguous ranges whose
// blocks form one thread-block cluster (n_split <= 8, the portable
// size): each block stages its fp32 sums in its shared memory, and block
// r sums pixels [128 r / n_split, 128 (r + 1) / n_split) over the
// cluster's blocks in rank order through distributed shared memory, then
// runs the epilogue: the order depends on the per-image shape alone, no
// atomics, no partial slab and no second launch.
//
// What bounds it on the H100: a block's 128 pixels share each weight row,
// so the weights stream from L2 at 2 bytes for 128 products a value; with
// the window, the barriers and the loop that is most of the time at
// VGG-16's batch-8 shapes (tools/bf16_conv_breakdown.py), the products the
// rest.  Two blocks an SM overlap one's loads with the other's products.

constexpr int kBwcThreads = 256 + 32;  // two consumer warpgroups + producer
constexpr int kBwcPix = 128;           // output pixels a block
constexpr int kBwcMaxStages = 4;       // weight ring
constexpr int kBwcMaxSplit = 8;        // portable cluster size

struct BwcArgs {
  const void* bias;        // (F,) fp32 or bf16, or null
  __nv_bfloat16* out;      // (N, H_O, W_O, F)
  int bias_bf16, relu;
  int C, K, F, H_O, W_O, S, pad;
  int TH, TW, n_tw, rows, cols, n_cc, n_split, stages;
  int win_bytes, w_bytes, bar;  // window stage, weight stage, barriers' offset
};

template <int kFb>
__device__ __forceinline__ void bwc_mma(float (&acc)[kFb / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kFb == 64)
    wgmma_rs_m64n64(acc, a, db);
  else
    wgmma_rs_m64n128(acc, a, db);
}

// A consumer warp's position in its range's (chunk, tap) items, stepped
// without a division: items done, the tap in its chunk, the tap's window
// offset (kh cols + kw) and kw, the chunk, the weight ring's stage and the
// phase parity of its use.
struct BwcPos {
  int it, t, toff, kw, wi, st;
  uint32_t par;
};

// One (chunk, tap) item of a consumer warp: wait for its window (at the
// chunk's first tap) and its weight stage, load its four k16 A fragments
// from the window's shifted view (``wpix`` the lane's window pixel at tap
// (0, 0), ``uhi`` its half of a k16 step's 32 bytes), issue the four
// products, then wait for the item before, release that item's stages and
// step to the next item.
template <int kFb>
__device__ __forceinline__ void bwc_item(float (&acc)[kFb / 2],
                                         uint32_t (&af)[4][4],
                                         const BwcArgs& a, BwcPos& q,
                                         int wpix, int uhi, uint32_t sbase,
                                         uint32_t bars, int lane) {
  const uint32_t win_full = bars, win_empty = bars + 16;
  const uint32_t w_full = bars + 32, w_empty = w_full + 8 * a.stages;
  if (q.t == 0) mbar_wait(win_full + 8 * (q.wi & 1), (q.wi >> 1) & 1);
  mbar_wait(w_full + 8 * q.st, q.par);
  const int wp = wpix + q.toff;
  const uint32_t row = sbase + (q.wi & 1) * a.win_bytes + (wp << 7);
  const int sw = wp & 7;
#pragma unroll
  for (int k = 0; k < 4; ++k) ldsm_x4(af[k], row + (((2 * k + uhi) ^ sw) << 4));
  const uint32_t bb = sbase + 2 * a.win_bytes + q.st * a.w_bytes;
  const uint64_t db = sw128_desc(bb, 64 * 128);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) bwc_mma<kFb>(acc, af[k], db + (k * 16 * 128 >> 4));
  wgmma_commit();
  wgmma_wait<1>();
  if (q.it > 0) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(w_empty + 8 * (q.st == 0 ? a.stages - 1 : q.st - 1));
      if (q.t == 0) mbar_arrive(win_empty + 8 * ((q.wi - 1) & 1));
    }
  }
  ++q.it;
  if (++q.st == a.stages) {
    q.st = 0;
    q.par ^= 1;
  }
  ++q.toff;
  if (++q.kw == a.K) {
    q.kw = 0;
    q.toff += a.cols - a.K;
  }
  if (++q.t == a.K * a.K) {
    q.t = 0;
    q.toff = 0;
    ++q.wi;
  }
}

__device__ __forceinline__ float bwc_bias(const BwcArgs& a, int f) {
  if (a.bias == nullptr) return 0.f;
  return a.bias_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[f])
             : static_cast<const float*>(a.bias)[f];
}

// Grid: (spatial tiles x n_split, filter tiles, N); split, clusters of
// n_split along x.
template <int kFb>
__global__ void __launch_bounds__(kBwcThreads, 2)
trim_conv2d_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                              const __grid_constant__ CUtensorMap w_map,
                              const BwcArgs a) {
  extern __shared__ unsigned char smem_bwc[];
  unsigned char* sm =
      smem_bwc + ((1024u - (smem_addr(smem_bwc) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(sm);
  const uint32_t bars = sbase + a.bar;
  const uint32_t win_full = bars, win_empty = bars + 16;
  const uint32_t w_full = bars + 32, w_empty = w_full + 8 * a.stages;
  const int rank = a.n_split > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int tile = blockIdx.x / a.n_split;
  const int th = tile / a.n_tw, tw = tile - th * a.n_tw;
  const int f0 = blockIdx.y * kFb, n = blockIdx.z;
  const int oh0 = th * a.TH, ow0 = tw * a.TW;
  const int npix = a.TH * a.TW;
  const int KK = a.K * a.K;
  const int c_lo = a.n_cc * rank / a.n_split;
  const int n_items = (a.n_cc * (rank + 1) / a.n_split - c_lo) * KK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(win_full + 8 * i, 1);
      mbar_init(win_empty + 8 * i, 8);  // one per consumer warp
    }
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(w_full + 8 * i, 1);
      mbar_init(w_empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kFb / 2];
#pragma unroll
  for (int e = 0; e < kFb / 2; ++e) acc[e] = 0.0f;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 256) {
    // Producer: one thread keeps both rings full.
    if (lane == 0) {
      const uint32_t wtx = static_cast<uint32_t>(a.rows * a.cols * 128);
      const uint32_t btx = static_cast<uint32_t>(64 * kFb * 2);
      for (int it = 0; it < n_items; ++it) {
        const int wi = it / KK, t = it - wi * KK;
        if (t == 0) {
          const int ws = wi & 1;
          mbar_wait(win_empty + 8 * ws, ((wi >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(win_full + 8 * ws, wtx);
          tma_load_4d(sbase + ws * a.win_bytes, &x_map, win_full + 8 * ws,
                      (c_lo + wi) * 64, ow0 * a.S - a.pad, oh0 * a.S - a.pad,
                      n);
        }
        const int st = it % a.stages;
        mbar_wait(w_empty + 8 * st, ((it / a.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(w_full + 8 * st, btx);
        const uint32_t dst = sbase + 2 * a.win_bytes + st * a.w_bytes;
#pragma unroll
        for (int q = 0; q < kFb / 64; ++q)
          tma_load_3d(dst + q * 64 * 128, &w_map, w_full + 8 * st,
                      f0 + 64 * q, (c_lo + wi) * 64, t);
      }
    }
    __syncwarp();
  } else {
    // Consumers: warpgroup wg owns pixels 64 wg .. 64 wg + 63 of the tile.
    // ldmatrix x4: lane l gives the row address of matrix l >> 3, row
    // l & 7: pixel 16 warp + (l & 7) + 8 ((l >> 3) & 1), the k16 step's
    // 16-byte half (l >> 3) >> 1: a0..a3 of the A fragment in order.
    // A pixel past the tile reads pixel 0 (its output is not written).
    const int mi = lane >> 3;
    int m = (threadIdx.x / 32) * 16 + (lane & 7) + 8 * (mi & 1);
    m = m < npix ? m : 0;
    const int lh = m / a.TW, lw = m - lh * a.TW;
    const int wpix = lh * a.S * a.cols + lw * a.S;
    uint32_t a0[4][4], a1[4][4];
    BwcPos q = {0, 0, 0, 0, 0, 0, 0u};
    for (int it = 0; it < n_items; it += 2) {
      bwc_item<kFb>(acc, a0, a, q, wpix, mi >> 1, sbase, bars, lane);
      if (it + 1 < n_items)
        bwc_item<kFb>(acc, a1, a, q, wpix, mi >> 1, sbase, bars, lane);
    }
    wgmma_wait<0>();
    pin(acc);
  }
  __syncthreads();  // every product is done: the rings are free

  // acc[4 j + 2 i + c]: pixel 16 warp + (lane >> 2) + 8 i, filter
  // 8 j + 2 (lane & 3) + c of the block's.
  const int g8 = lane >> 2, t4 = lane & 3;
  const int warp = threadIdx.x / 32;
  if (a.n_split == 1) {
    constexpr int kPitch = kFb * 2 + 16;
    if (threadIdx.x < 256) {
#pragma unroll
      for (int j = 0; j < kFb / 8; ++j) {
        const int f = f0 + 8 * j + 2 * t4;
        const float b0 = f < a.F ? bwc_bias(a, f) : 0.f;
        const float b1 = f + 1 < a.F ? bwc_bias(a, f + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v0 = acc[4 * j + 2 * i] + b0, v1 = acc[4 * j + 2 * i + 1] + b1;
          if (a.relu) {
            v0 = v0 > 0.f ? v0 : 0.f;
            v1 = v1 > 0.f ? v1 : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(
              sm + (warp * 16 + g8 + 8 * i) * kPitch + (8 * j + 2 * t4) * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();
    constexpr int kUnits = kFb / 8;  // 16-byte units a row
    for (int e = threadIdx.x; e < kBwcPix * kUnits; e += kBwcThreads) {
      const int mm = e / kUnits, u = e - mm * kUnits;
      const int f = f0 + 8 * u;
      if (mm >= npix || f >= a.F) continue;
      const int ho = oh0 + mm / a.TW, wo = ow0 + mm % a.TW;
      if (ho >= a.H_O || wo >= a.W_O) continue;
      *reinterpret_cast<uint4*>(
          a.out + ((static_cast<size_t>(n) * a.H_O + ho) * a.W_O + wo) * a.F +
          f) = *reinterpret_cast<const uint4*>(sm + mm * kPitch + u * 16);
    }
    return;
  }
  // Split: this block's fp32 sums into its shared memory, then block r
  // sums its rows over the cluster in rank order.
  constexpr int kPitch = kFb * 4 + 16;
  if (threadIdx.x < 256) {
#pragma unroll
    for (int j = 0; j < kFb / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(sm + (warp * 16 + g8 + 8 * i) * kPitch +
                                   (8 * j + 2 * t4) * 4) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
  cluster_sync();
  const int m0 = kBwcPix * rank / a.n_split;
  const int m1 = kBwcPix * (rank + 1) / a.n_split;
  constexpr int kQuads = kFb / 4;
  for (int e = threadIdx.x; e < (m1 - m0) * kQuads; e += kBwcThreads) {
    const int mm = m0 + e / kQuads, q = e % kQuads;
    const int f = f0 + 4 * q;
    if (mm >= npix || f >= a.F) continue;
    const int ho = oh0 + mm / a.TW, wo = ow0 + mm % a.TW;
    if (ho >= a.H_O || wo >= a.W_O) continue;
    const float4 v = cluster_sum(sbase + mm * kPitch + q * 16, a.n_split);
    float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] += bwc_bias(a, f + k);
      if (a.relu) o[k] = o[k] > 0.f ? o[k] : 0.f;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(
        a.out + ((static_cast<size_t>(n) * a.H_O + ho) * a.W_O + wo) * a.F +
        f) = pk;
  }
  cluster_sync();  // the cluster's reads of this block's sums are done
}

// Shared memory of the wgmma window path: the 2-stage window ring and the
// weight ring, or the epilogue's staging where larger, the barriers, and
// 1024 bytes to align the base.  Writes the offsets into ``a``.
long long bwc_smem(BwcArgs& a, int fb) {
  a.win_bytes = (a.rows * a.cols * 128 + 1023) / 1024 * 1024;
  a.w_bytes = 64 * fb * 2;
  const long long ring =
      2LL * a.win_bytes + static_cast<long long>(a.stages) * a.w_bytes;
  const long long stage = static_cast<long long>(kBwcPix) *
                          (a.n_split > 1 ? fb * 4 + 16 : fb * 2 + 16);
  a.bar = static_cast<int>(ring > stage ? ring : stage);
  return a.bar + 8LL * (4 + 2 * a.stages) + 1024;
}

template <int kFb>
int launch_bwc(const CUtensorMap& x_map, const CUtensorMap& w_map,
               const BwcArgs& a, int N, int n_tiles, int smem_bytes,
               cudaStream_t s) {
  static int smem_set = 0;
  void (*kern)(CUtensorMap, CUtensorMap, BwcArgs) =
      &trim_conv2d_bf16_wgmma_kernel<kFb>;
  const int rc = raise_smem(reinterpret_cast<const void*>(kern), smem_set,
                            smem_bytes);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * a.n_split, (a.F + kFb - 1) / kFb, N);
  cfg.blockDim = dim3(kBwcThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x_map, w_map, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Constants the wrapper validates against.
int trim_conv2d_f32_threads() { return kF32Threads; }
int trim_conv2d_f32_filters() { return kF32Fb; }
int trim_conv2d_u8_pixels() { return kU8M; }
int trim_conv2d_u8_filters() { return kU8Fb; }
int trim_conv2d_u8_max_depth() { return kU8MaxDepth; }
// the bf16 wgmma window path: output pixels a block, most cluster blocks
// (the split), most weight-ring stages
int trim_conv2d_bf16_pixels() { return kBwcPix; }
int trim_conv2d_bf16_max_split() { return kBwcMaxSplit; }
int trim_conv2d_bf16_max_stages() { return kBwcMaxStages; }

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

// uint8 x int8 lane: x (N,H,W,C) u8, w (K,K,C,F) s8, bias (F,) int32 or
// null; rq_kind 0 writes int32 out, 1 (power-of-two shift rq_shift) and 2
// (per-channel mult/shift, (F,) int32 each) write uint8.  ``wt`` holds
// the transposed weights: K*K * Fp * Cp bytes on the window path, Fp *
// n_items * steps * 32 on the gather path (Fp = F rounded up to 64, Cp =
// C rounded up to 32), 16-byte aligned; with ``wt_ready`` 0 this call
// writes them first (the caller keeps them for later calls on the same
// weights and passes 1 then).  With n_split > 1, ``parts`` holds n_split
// * N*H_O*W_O*F int32 of scratch.  One call launches the weights'
// transposition (unless ready), the conv and, split, the merge.
// The caller
// (the Python wrapper's planner, u8_tile) picks the geometry: the path
// (0 window, 1 gather), the TH x TW output tile (TH * TW <= 128), the
// steps an item (window: taps of a group, 1 .. K*K; gather: depth steps
// of a chunk), n_split ranges of items, 2 or 3 stages, and the shared
// memory, which must equal what this function computes.  Returns the
// first launch error's cudaError_t, or 0.
int trim_conv2d_u8s8(const void* x, const void* w, const void* bias,
                     const void* mult, const void* shift, void* out,
                     void* wt, void* parts, int N, int H, int W, int C, int K, int F,
                     int H_O, int W_O, int stride, int pad, int path, int TH,
                     int TW, int steps, int n_split, int stages, int relu,
                     int rq_kind, int rq_shift, int wt_ready, int smem_bytes,
                     void* stream) {
  U8Args a;
  a.rows = (TH - 1) * stride + K;
  a.cols = (TW - 1) * stride + K;
  a.depth = K * K * C;
  const bool slide = path == kU8Slide;
  const bool window = path == kU8Window || slide;  // the window's layout
  if ((path != kU8Window && path != kU8Gather && !slide) || TH < 1 ||
      TW < 1 || (!slide && TH * TW > kU8M) || steps < 1 ||
      (window && steps > K * K) ||
      (slide && (K != 3 || stride != 1 || TH != kU8SlideT ||
                 TW != kU8SlideT || steps != 9 || n_split != 1)) ||
      stages < 2 || stages > kMaxStages || stride < 1 || K < 1 || C < 1 ||
      F < 1 || N < 1 || N > 65535 ||
      static_cast<long long>(K) * K * C > kU8MaxDepth ||
      (n_split > 1 && parts == nullptr) || rq_kind < kRqNone ||
      rq_kind > kRqMultShift || rq_shift < 0 || rq_shift > 31 ||
      (rq_kind == kRqMultShift && (mult == nullptr || shift == nullptr)) ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL ||
      static_cast<long long>(H_O) * W_O * F > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_tg = window ? (K * K + steps - 1) / steps : 1;
  a.n_items = window ? (C + kU8Step - 1) / kU8Step * a.n_tg
                     : (a.depth + steps * kU8Step - 1) / (steps * kU8Step);
  const int wbytes = window ? a.rows * a.cols * kU8Step : a.rows * a.cols * C;
  a.win_bytes = (wbytes + 127) / 128 * 128;
  a.stage_bytes = (window ? a.win_bytes : 0) + steps * kU8StepB;
  const long long smem =
      (window ? 0LL : a.win_bytes + static_cast<long long>(steps) *
                                        kU8AStepB) +
      static_cast<long long>(stages) * a.stage_bytes;
  a.n_f = (F + kU8Fb - 1) / kU8Fb;
  a.Fp = a.n_f * kU8Fb;
  a.L = window ? (C + kU8Step - 1) / kU8Step * kU8Step
               : a.n_items * steps * kU8Step;
  const int G = window ? K * K : 1;
  if (n_split < 1 || n_split > a.n_items || smem != smem_bytes ||
      static_cast<long long>(a.n_f) * n_split > 65535 || wt == nullptr ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 ||
      static_cast<long long>(G) * a.Fp * a.L > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const uint8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.wt = static_cast<const int8_t*>(wt);
  a.out = out;
  a.parts = static_cast<int32_t*>(parts);
  a.e.bias = static_cast<const int32_t*>(bias);
  a.e.mult = static_cast<const int32_t*>(mult);
  a.e.shift = static_cast<const int32_t*>(shift);
  a.e.relu = relu;
  a.e.rq_kind = rq_kind;
  a.e.rq_shift = rq_shift;
  a.N = N; a.H = H; a.W = W; a.C = C; a.K = K; a.F = F;
  a.H_O = H_O; a.W_O = W_O; a.S = stride; a.pad = pad;
  a.TH = TH; a.TW = TW;
  a.n_tw = (W_O + TW - 1) / TW;
  a.steps = steps; a.n_split = n_split; a.stages = stages;
  a.vec_x = C % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!wt_ready) {
    const long long units = static_cast<long long>(G) * a.Fp * (a.L / 16);
    const int blocks = static_cast<int>(
        (units + 255) / 256 < 4224 ? (units + 255) / 256 : 4224);
    trim_conv2d_u8s8_wprep<<<blocks, 256, 0, s>>>(
        a.w, static_cast<int8_t*>(wt), G, window ? C : a.depth, F, a.Fp, a.L);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  const bool u8out = rq_kind != kRqNone;
  if (path == kU8Slide)
    return u8out ? launch_u8<kU8Slide, uint8_t>(a, smem_bytes, s)
                 : launch_u8<kU8Slide, int32_t>(a, smem_bytes, s);
  if (window)
    return u8out ? launch_u8<kU8Window, uint8_t>(a, smem_bytes, s)
                 : launch_u8<kU8Window, int32_t>(a, smem_bytes, s);
  return u8out ? launch_u8<kU8Gather, uint8_t>(a, smem_bytes, s)
               : launch_u8<kU8Gather, int32_t>(a, smem_bytes, s);
}

// bf16 lane: x (N,H,W,C) bf16, w (K,K,C,F) bf16, bias (F,) fp32
// (bias_bf16 0) or bf16 (1) or null, out (N,H_O,W_O,F) bf16.  The caller
// (the wrapper's bf16_tile, from the per-image shape) picks the path and
// its geometry:
// - 0, the wgmma window path (C and F multiples of 8; x, w and out
//   16-byte aligned): the TH x TW output tile (TH * TW <= 128), ``steps``
//   the filters a block (64 or 128), n_split the cluster's blocks
//   (<= 8, at most the 64-channel chunks), ``stages`` the weight ring's
//   (2-4);
// - 1, the gather path (mma.sync): the TH x TW tile (TH * TW <= 128), the
//   k16 steps of a depth chunk, n_split ranges of chunks (with n_split >
//   1, ``parts`` holds n_split * N*H_O*W_O*F floats of scratch), 2 or 3
//   stages;
// and the shared memory, which must equal what this function computes.
// One call launches the conv and, on a split gather path, the merge.
// Returns the first launch error's cudaError_t, or 0.
int trim_conv2d_bf16(const void* x, const void* w, const void* bias,
                     void* out, void* parts, int N, int H, int W, int C,
                     int K, int F, int H_O, int W_O, int stride, int pad,
                     int path, int TH, int TW, int steps, int n_split,
                     int stages, int bias_bf16, int relu, int smem_bytes,
                     void* stream) {
  const int rows = (TH - 1) * stride + K;
  const int cols = (TW - 1) * stride + K;
  if ((path != kU8Window && path != kU8Gather) || TH < 1 || TW < 1 ||
      TH * TW > kU8M || steps < 1 || stride < 1 || K < 1 || C < 1 ||
      F < 1 || N < 1 || N > 65535 || n_split < 1 || pad < 0 ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL ||
      static_cast<long long>(H_O) * W_O * F > 0x7fffffffLL ||
      static_cast<long long>(K) * K * C * F > 0x7fffffffLL ||
      H_O != (H + 2 * pad - K) / stride + 1 ||
      W_O != (W + 2 * pad - K) / stride + 1 || H_O < 1 || W_O < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kU8Window) {
    BwcArgs a;
    a.bias = bias;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.bias_bf16 = bias_bf16;
    a.relu = relu;
    a.C = C; a.K = K; a.F = F; a.H_O = H_O; a.W_O = W_O; a.S = stride;
    a.pad = pad; a.TH = TH; a.TW = TW;
    a.n_tw = (W_O + TW - 1) / TW;
    a.rows = rows; a.cols = cols;
    a.n_cc = (C + 63) / 64;
    a.n_split = n_split;
    a.stages = stages;
    const long long smem = bwc_smem(a, steps);
    const int n_tiles = (H_O + TH - 1) / TH * a.n_tw;
    if (C % 8 != 0 || F % 8 != 0 || (steps != 64 && steps != 128) ||
        n_split > kBwcMaxSplit || n_split > a.n_cc || stages < 2 ||
        stages > kBwcMaxStages || rows > 256 || cols > 256 ||
        smem != smem_bytes || smem > 232448 ||
        static_cast<long long>(n_tiles) * n_split > 0x7fffffffLL ||
        (F + steps - 1) / steps > 65535 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap x_map, w_map;
    int rc = encode_nhwc(&x_map, x, N, H, W, C, cols, rows);
    if (rc != 0) return rc;
    const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(F),
                                 static_cast<cuuint64_t>(C),
                                 static_cast<cuuint64_t>(K) * K};
    const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(F) * 2,
                                    static_cast<cuuint64_t>(C) * F * 2};
    const cuuint32_t wbox[3] = {64, 64, 1};
    rc = encode_bf16_sw128(&w_map, w, 3, wdims, wstrides, wbox);
    if (rc != 0) return rc;
    return steps == 64 ? launch_bwc<64>(x_map, w_map, a, N, n_tiles,
                                        smem_bytes, s)
                       : launch_bwc<128>(x_map, w_map, a, N, n_tiles,
                                         smem_bytes, s);
  }
  BfArgs a;
  a.rows = rows;
  a.cols = cols;
  a.depth = K * K * C;
  if (stages < 2 || stages > kMaxStages || (n_split > 1 && parts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.n_tg = 1;
  a.n_items = (a.depth + steps * kBfStepC - 1) / (steps * kBfStepC);
  const long long wbytes = static_cast<long long>(a.rows) * a.cols * C * 2;
  a.win_bytes = static_cast<int>((wbytes + 127) / 128 * 128);
  a.stage_bytes = steps * kU8StepB;
  const long long smem = a.win_bytes +
                         static_cast<long long>(steps) * kU8AStepB +
                         static_cast<long long>(stages) * a.stage_bytes;
  a.n_f = (F + kU8Fb - 1) / kU8Fb;
  if (n_split > a.n_items || smem != smem_bytes ||
      static_cast<long long>(a.n_f) * n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = bias;
  a.bias_bf16 = bias_bf16;
  a.relu = relu;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.parts = static_cast<float*>(parts);
  a.N = N; a.H = H; a.W = W; a.C = C; a.K = K; a.F = F;
  a.H_O = H_O; a.W_O = W_O; a.S = stride; a.pad = pad;
  a.TH = TH; a.TW = TW;
  a.n_tw = (W_O + TW - 1) / TW;
  a.steps = steps; a.n_split = n_split; a.stages = stages;
  a.vec_w = F % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return launch_bf16_gather(a, smem_bytes, s);
}

}  // extern "C"
