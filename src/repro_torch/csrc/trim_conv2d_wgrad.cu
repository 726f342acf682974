// TrIM conv2d weight gradient for Hopper (sm_90a): the port of the Pallas
// kernel `_trim_conv2d_wgrad_kernel` (src/repro/kernels/trim_conv2d_vjp.py:92).
//
// Two lanes: fp32 on the CUDA cores (below) and bf16 on the tensor cores
// (fp32 sums), in their own sections further down: the window path on
// wgmma and TMA (`trim_conv2d_wgrad_bf16_window_kernel`, C and F
// multiples of 8: every VGG-16 and AlexNet layer but CL1, each operand
// read once a block for all K*K taps) and a 64 x 64 GEMM over im2col rows
// on mma.sync (`trim_conv2d_wgrad_bf16_kernel`: the rest, VGG-16 CL1's C =
// 3, whose 6-byte rows no tensor map can describe).  What the fp32 lane
// computes (IEEE, no TF32):
//   dw[kh, kw, c, f] = sum_{n, ho, wo} x[n, ho*S - p + kh, wo*S - p + kw, c]
//                                      * g[n, ho, wo, f]
// over NHWC activations x (N,H,W,C) and the output cotangent g
// (N,H_O,W_O,F), giving dw (K,K,C,F).  Input pixels outside the image
// count as zero: the haloed window is zero-filled as it is loaded, so no
// padded copy of x exists.
//
// What bounds it: an implicit GEMM with M = K*K*C rows (tap, channel), F
// columns and a reduction over the P = N*H_O*W_O output pixels.  Every
// VGG-16 layer but CL1 does far more operations per byte than the
// H100's fp32 ridge (about 20 FLOP/byte), so it is bound by fp32
// operations; CL1 (C = 3) is bound by the bytes of g.  The design keeps
// the FMA pipes fed from registers:
//
// - A block owns all K*K taps of a (Cb channels x Fb filters) tile of dw,
//   and each thread a register tile of it: 8 (tap, channel) rows x 8
//   filters (64 accumulators), or on the K = 3 path 9 taps x 8 filters
//   (72).  Per output pixel a thread reads its rows' window values and
//   its filters' cotangent values from shared memory and does 64 (72)
//   FMAs.  Three paths:
//   * K = 3 at stride 1 (every VGG-16 layer but CL1): 32 channels x 64
//     filters in eight warps, a thread the nine taps of one channel.  It
//     walks an output row left to right with the 3 x 3 window of its
//     channel in registers, so a pixel reads one new window column (3
//     scalar loads, each value then serves three taps) and two 16-byte
//     cotangent loads for 72 FMAs.  Eight warps (not the nine of the
//     next path at this tile) give each of the SM's four schedulers the
//     same share of the FMAs.
//   * Cb a multiple of 8 (C >= 8, other K or S): a thread's 8 rows are 8
//     channels of one tap, so its operands come in four 16-byte loads
//     (two of the window, two of the cotangent): 16 FMAs per LDS.128.
//   * C < 8 (VGG-16 CL1, AlexNet CL1): the rows run over (tap, channel)
//     and the window values come in 8 scalar loads.
// - The TrIM dataflow: for each reduction item (one image, one TH x TW
//   output tile) the haloed window ((TH-1)*S+K) x ((TW-1)*S+K) x Cb is
//   loaded into shared memory once, channel innermost ([rows][cols][Cbp],
//   each position padded to Cbp floats where a quarter warp would read
//   two taps' channel quads in one bank), beside the cotangent tile
//   [TH*TW][Fb].  All K*K taps read the window through stride-S shifted
//   views; all the block's (tap, channel) rows read the cotangent tile.
//   Lanes run over the filter groups fastest, so a quarter warp reads one
//   window value or quad (a broadcast) and eight neighbouring cotangent
//   quads.
// - Asynchronous staging: the next item's window and cotangent tile are
//   copied with cp.async into the second of two stages while the current
//   one is consumed; 16-byte copies where C (or F) % 4 == 0, 4-byte ones
//   otherwise; the halo and anything past C or F are zero-filled with a
//   source size of 0.
// - Output rows or columns past H_O/W_O are never visited, so input rows
//   that no output reads (when (H+2p-K) % S > 0) contribute nothing.
//
// On the H100 it reaches about half the fp32 peak at VGG-16's shapes; the
// 16-byte-row loop with its shared loads taken out was not much faster, so
// what holds it is the FMA issue itself (register banks, scheduling), not
// the loads.
//
// What the TPU did in order and Hopper cannot: the Pallas grid carries the
// dw scratch across the sequential batch/spatial axes.  Here the
// reduction over (image, output tile) items is cut into n_split ranges so
// that the card has enough blocks when dw has only a few tiles (VGG-16
// CL1 has one).  Each range writes its fp32 partial dw to a workspace
// slab exactly once, and a second kernel sums the slabs in a fixed order
// (up to 32 thread rows a column of elements, each over every 32nd slab,
// then the rows in order): no atomics, so the result is the same on every
// run.  With n_split == 1 the block writes dw itself.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// Threads a block may have: nine warps (AlexNet CL1's 46 row groups x 6
// filter groups need 276).  The 16-byte-row kernel asks for two such
// blocks an SM: its registers then stay within 96 a thread (18 warps over
// the SM's four register files of 16384); the scalar-row kernel, whose
// eight row offsets would spill there, asks for one.
constexpr int kMaxThreads = 288;
constexpr int kMinBlocksVec = 2;
constexpr int kMinBlocksScalar = 1;
constexpr int kStages = 2;
// The K = 3, stride-1 path: 32 channels x 64 filters in eight warps; two
// blocks fit an SM (its 113 or so registers a thread, 112 KB of shared
// memory), 16 warps: four on each of the SM's schedulers, where the nine
// warps of the 16-byte-row path leave one scheduler a third more.  Its
// launch bounds ask for one block: capped for two, ptxas scheduled the
// same registers slower on the H100.
constexpr int kK3Cb = 32, kK3Fb = 64, kK3Threads = 256, kK3MinBlocks = 1;

// Kernel paths (the wrapper's WgradTile.path).
enum Path { kScalarRows = 0, kVecRows = 1, kK3Taps = 2 };

struct WgradArgs {
  const float* x;
  const float* g;
  float* out;  // dw (n_split == 1) or the workspace's n_split partial slabs
  int N, H, W, C, K, F, H_O, W_O, S, pad;
  int TH, TW, n_th, n_tw, Cb, Cbp, Fb, n_f, n_split;
  int rows, cols;       // the haloed window of one item
  int xs_floats;        // the window's floats in a stage (16-byte multiple)
  int stage_floats;     // window + cotangent tile
  int work;             // threads that hold a register tile
  int vec_x, vec_g, vec_out;
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

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Item {
  int n, oh0, ow0, vh, vw;
};

__device__ __forceinline__ Item item_of(const WgradArgs& a, int it) {
  const int per_img = a.n_th * a.n_tw;
  Item r;
  r.n = it / per_img;
  const int t = it - r.n * per_img;
  const int th = t / a.n_tw;
  r.oh0 = th * a.TH;
  r.ow0 = (t - th * a.n_tw) * a.TW;
  r.vh = min(a.TH, a.H_O - r.oh0);
  r.vw = min(a.TW, a.W_O - r.ow0);
  return r;
}

// Issue the cp.async copies of one item's window and cotangent tile into
// ``stage`` (every thread of the block takes part).  Cb, Cbp and Fb are
// the kernel's, compile-time constants where it is specialised.  A
// thread's copies are blockDim.x apart; their (row, column, quad) is
// stepped by carries, not divided out for every copy.
__device__ __forceinline__ void load_item(const WgradArgs& a, float* stage,
                                          int it, int c0, int f0, int Cb,
                                          int Cbp, int Fb) {
  const Item t = item_of(a, it);
  const int ih0 = t.oh0 * a.S - a.pad, iw0 = t.ow0 * a.S - a.pad;
  const float* x = a.x + static_cast<size_t>(t.n) * a.H * a.W * a.C;
  const float* g = a.g + static_cast<size_t>(t.n) * a.H_O * a.W_O * a.F;
  const int step = blockDim.x;
  {
    // Haloed input window, [rows][cols][Cbp]: zero outside the image and
    // past C (the Cbp - Cb padding floats are never read).
    const int xw = a.vec_x ? 4 : 1;
    const int xq = Cb / xw;  // copies a window position
    const int total = a.rows * a.cols * xq;
    const int pos = threadIdx.x / xq, dpos = step / xq;
    const int dc = step - dpos * xq, dr = dpos / a.cols;
    const int dq = dpos - dr * a.cols;
    int c = threadIdx.x - pos * xq, r = pos / a.cols, q = pos - r * a.cols;
    for (int i = threadIdx.x; i < total; i += step) {
      const int h = ih0 + r, w = iw0 + q, cc = c0 + c * xw;
      const bool ok = static_cast<unsigned>(h) < static_cast<unsigned>(a.H) &&
                      static_cast<unsigned>(w) < static_cast<unsigned>(a.W) &&
                      cc < a.C;
      const float* src = ok ? x + (h * a.W + w) * a.C + cc : a.x;
      float* dst = stage + (r * a.cols + q) * Cbp + c * xw;
      if (a.vec_x)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
      c += dc;
      q += dq;
      r += dr;
      if (c >= xq) { c -= xq; ++q; }
      if (q >= a.cols) { q -= a.cols; ++r; }
    }
  }
  {
    // Cotangent tile, [TH*TW][Fb]: zero past F and outside the valid
    // vh x vw corner (those pixels are never read).
    float* gs = stage + a.xs_floats;
    const int gw = a.vec_g ? 4 : 1;
    const int gq = Fb / gw;
    const int total = a.TH * a.TW * gq;
    const int pix = threadIdx.x / gq, dpix = step / gq;
    const int df = step - dpix * gq, dh = dpix / a.TW;
    const int dw = dpix - dh * a.TW;
    int f = threadIdx.x - pix * gq, lh = pix / a.TW, lw = pix - lh * a.TW;
    for (int i = threadIdx.x; i < total; i += step) {
      const int ff = f0 + f * gw;
      const bool ok = lh < t.vh && lw < t.vw && ff < a.F;
      const float* src =
          ok ? g + ((t.oh0 + lh) * a.W_O + t.ow0 + lw) * a.F + ff : a.g;
      float* dst = gs + (lh * a.TW + lw) * Fb + f * gw;
      if (a.vec_g)
        cp_async16(dst, src, ok);
      else
        cp_async4(dst, src, ok);
      f += df;
      lw += dw;
      lh += dh;
      if (f >= gq) { f -= gq; ++lw; }
      if (lw >= a.TW) { lw -= a.TW; ++lh; }
    }
  }
}

// kVecRows: Cb % 8 == 0, a thread's 8 rows are channels cg*4 + {0..3} and
// Cb/2 + cg*4 + {0..3} of one tap (two 16-byte window loads a pixel).
// Otherwise its rows are the flattened (tap, channel) rows rg*8 .. rg*8+7
// of the block (eight scalar window loads a pixel).  Either way its
// filters are fg*4 + {0..3} and Fb/2 + fg*4 + {0..3}.
template <bool kVecRows>
__global__ void __launch_bounds__(kMaxThreads,
                                  kVecRows ? kMinBlocksVec : kMinBlocksScalar)
trim_conv2d_wgrad_kernel(const WgradArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int K = a.K, KK = K * K;
  const int Cb = a.Cb, Cbp = a.Cbp, Fb = a.Fb;
  const int FG = Fb / 8;
  const int c0 = (blockIdx.x / a.n_f) * Cb;
  const int f0 = (blockIdx.x % a.n_f) * Fb;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const bool active = tid < a.work;
  const int fg = tid % FG, rg = tid / FG;
  const int half_c = Cb / 2, half_f = Fb / 2;

  // Shared-memory offset of each row inside the window at pixel (0, 0).
  int xoff[kVecRows ? 1 : 8];
  int vtap = 0, vcg = 0;
  if (kVecRows) {
    const int cq = Cb / 8;
    vtap = rg / cq;
    vcg = rg - vtap * cq;
    xoff[0] = active ? ((vtap / K) * a.cols + vtap % K) * Cbp + vcg * 4 : 0;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = rg * 8 + j;
      const int tap = r / Cb, c = r - (r / Cb) * Cb;
      xoff[j] = (active && r < KK * Cb)
                    ? ((tap / K) * a.cols + tap % K) * Cbp + c
                    : 0;
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const long long items = static_cast<long long>(a.n_th) * a.n_tw * a.N;
  const int i0 = static_cast<int>(items * split / a.n_split);
  const int i1 = static_cast<int>(items * (split + 1) / a.n_split);
  const int sx = a.S * Cbp;            // one output column in the window
  const int sy = a.S * a.cols * Cbp;   // one output row in the window

  if (i0 < i1) load_item(a, smem, i0, c0, f0, Cb, Cbp, Fb);
  cp_async_commit();
  for (int it = i0; it < i1; ++it) {
    const int stage = (it - i0) & 1;
    if (it + 1 < i1)
      load_item(a, smem + (stage ^ 1) * a.stage_floats, it + 1, c0, f0, Cb,
                Cbp, Fb);
    cp_async_commit();
    cp_async_wait_one();  // this item's group has landed
    __syncthreads();
    if (active) {
      const Item t = item_of(a, it);
      const float* xs = smem + stage * a.stage_floats;
      const float* gs = xs + a.xs_floats + fg * 4;
      for (int lh = 0; lh < t.vh; ++lh) {
        const float* xp = xs + lh * sy;
        const float* gp = gs + lh * a.TW * Fb;
#pragma unroll 2
        for (int lw = 0; lw < t.vw; ++lw) {
          float av[8], bv[8];
          if (kVecRows) {
            const float4 a0 = *reinterpret_cast<const float4*>(xp + xoff[0]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(xp + xoff[0] + half_c);
            av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
            av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) av[j] = xp[xoff[kVecRows ? 0 : j]];
          }
          const float4 b0 = *reinterpret_cast<const float4*>(gp);
          const float4 b1 = *reinterpret_cast<const float4*>(gp + half_f);
          bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
          bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          xp += sx;
          gp += Fb;
        }
      }
    }
    __syncthreads();  // every read of this stage is done before its refill
  }

  // One write per element: this range's partial (or dw itself).
  if (!active) return;
  float* out = a.out + static_cast<size_t>(split) * KK * a.C * a.F;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int tap, c;
    if (kVecRows) {
      tap = vtap;
      c = (i < 4 ? 0 : half_c) + vcg * 4 + (i & 3);
    } else {
      const int r = rg * 8 + i;
      if (r >= KK * Cb) continue;
      tap = r / Cb;
      c = r - tap * Cb;
    }
    const int cc = c0 + c;
    if (cc >= a.C) continue;
    float* row = out + (static_cast<size_t>(tap) * a.C + cc) * a.F + f0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = h * half_f + fg * 4;
      if (a.vec_out) {
        if (f0 + f < a.F)
          *reinterpret_cast<float4*>(row + f) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                          acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (f0 + f + k < a.F) row[f + k] = acc[i][h * 4 + k];
      }
    }
  }
}

// One window column of the K = 3 path: rows lh .. lh + 2 at one channel.
__device__ __forceinline__ void k3_column(float (&col)[3], const float* p,
                                          int row) {
  col[0] = p[0];
  col[1] = p[row];
  col[2] = p[2 * row];
}

// One pixel of the K = 3 path: tap (kh, kw) takes column kw's row kh
// (a, b, c are the columns of kw = 0, 1, 2) against the pixel's 8
// cotangent values at gp (filters fg*4 + {0..3}, 32 + fg*4 + {0..3}).
__device__ __forceinline__ void k3_step(float (&acc)[9][8],
                                        const float (&a)[3],
                                        const float (&b)[3],
                                        const float (&c)[3],
                                        const float* gp) {
  const float4 b0 = *reinterpret_cast<const float4*>(gp);
  const float4 b1 = *reinterpret_cast<const float4*>(gp + kK3Fb / 2);
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int kh = 0; kh < 3; ++kh)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[kh * 3][j] = fmaf(a[kh], bv[j], acc[kh * 3][j]);
      acc[kh * 3 + 1][j] = fmaf(b[kh], bv[j], acc[kh * 3 + 1][j]);
      acc[kh * 3 + 2][j] = fmaf(c[kh], bv[j], acc[kh * 3 + 2][j]);
    }
}

// The K = 3, stride-1 path (every VGG-16 layer): a thread holds the nine
// taps of one channel for 8 filters (72 accumulators) and walks each
// output row left to right with the window's 3 x 3 neighbourhood of its
// channel in registers, so each step reads one new window column (3
// scalar loads, each value reused by three taps: the triangular input
// movement of TrIM) and the pixel's 8 cotangent values (2 x LDS.128) for
// 72 FMAs.  Lanes run over the 8 filter groups fastest, so a warp reads
// 4 neighbouring channels (one wavefront) and 8 neighbouring cotangent
// quads (one wavefront).
__global__ void __launch_bounds__(kK3Threads, kK3MinBlocks)
trim_conv2d_wgrad_k3_kernel(const WgradArgs a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int Cb = kK3Cb, Fb = kK3Fb;
  const int tid = threadIdx.x;
  const int fg = tid % 8, c = tid / 8;
  const int c0 = (blockIdx.x / a.n_f) * Cb;
  const int f0 = (blockIdx.x % a.n_f) * Fb;
  const int split = blockIdx.y;
  const int row = a.cols * Cb;  // one window row

  float acc[9][8];
#pragma unroll
  for (int i = 0; i < 9; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const long long items = static_cast<long long>(a.n_th) * a.n_tw * a.N;
  const int i0 = static_cast<int>(items * split / a.n_split);
  const int i1 = static_cast<int>(items * (split + 1) / a.n_split);

  if (i0 < i1) load_item(a, smem, i0, c0, f0, Cb, Cb, Fb);
  cp_async_commit();
  for (int it = i0; it < i1; ++it) {
    const int stage = (it - i0) & 1;
    if (it + 1 < i1)
      load_item(a, smem + (stage ^ 1) * a.stage_floats, it + 1, c0, f0, Cb,
                Cb, Fb);
    cp_async_commit();
    cp_async_wait_one();  // this item's group has landed
    __syncthreads();
    const Item t = item_of(a, it);
    const float* xs = smem + stage * a.stage_floats + c;
    const float* gs = smem + stage * a.stage_floats + a.xs_floats + fg * 4;
    for (int lh = 0; lh < t.vh; ++lh) {
      // columns lw, lw + 1, lw + 2 of the window's rows lh .. lh + 2 at
      // channel c; the three arrays take the three roles in turn
      const float* xp = xs + lh * row;
      float u[3], v[3], w[3];
      k3_column(u, xp, row);
      k3_column(v, xp + Cb, row);
      xp += 2 * Cb;
      const float* gp = gs + lh * a.TW * Fb;
      for (int lw = 0; lw < t.vw; lw += 3) {
        k3_column(w, xp, row);
        k3_step(acc, u, v, w, gp);
        if (lw + 1 == t.vw) break;
        k3_column(u, xp + Cb, row);
        k3_step(acc, v, w, u, gp + Fb);
        if (lw + 2 == t.vw) break;
        k3_column(v, xp + 2 * Cb, row);
        k3_step(acc, w, u, v, gp + 2 * Fb);
        xp += 3 * Cb;
        gp += 3 * Fb;
      }
    }
    __syncthreads();  // every read of this stage is done before its refill
  }

  // One write per element: this range's partial (or dw itself).
  const int cc = c0 + c;
  if (cc >= a.C) return;
  float* out = a.out + static_cast<size_t>(split) * 9 * a.C * a.F;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    float* dst = out + (static_cast<size_t>(tap) * a.C + cc) * a.F + f0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = h * (Fb / 2) + fg * 4;
      if (a.vec_out) {
        if (f0 + f < a.F)
          *reinterpret_cast<float4*>(dst + f) =
              make_float4(acc[tap][h * 4], acc[tap][h * 4 + 1],
                          acc[tap][h * 4 + 2], acc[tap][h * 4 + 3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (f0 + f + k < a.F) dst[f + k] = acc[tap][h * 4 + k];
      }
    }
  }
}

// dw[i] = the sum of the n_split slabs' i-th elements in a fixed order,
// no atomics.  A block of 256 threads takes L = 256 / G consecutive
// elements; its G thread rows (G = n_split rounded down to a power of 2,
// at most 32) sum the slabs k = row, row + G, ... in order, and row 0 then
// adds the G row sums in row order.  The order depends on n_split alone,
// so every run gives the same bits.
__global__ void __launch_bounds__(256)
trim_conv2d_wgrad_reduce(const float* __restrict__ ws, float* __restrict__ dw,
                         long long M, int n_split, int G) {
  __shared__ float part[256];
  const int L = 256 / G;
  const int lane = threadIdx.x % L, row = threadIdx.x / L;
  for (long long base = static_cast<long long>(blockIdx.x) * L; base < M;
       base += static_cast<long long>(gridDim.x) * L) {
    const long long i = base + lane;
    float s = 0.f;
    if (i < M) {
#pragma unroll 4
      for (int k = row; k < n_split; k += G) s += ws[k * M + i];
    }
    part[threadIdx.x] = s;
    __syncthreads();
    if (row == 0 && i < M) {
      float t = part[lane];
      for (int r = 1; r < G; ++r) t += part[r * L + lane];
      dw[i] = t;
    }
    __syncthreads();
  }
}

// The dynamic shared memory a kernel may take, raised once to the most any
// launch has asked for (the attribute call costs host time on every launch
// otherwise), with the carveout at its most shared memory so that two
// blocks fit.
int launch(void (*kern)(WgradArgs), int& smem_set, const WgradArgs& a,
           int n_c, int threads, int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem_bytes;
  }
  const dim3 grid(n_c * a.n_f, a.n_split);
  kern<<<grid, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------- bf16 lane, GEMM path
//
// Where C or F is not a multiple of 8 (VGG-16 CL1: C = 3; its window path
// is below): dw as one GEMM on the tensor cores, mma.sync m16n8k16 bf16 ->
// fp32: M =
// K*K*C depth rows (tap, channel) in w's own (K, K, C, F) order, N = F,
// and the reduction over the P = N*H_O*W_O output pixels as the k of the
// product.  A block owns 64 depth rows x 64 filters (four warps of 32 x
// 32) and walks its range of 64-pixel chunks through a 3-stage cp.async
// ring.  A chunk's stage holds the im2col rows of x ([64 pixels][64 depth
// values]: pixel q's input at (ho*S - p + kh, wo*S - p + kw), zero outside
// the image) and g's rows ([64 pixels][64 filters]) as they lie; both have
// the pixels as rows, so ldmatrix.trans reads A and B with the pixels as
// k.  Each 128-byte row's 16-byte units are swizzled by the row, so every
// ldmatrix phase (8 consecutive pixels, one unit) hits 8 bank groups.
// The pixel chunks are cut into n_split contiguous ranges (the wrapper's
// wgrad_bf16_tile, from the shape); each range writes its fp32 partial
// once and trim_conv2d_wgrad_reduce sums them in a fixed order, so every
// call gives the same bits.  What bounds it: the same operations as the
// forward conv at bf16's 989 TFLOP/s; CL1's 27 depth rows fill 27 of 64.

constexpr int kBwThreads = 128, kBwM = 64, kBwN = 64, kBwP = 64;
constexpr int kBwStages = 3;
constexpr int kBwTile = kBwP * 128;          // one operand's bytes a stage
constexpr int kBwSmem = kBwStages * 2 * kBwTile;

struct WgradBf16Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* g;
  float* out;  // dw (n_split == 1) or the n_split partial slabs
  int N, H, W, C, K, F, H_O, W_O, S, pad;
  int depth, n_m, n_chunks, n_split, P;
  int vec_x, vec_g;
};

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte unit u of pixel row r in a [64][128 bytes] tile.
__device__ __forceinline__ int bw_off(int r, int u) {
  return (r << 7) + ((u ^ (r & 7)) << 4);
}

// Issue chunk ``ch``'s copies into stage ``st`` (A tile, then B tile).
// Thread t copies unit t & 7 of pixel rows (t >> 3) + 16 i: depth values
// d0 .. d0 + 7 (d0 = m0 + 8 (t & 7)) of x and filters f0 + 8 (t & 7) .. of
// g; pixels past P, depth past K*K*C and filters past F are zero.
__device__ __forceinline__ void bw_load(const WgradBf16Args& a,
                                        unsigned char* st, int ch, int m0,
                                        int f0) {
  const int u = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const int d0 = m0 + u * 8, f = f0 + u * 8;
  const int KC = a.K * a.C;
  const int kh = d0 / KC, kw = (d0 - kh * KC) / a.C;
  const int c = d0 - kh * KC - kw * a.C;
  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(a.x);
  const unsigned short* g16 = reinterpret_cast<const unsigned short*>(a.g);
#pragma unroll
  for (int i = 0; i < kBwP / 16; ++i) {
    const int r = r0 + 16 * i;
    const int q = ch * kBwP + r;
    const bool okq = q < a.P;
    const int wo = q % a.W_O, t = q / a.W_O;
    const int ho = t % a.H_O, n = t / a.H_O;
    const int ih = ho * a.S - a.pad, iw = wo * a.S - a.pad;
    unsigned char* da = st + bw_off(r, u);
    unsigned char* db = da + kBwTile;
    if (a.vec_x) {
      const int h = ih + kh, w = iw + kw;
      const bool ok = okq && d0 < a.depth &&
                      static_cast<unsigned>(h) < static_cast<unsigned>(a.H) &&
                      static_cast<unsigned>(w) < static_cast<unsigned>(a.W);
      cp_async16(da,
                  ok ? a.x + ((static_cast<size_t>(n) * a.H + h) * a.W + w) *
                                 a.C + c
                     : a.x,
                  ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      int dh = kh, dw = kw, dc = c;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int h = ih + dh, w = iw + dw;
        if (okq && d0 + b < a.depth &&
            static_cast<unsigned>(h) < static_cast<unsigned>(a.H) &&
            static_cast<unsigned>(w) < static_cast<unsigned>(a.W))
          v[b >> 1] |= static_cast<uint32_t>(
                           x16[((static_cast<size_t>(n) * a.H + h) * a.W + w) *
                                   a.C + dc])
                       << (16 * (b & 1));
        if (++dc == a.C) {
          dc = 0;
          if (++dw == a.K) { dw = 0; ++dh; }
        }
      }
      *reinterpret_cast<uint4*>(da) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    const size_t grow = static_cast<size_t>(q) * a.F + f;
    if (a.vec_g) {
      const bool ok = okq && f < a.F;
      cp_async16(db, ok ? a.g + grow : a.g, ok);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (okq && f + b < a.F)
          v[b >> 1] |= static_cast<uint32_t>(g16[grow + b]) << (16 * (b & 1));
      *reinterpret_cast<uint4*>(db) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Grid: (depth tiles x filter tiles, n_split).
__global__ void __launch_bounds__(kBwThreads, 4)
trim_conv2d_wgrad_bf16_kernel(const WgradBf16Args a) {
  extern __shared__ __align__(128) unsigned char smem_bw[];
  const int mt0 = blockIdx.x % a.n_m, ft = blockIdx.x / a.n_m;
  const int split = blockIdx.y;
  const int m0 = mt0 * kBwM, f0 = ft * kBwN;
  const int k0 = static_cast<int>(
      static_cast<long long>(a.n_chunks) * split / a.n_split);
  const int k1 = static_cast<int>(
      static_cast<long long>(a.n_chunks) * (split + 1) / a.n_split);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int mi = lane >> 3, lr = lane & 7;
  // A (depth x pixels) from [pixel][depth]: matrix mi is depth half mi & 1
  // of the m16 tile, pixel half mi >> 1; B (pixels x filters) from
  // [pixel][filter]: matrix mi is pixel half mi & 1, n8 tile 2p + (mi >> 1)
  int aoff[2][4], boff[2][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      aoff[p][ks] = bw_off(16 * ks + 8 * (mi >> 1) + lr,
                           (wm >> 3) + 2 * p + (mi & 1));
      boff[p][ks] = kBwTile + bw_off(16 * ks + 8 * (mi & 1) + lr,
                                     (wn >> 3) + 2 * p + (mi >> 1));
    }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int s = 0; s < kBwStages - 1; ++s) {
    if (k0 + s < k1) bw_load(a, smem_bw + s * 2 * kBwTile, k0 + s, m0, f0);
    cp_async_commit();
  }
  for (int k = k0; k < k1; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kBwStages - 2));
    __syncthreads();  // chunk k landed; chunk k - 1's reads are done
    const int nxt = k + kBwStages - 1;
    if (nxt < k1)
      bw_load(a, smem_bw + ((nxt - k0) % kBwStages) * 2 * kBwTile, nxt, m0,
              f0);
    cp_async_commit();
    const uint32_t base =
        smem_addr(smem_bw + ((k - k0) % kBwStages) * 2 * kBwTile);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        ldsm_x4_t(af[p], base + aoff[p][ks]);
        ldsm_x4_t(bf[p], base + boff[p][ks]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[i][nt], af[i], bf[nt >> 1][(nt & 1) * 2],
                   bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }

  // Accumulator q of tile (i, nt): depth row m0 + wm + 16 i + (lane >> 2)
  // + 8 (q >> 1), filter f0 + wn + 8 nt + (lane & 3) * 2 + (q & 1).
  float* out = a.out + static_cast<size_t>(split) * a.depth * a.F;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * hr;
      if (m >= a.depth) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int f = f0 + wn + 8 * nt + (lane & 3) * 2;
        float* o = out + static_cast<size_t>(m) * a.F + f;
        if (f < a.F) o[0] = acc[i][nt][hr * 2];
        if (f + 1 < a.F) o[1] = acc[i][nt][hr * 2 + 1];
      }
    }
}


// ------------------------------------------------ bf16 lane, window path
//
// dw per tap as a warpgroup MMA with the output pixels as its k: for tap
// (kh, kw), dw[kh, kw] (channels x filters) += A (channels x 16 pixels)
// B (16 pixels x filters), A the input window's shifted view, B the
// cotangent.  A block owns a tap group (all K*K taps at K = 3; 9 a group
// above) of a 64-channel x 64-filter tile of dw and walks its range of
// output chunks (TH x TW output pixels of one image); per chunk it
// brings in, by TMA through the wrapper's tensor maps, the
// haloed input window (64 channels x rows x cols of x (N, H, W, C), the
// out-of-bounds zero fill giving the padding and the channels past C) and
// the cotangent tile (64 filters x TW x TH of g (N, H_O, W_O, F), zero
// past H_O / W_O / F), both in the 128-byte swizzle, into a ring of
// stages guarded by full/empty mbarriers (thread 0 issues the copies,
// each stage's again once every warp has released it).  Every value of
// either is read
// from device memory once per block: the window serves all the block's
// taps through shifted views, the cotangent tile all its taps as B.
// Three consumer warpgroups own one row kh of taps each (3 taps x 64
// channels x 64 filters, 96 fp32 accumulators a thread: 9 taps at 64
// filters would be 288, more than a thread has), so a k16 step of a
// warpgroup is 3 ldmatrix.trans (A from the window at the tap's shifted
// pixels: the row addresses follow the swizzle TMA wrote) and 3 wgmma
// m64n64k16 with B read MN-major from the cotangent tile, its A
// registers double-buffered across steps.  A chunk is always eight k16
// steps (128 pixel rows), unrolled, each lane's window offsets for them
// computed once: the cotangent tile's rows past TH * TW are zeroed once,
// so the padded pixels add nothing, and no step divides.  The split: the
// chunks are cut into ranges to fill the card (dw has few 64 x 64 tiles:
// VGG-16 CL2 one), and up to 8 ranges form a cluster that sums its
// blocks' fp32 sums in rank order through distributed shared memory
// (staged in the idle ring); one partial a cluster reaches device memory,
// and where there are several, trim_conv2d_wgrad_reduce sums them in a
// fixed order.  No atomics: every call gives the same bits.
//
// What bounds it on the H100: per chunk a block moves the window and the
// cotangent tile (about 37 KB) for 8 x 9 products of 64 x 64 x 16; the
// ring, its barriers and those loads alone take about half its time at
// VGG-16's batch-8 shapes (tools/bf16_conv_breakdown.py), the products
// and the A loads the rest.

constexpr int kWpC = 64;        // channels a block: one 128-byte TMA row
constexpr int kWpF = 64;        // filters a block
constexpr int kWpWGs = 3;       // consumer warpgroups
constexpr int kWpTaps = 3;      // taps a warpgroup
constexpr int kWpGroup = kWpWGs * kWpTaps;       // taps a block
// No producer warp: a 13th warp would put four warps on one of the SM's
// four register files and cap every thread at 128 registers (the sums and
// A fragments then spill); with 12, ptxas allows 168.
constexpr int kWpThreads = 128 * kWpWGs;
constexpr int kWpMaxStages = 4;

constexpr int kWpSteps = 8;                     // k16 steps a chunk
constexpr int kWpPix = 16 * kWpSteps;            // pixel rows a chunk

// The split's cluster: its blocks' fp32 sums staged in shared memory as
// [taps][64 channels][16 quads of filters], quad q of row r at q ^ (r & 7)
// (the accumulator layout's stores then meet at most two to a bank), read
// by every block of the cluster.
constexpr int kWpStage = kWpGroup * kWpC * kWpF * 4;
constexpr int kWpMaxCluster = 8;  // the portable cluster size

struct WgradWinArgs {
  float* out;  // dw (one slab), or the n_split / cluster partial slabs
  int C, K, F, H_O, W_O, S, pad;
  int TH, TW, n_th, n_tw, rows, cols;
  int n_chunks, n_split, cluster, n_c, n_f, n_tg, stages;
  int win_bytes, stage_bytes;  // each a multiple of 1024
};

// A window-path block's ring: its tensor maps, the shared-memory base and
// mbarriers, its chunk range and tile origin.
struct WpRing {
  const CUtensorMap* x_map;
  const CUtensorMap* g_map;
  uint32_t sbase, full0, empty0, tx;
  int k0, k1, c0, f0, per_img;
};

// Chunk j into ring stage (j - k0) % stages by TMA (thread 0).
__device__ __forceinline__ void wp_load(const WgradWinArgs& a,
                                        const WpRing& r, int j) {
  const int it = j - r.k0, st = it % a.stages;
  const uint32_t full = r.full0 + 8 * st;
  mbar_arrive_expect_tx(full, r.tx);
  const int n = j / r.per_img, t = j - n * r.per_img;
  const int th = t / a.n_tw, tw = t - th * a.n_tw;
  const uint32_t dst = r.sbase + st * a.stage_bytes;
  tma_load_4d(dst, r.x_map, full, r.c0, tw * a.TW * a.S - a.pad,
              th * a.TH * a.S - a.pad, n);
  tma_load_4d(dst + a.win_bytes, r.g_map, full, r.f0, tw * a.TW, th * a.TH,
              n);
}

// One k16 step s (a compile-time constant) of a consumer warpgroup: the A
// fragments of its three taps from the window at ``wb`` (``base`` the
// lane's window pixel at step s and tap (0, 0), ``toff`` each tap's
// offset), B the cotangent rows 16 s .. 16 s + 15 (``db`` the descriptor
// of row 0); then wait for the step before, whose A registers (the other
// buffer) are then free.  All three taps are issued whether they exist or
// not (a tap past K*K reads tap K*K - 1 and is not written): a wgmma under
// a branch makes ptxas fence every one.
template <int s>
__device__ __forceinline__ void wp_step(float (&acc)[kWpTaps][32],
                                        uint32_t (&af)[kWpTaps][4],
                                        int base, int unit,
                                        const int (&toff)[kWpTaps],
                                        uint32_t wb, uint64_t db) {
#pragma unroll
  for (int j = 0; j < kWpTaps; ++j) {
    const int wp = base + toff[j];
    ldsm_x4_t(af[j], wb + (wp << 7) + (((unit ^ wp) & 7) << 4));
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kWpTaps; ++j)
    wgmma_rs_m64n64(acc[j], af[j], db + (s * 16 * 128 >> 4));
  wgmma_commit();
  wgmma_wait<1>();
}

// Grid: (channel tiles x filter tiles x tap groups, n_split).
__global__ void __launch_bounds__(kWpThreads, 1)
trim_conv2d_wgrad_bf16_window_kernel(const __grid_constant__ CUtensorMap x_map,
                                     const __grid_constant__ CUtensorMap g_map,
                                     const WgradWinArgs a) {
  extern __shared__ unsigned char smem_wp[];
  unsigned char* sm =
      smem_wp + ((1024u - (smem_addr(smem_wp) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(sm);
  const uint32_t full0 = sbase + a.stages * a.stage_bytes;
  const uint32_t empty0 = full0 + 8 * a.stages;
  const int ct = blockIdx.x % a.n_c;
  const int ft = (blockIdx.x / a.n_c) % a.n_f;
  const int tg = blockIdx.x / (a.n_c * a.n_f);
  const int split = blockIdx.y;
  const int c0 = ct * kWpC, f0 = ft * kWpF;
  const int k0 = static_cast<int>(
      static_cast<long long>(a.n_chunks) * split / a.n_split);
  const int k1 = static_cast<int>(
      static_cast<long long>(a.n_chunks) * (split + 1) / a.n_split);
  const int npix = a.TH * a.TW;

  if (threadIdx.x == 0) {
    for (int st = 0; st < a.stages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * kWpWGs);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the cotangent rows past the chunk's pixels, zero in every stage (TMA
  // writes only the TH * TW rows of its box)
  const int pad_units = (kWpPix - npix) * 8;
  for (int i = threadIdx.x; i < a.stages * pad_units; i += blockDim.x) {
    const int st = i / pad_units, u = i - st * pad_units;
    *reinterpret_cast<uint4*>(sm + st * a.stage_bytes + a.win_bytes +
                              npix * 128 + u * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();

  // Thread 0 brings chunk j into stage (j - k0) % stages by TMA: the
  // first stages up front, then each chunk as its stage frees.
  WpRing ring;
  ring.x_map = &x_map;
  ring.g_map = &g_map;
  ring.sbase = sbase;
  ring.full0 = full0;
  ring.empty0 = empty0;
  ring.tx = static_cast<uint32_t>(a.rows * a.cols * 128 + npix * 128);
  ring.k0 = k0;
  ring.k1 = k1;
  ring.c0 = c0;
  ring.f0 = f0;
  ring.per_img = a.n_th * a.n_tw;
  if (threadIdx.x == 0)
    for (int j = k0; j < min(k1, k0 + a.stages); ++j) wp_load(a, ring, j);

  // Consumers: warpgroup wg owns taps tg * 9 + 3 wg + j (j < 3) that
  // exist; warp wq of it channels c0 + 16 wq .. + 15 (the wgmma's rows).
  const int wg = threadIdx.x / 128;
  const int wq = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int KK = a.K * a.K;
  const int tap0 = tg * kWpGroup + wg * kWpTaps;
  const int ntap = max(0, min(kWpTaps, KK - tap0));  // taps written
  int toff[kWpTaps];  // the tap's window-pixel offset
#pragma unroll
  for (int j = 0; j < kWpTaps; ++j) {
    const int t = min(tap0 + j, KK - 1);
    toff[j] = (t / a.K) * a.cols + t % a.K;
  }
  // ldmatrix.trans x4: lane l gives the row address of matrix l >> 3, row
  // l & 7: pixel (l & 7) + 8 ((l >> 3) >> 1) of the step, 16-byte unit
  // (channels) 2 wq + ((l >> 3) & 1): a0..a3 of the A fragment (channels
  // x pixels) come out in order.  The lane's window pixel at tap (0, 0)
  // for each step is the same in every chunk; a pixel past the chunk
  // reads pixel 0 (its cotangent row is zero).
  const int unit = 2 * wq + ((lane >> 3) & 1);
  int base[kWpSteps];
#pragma unroll
  for (int s = 0; s < kWpSteps; ++s) {
    int p = 16 * s + (lane & 7) + 8 * (lane >> 4);
    p = p < npix ? p : 0;
    const int lh = p / a.TW, lw = p - lh * a.TW;
    base[s] = lh * a.S * a.cols + lw * a.S;
  }

  float acc[kWpTaps][32];
#pragma unroll
  for (int j = 0; j < kWpTaps; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.0f;

  // Per chunk its eight k16 steps, unrolled (the A buffers alternate with
  // the step); a chunk's stage is released once the first step of the
  // next has waited for its last, so the products never drain between
  // chunks.
  uint32_t a0[kWpTaps][4], a1[kWpTaps][4];
  int st = 0;
  uint32_t par = 0;
  for (int j = k0; j < k1; ++j) {
    mbar_wait(full0 + 8 * st, par);
    const uint32_t wb = sbase + st * a.stage_bytes;
    const uint64_t db = sw128_desc(wb + a.win_bytes, kWpPix * 128);
    wp_step<0>(acc, a0, base[0], unit, toff, wb, db);
    if (j > k0) {
      // the step before, chunk j - 1's last, is done
      const int sp = st == 0 ? a.stages - 1 : st - 1;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * sp);
      if (threadIdx.x == 0 && j - 1 + a.stages < k1) {
        mbar_wait(empty0 + 8 * sp, (sp == a.stages - 1) ? par ^ 1 : par);
        wp_load(a, ring, j - 1 + a.stages);
      }
    }
    wp_step<1>(acc, a1, base[1], unit, toff, wb, db);
    wp_step<2>(acc, a0, base[2], unit, toff, wb, db);
    wp_step<3>(acc, a1, base[3], unit, toff, wb, db);
    wp_step<4>(acc, a0, base[4], unit, toff, wb, db);
    wp_step<5>(acc, a1, base[5], unit, toff, wb, db);
    wp_step<6>(acc, a0, base[6], unit, toff, wb, db);
    wp_step<7>(acc, a1, base[7], unit, toff, wb, db);
    if (++st == a.stages) {
      st = 0;
      par ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < kWpTaps; ++t) pin(acc[t]);

  // acc[j][4 jj + 2 i + c]: channel c0 + 16 wq + (lane >> 2) + 8 i, filter
  // f0 + 8 jj + 2 (lane & 3) + c of tap tap0 + j.
  const size_t slab = static_cast<size_t>(KK) * a.C * a.F;
  if (a.cluster == 1) {
    // this block's sums: dw itself, or its range's slab
    float* out = a.out + split * slab;
    const bool pair = (a.F & 1) == 0;
#pragma unroll
    for (int j = 0; j < kWpTaps; ++j) {
      if (j >= ntap) break;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = c0 + 16 * wq + (lane >> 2) + 8 * i;
        if (c >= a.C) continue;
        float* row = out + (static_cast<size_t>(tap0 + j) * a.C + c) * a.F;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int f = f0 + 8 * jj + 2 * (lane & 3);
          const float v0 = acc[j][4 * jj + 2 * i];
          const float v1 = acc[j][4 * jj + 2 * i + 1];
          if (pair && f + 1 < a.F) {
            *reinterpret_cast<float2*>(row + f) = make_float2(v0, v1);
          } else {
            if (f < a.F) row[f] = v0;
            if (f + 1 < a.F) row[f + 1] = v1;
          }
        }
      }
    }
    return;
  }
  // The cluster's blocks (consecutive ranges of chunks) sum their sums in
  // rank order through distributed shared memory: each stages its own in
  // the idle ring, then block r adds up rows [576 r / cluster, 576 (r +
  // 1) / cluster) of the (tap, channel) rows over the cluster and writes
  // them to dw (one cluster) or to the cluster's slab.
  __syncthreads();  // every block's products are done: the ring is free
#pragma unroll
  for (int j = 0; j < kWpTaps; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (wg * kWpTaps + j) * kWpC + 16 * wq + (lane >> 2) + 8 * i;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int q = (2 * jj + ((lane & 3) >> 1)) ^ (r & 7);
        *reinterpret_cast<float2*>(sm + (r * kWpF + 4 * q +
                                         2 * (lane & 1)) * 4) =
            make_float2(acc[j][4 * jj + 2 * i], acc[j][4 * jj + 2 * i + 1]);
      }
    }
  cluster_sync();
  const int rank = static_cast<int>(cluster_rank());
  float* out = a.out + static_cast<size_t>(split / a.cluster) * slab;
  constexpr int kRows = kWpGroup * kWpC;
  const int r0 = kRows * rank / a.cluster, r1 = kRows * (rank + 1) / a.cluster;
  for (int e = threadIdx.x; e < (r1 - r0) * (kWpF / 4); e += kWpThreads) {
    const int r = r0 + e / (kWpF / 4), q = e % (kWpF / 4);
    const int tap = tg * kWpGroup + r / kWpC, c = c0 + r % kWpC;
    const int f = f0 + 4 * q;
    if (tap >= KK || c >= a.C || f >= a.F) continue;
    const uint32_t addr = sbase + (r * kWpF + 4 * (q ^ (r & 7))) * 4;
    const float4 v = cluster_sum(addr, a.cluster);
    float* dst = out + (static_cast<size_t>(tap) * a.C + c) * a.F + f;
    if (a.F % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float o[4] = {v.x, v.y, v.z, v.w};
      for (int k = 0; k < 4 && f + k < a.F; ++k) dst[k] = o[k];
    }
  }
  cluster_sync();  // the cluster's reads of this block's sums are done
}

// The fixed-order sum of n_split slabs of M floats into dw.
int launch_reduce(const float* ws, float* dw, long long M, int n_split,
                  cudaStream_t s) {
  int G = 1;
  while (G < 32 && 2 * G <= n_split) G *= 2;
  const long long L = 256 / G;
  const int blocks = static_cast<int>((M + L - 1) / L < 4224 ? (M + L - 1) / L
                                                              : 4224);
  trim_conv2d_wgrad_reduce<<<blocks, 256, 0, s>>>(ws, dw, M, n_split, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Limits the wrapper validates against.
int trim_conv2d_wgrad_max_threads() { return kMaxThreads; }
int trim_conv2d_wgrad_stages() { return kStages; }

const char* trim_conv2d_wgrad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (N,H,W,C) f32, g (N,H_O,W_O,F) f32 -> dw (K,K,C,F) f32.  With
// n_split > 1, ws holds n_split * K*K*C*F floats of scratch.  The caller
// (the Python wrapper) picks the geometry: TH x TW output tiles, Cb
// channels (Cbp floats a window position) and Fb filters per block, the
// path (0: scalar rows, 1: 16-byte rows, Cb % 8 == 0; 2: K = 3 at stride
// 1, 32 x 64), threads per block, n_split ranges, 16-byte copies of x / g
// (vec_x, vec_g) and the shared memory of the two stages, which must
// equal what the kernel computes.  Returns the first launch error's
// cudaError_t, or 0.
int trim_conv2d_wgrad_f32(const void* x, const void* g, void* dw, void* ws,
                          int N, int H, int W, int C, int K, int F, int H_O,
                          int W_O, int stride, int pad, int TH, int TW,
                          int Cb, int Cbp, int Fb, int path, int threads,
                          int n_split, int vec_x, int vec_g, int smem_bytes,
                          void* stream) {
  const int KK = K * K;
  const int rgs = path == kVecRows ? KK * Cb / 8 : (KK * Cb + 7) / 8;
  const int work = path == kK3Taps ? Cb * (Fb / 8) : rgs * (Fb / 8);
  if (path < kScalarRows || path > kK3Taps || Fb < 8 || Fb % 8 != 0 ||
      Cb < 1 || Cbp < Cb || (path == kVecRows && Cb % 8 != 0) ||
      (path == kK3Taps &&
       (K != 3 || stride != 1 || Cb != kK3Cb || Cbp != Cb || Fb != kK3Fb ||
        threads != kK3Threads)) ||
      (vec_x && (Cb % 4 != 0 || C % 4 != 0)) ||
      (Cbp % 4 != 0 && (vec_x || path == kVecRows)) ||
      (vec_g && F % 4 != 0) || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || work > threads || n_split < 1 || TH < 1 ||
      TW < 1 || stride < 1)
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
  // items, and offsets inside one image, index as int
  if (static_cast<long long>(a.n_th) * a.n_tw * N > 0x7fffffffLL ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL ||
      static_cast<long long>(H_O) * W_O * F > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.Cb = Cb; a.Cbp = Cbp; a.Fb = Fb;
  a.n_f = (F + Fb - 1) / Fb;
  a.n_split = n_split;
  a.rows = (TH - 1) * stride + K;
  a.cols = (TW - 1) * stride + K;
  a.xs_floats = (a.rows * a.cols * Cbp + 3) / 4 * 4;
  a.stage_floats = a.xs_floats + TH * TW * Fb;
  a.work = work;
  a.vec_x = vec_x; a.vec_g = vec_g;
  a.vec_out = F % 4 == 0;
  if (smem_bytes != kStages * a.stage_floats * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_c = (C + Cb - 1) / Cb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void (*kern)(WgradArgs) = path == kK3Taps ? &trim_conv2d_wgrad_k3_kernel
                            : path == kVecRows
                                ? &trim_conv2d_wgrad_kernel<true>
                                : &trim_conv2d_wgrad_kernel<false>;
  static int smem_set[3] = {0, 0, 0};  // per path: what launch() has set
  const int rc = launch(kern, smem_set[path], a, n_c, threads, smem_bytes, s);
  if (rc != 0 || n_split == 1) return rc;
  return launch_reduce(static_cast<const float*>(ws), static_cast<float*>(dw),
                       static_cast<long long>(KK) * C * F, n_split, s);
}

// The bf16 lane's tiles: 0-2 the GEMM path's depth rows, filters and
// pixels a chunk; 3-9 the window path's channels, filters, taps a block,
// most stages, pixel rows a chunk, most cluster blocks and the bytes of a
// block's staged sums.
int trim_conv2d_wgrad_bf16_tile(int which) {
  const int v[10] = {kBwM, kBwN, kBwP, kWpC, kWpF, kWpGroup, kWpMaxStages,
                     kWpPix, kWpMaxCluster, kWpStage};
  return which >= 0 && which < 10 ? v[which] : -1;
}

// x (N,H,W,C) bf16, g (N,H_O,W_O,F) bf16 -> dw (K,K,C,F) fp32.  The
// caller (the wrapper's wgrad_bf16_tile) picks the path (0: the 64 x 64
// GEMM over im2col rows, any C and F; 1: the window path, C and F
// multiples of 8, x and g 16-byte aligned), on the window path the TH x
// TW output chunk (TH * TW <= 128), the ring's stages and the cluster
// (1-8 blocks, n_split a multiple of it; the GEMM path 1), n_split, the
// contiguous ranges the chunks are cut into, and the shared memory, which
// must equal what this function computes.  The n_split / cluster
// partials (the ranges', or the clusters' sums of theirs) go to dw where
// there is one, else to ws (that many * K*K*C*F floats), summed into dw
// in a fixed order by a second launch.  Returns the first launch error's
// cudaError_t, or 0.
int trim_conv2d_wgrad_bf16(const void* x, const void* g, void* dw, void* ws,
                           int N, int H, int W, int C, int K, int F, int H_O,
                           int W_O, int stride, int pad, int path, int TH,
                           int TW, int stages, int n_split, int cluster,
                           int smem_bytes, void* stream) {
  const long long P = static_cast<long long>(N) * H_O * W_O;
  const long long depth = static_cast<long long>(K) * K * C;
  if (N < 1 || H < 1 || W < 1 || C < 1 || K < 1 || F < 1 || stride < 1 ||
      pad < 0 || H_O != (H + 2 * pad - K) / stride + 1 ||
      W_O != (W + 2 * pad - K) / stride + 1 || H_O < 1 || W_O < 1 ||
      P > 0x7fffffffLL - kBwP || depth * F > 0x7fffffffLL || n_split < 1 ||
      n_split > 65535 || cluster < 1 || cluster > kWpMaxCluster ||
      n_split % cluster != 0 || (path == 0 && cluster != 1) ||
      (n_split > cluster && ws == nullptr) || (path != 0 && path != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_part = n_split / cluster;  // the partials summed at the end
  float* out = static_cast<float*>(n_part > 1 ? ws : dw);
  if (path == 1) {
    WgradWinArgs a;
    a.out = out;
    a.C = C; a.K = K; a.F = F; a.H_O = H_O; a.W_O = W_O; a.S = stride;
    a.pad = pad; a.TH = TH; a.TW = TW;
    a.n_th = (H_O + TH - 1) / TH;
    a.n_tw = (W_O + TW - 1) / TW;
    a.rows = (TH - 1) * stride + K;
    a.cols = (TW - 1) * stride + K;
    a.n_c = (C + kWpC - 1) / kWpC;
    a.n_f = (F + kWpF - 1) / kWpF;
    a.n_tg = (K * K + kWpGroup - 1) / kWpGroup;
    a.n_split = n_split;
    a.cluster = cluster;
    a.stages = stages;
    a.win_bytes = (a.rows * a.cols * 128 + 1023) / 1024 * 1024;
    a.stage_bytes = a.win_bytes + kWpPix * 128;
    const long long chunks = static_cast<long long>(N) * a.n_th * a.n_tw;
    const long long smem =
        static_cast<long long>(stages) * (a.stage_bytes + 16) + 1024;
    if (C % 8 != 0 || F % 8 != 0 || TH < 1 || TW < 1 ||
        TH * TW > kWpPix || a.rows > 256 || a.cols > 256 || stages < 2 ||
        stages > kWpMaxStages || smem != smem_bytes || smem > 232448 ||
        (cluster > 1 && stages * a.stage_bytes < kWpStage) ||
        chunks > 0x7fffffffLL || n_split > chunks ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
        static_cast<long long>(a.n_c) * a.n_f * a.n_tg > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    a.n_chunks = static_cast<int>(chunks);
    CUtensorMap x_map, g_map;
    int rc = encode_nhwc(&x_map, x, N, H, W, C, a.cols, a.rows);
    if (rc != 0) return rc;
    rc = encode_nhwc(&g_map, g, N, H_O, W_O, F, TW, TH);
    if (rc != 0) return rc;
    static int smem_set = 0;
    if (smem_bytes > smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          trim_conv2d_wgrad_bf16_window_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = smem_bytes;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.n_c * a.n_f * a.n_tg, n_split);
    cfg.blockDim = dim3(kWpThreads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cluster;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, trim_conv2d_wgrad_bf16_window_kernel, x_map, g_map, a);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    WgradBf16Args a;
    a.x = static_cast<const __nv_bfloat16*>(x);
    a.g = static_cast<const __nv_bfloat16*>(g);
    a.out = out;
    a.N = N; a.H = H; a.W = W; a.C = C; a.K = K; a.F = F;
    a.H_O = H_O; a.W_O = W_O; a.S = stride; a.pad = pad;
    a.depth = static_cast<int>(depth);
    a.n_m = static_cast<int>((depth + kBwM - 1) / kBwM);
    a.P = static_cast<int>(P);
    a.n_chunks = static_cast<int>((P + kBwP - 1) / kBwP);
    a.n_split = n_split;
    if (n_split > a.n_chunks || smem_bytes != kBwSmem)
      return static_cast<int>(cudaErrorInvalidValue);
    a.vec_x = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    a.vec_g = F % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
    const int n_f = (F + kBwN - 1) / kBwN;
    static bool smem_set = false;
    if (!smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          trim_conv2d_wgrad_bf16_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kBwSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set = true;
    }
    const dim3 grid(a.n_m * n_f, n_split);
    trim_conv2d_wgrad_bf16_kernel<<<grid, kBwThreads, kBwSmem, s>>>(a);
  }
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_part == 1) return rc;
  return launch_reduce(static_cast<const float*>(ws), static_cast<float*>(dw),
                       depth * F, n_part, s);
}

}  // extern "C"
