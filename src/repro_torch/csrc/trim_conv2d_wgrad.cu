// TrIM conv2d weight gradient for Hopper (sm_90a): the port of the Pallas
// kernel `_trim_conv2d_wgrad_kernel` (src/repro/kernels/trim_conv2d_vjp.py:92).
//
// Two lanes: fp32 on the CUDA cores (below) and bf16 on the tensor cores
// (fp32 sums; `trim_conv2d_wgrad_bf16_kernel`, its own section further
// down).  What the fp32 lane computes (IEEE, no TF32):
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------- bf16 lane
//
// dw as one GEMM on the tensor cores, mma.sync m16n8k16 bf16 -> fp32: M =
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
  const long long M = static_cast<long long>(KK) * C * F;
  int G = 1;
  while (G < 32 && 2 * G <= n_split) G *= 2;
  const long long L = 256 / G;
  const int blocks = static_cast<int>((M + L - 1) / L < 4224 ? (M + L - 1) / L
                                                              : 4224);
  trim_conv2d_wgrad_reduce<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), M, n_split, G);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 lane's tile: depth rows, filters and pixels a block's chunk.
int trim_conv2d_wgrad_bf16_tile(int which) {
  return which == 0 ? kBwM : which == 1 ? kBwN : kBwP;
}

// x (N,H,W,C) bf16, g (N,H_O,W_O,F) bf16 -> dw (K,K,C,F) fp32.  The
// caller (the wrapper's wgrad_bf16_tile) picks n_split, the contiguous
// ranges the 64-pixel chunks are cut into; with n_split > 1, ws holds
// n_split * K*K*C*F floats of scratch.  One call launches the GEMM and,
// split, the fixed-order sum of the ranges.  Returns the first launch
// error's cudaError_t, or 0.
int trim_conv2d_wgrad_bf16(const void* x, const void* g, void* dw, void* ws,
                           int N, int H, int W, int C, int K, int F, int H_O,
                           int W_O, int stride, int pad, int n_split,
                           void* stream) {
  WgradBf16Args a;
  const long long P = static_cast<long long>(N) * H_O * W_O;
  const long long depth = static_cast<long long>(K) * K * C;
  if (N < 1 || H < 1 || W < 1 || C < 1 || K < 1 || F < 1 || stride < 1 ||
      pad < 0 || H_O != (H + 2 * pad - K) / stride + 1 ||
      W_O != (W + 2 * pad - K) / stride + 1 || H_O < 1 || W_O < 1 ||
      P > 0x7fffffffLL - kBwP || depth * F > 0x7fffffffLL || n_split < 1 || n_split > 65535 || (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.out = static_cast<float*>(n_split > 1 ? ws : dw);
  a.N = N; a.H = H; a.W = W; a.C = C; a.K = K; a.F = F;
  a.H_O = H_O; a.W_O = W_O; a.S = stride; a.pad = pad;
  a.depth = static_cast<int>(depth);
  a.n_m = static_cast<int>((depth + kBwM - 1) / kBwM);
  a.P = static_cast<int>(P);
  a.n_chunks = static_cast<int>((P + kBwP - 1) / kBwP);
  a.n_split = n_split;
  if (n_split > a.n_chunks) return static_cast<int>(cudaErrorInvalidValue);
  a.vec_x = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_g = F % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int n_f = (F + kBwN - 1) / kBwN;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || n_split == 1) return rc;
  const long long M = depth * F;
  int G = 1;
  while (G < 32 && 2 * G <= n_split) G *= 2;
  const long long L = 256 / G;
  const int blocks = static_cast<int>((M + L - 1) / L < 4224 ? (M + L - 1) / L
                                                              : 4224);
  trim_conv2d_wgrad_reduce<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dw), M, n_split, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
