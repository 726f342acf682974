// TrIM matmul for Hopper (sm_90a): the port of the Pallas kernel
// `_matmul_kernel` (src/repro/kernels/trim_matmul.py:27), the K = 1 case
// of the TrIM dataflow: a weight-stationary blocked (M, K) @ (K, N) with
// the partial sums of the K axis held on chip and written once.
//
// What it computes: out[m, n] = sum_k a[m, k] * b[k, n] for a (M, K) and
// b (K, N) with row strides lda and ldb (unit column stride), into out
// (M, N) contiguous. Three lanes: bf16 (fp32 accumulation, rounded once
// to bf16 or written as fp32), int8 (exact int32) and fp32 (IEEE fp32
// FMAs, no TF32, fp32 or bf16 out).
//
// The caller names one of four paths (the wrapper's `select_path` picks it
// from the dtype, M, the strides and the pointers' alignment); the entry
// refuses a path that cannot take the operands:
// - wgmma (bf16, M > 16, every base and row stride 16-byte aligned, no
//   row overlapping the next): a 128 x 256 output tile a block; a producer warpgroup, cut to 40
//   registers by setmaxnreg, whose one thread brings 64-deep K tiles of a
//   (one 128-row box, K-major) and of b (four 64-column boxes, MN-major: b
//   as it lies, no transposed copy) in by TMA (128-byte swizzle; the ragged
//   M, N and K edges zero-filled by TMA, no padded copy) into a ring of 4
//   stages with mbarrier full/empty pairs; two consumer warpgroups, raised
//   to 232 registers, each run wgmma m64n256k16 with both operands in
//   shared memory (b's transpose bit set) into 128 fp32 accumulators, one
//   K tile's products in flight while the next tile lands. The outputs are
//   rounded once into the (by then idle) ring and written in whole
//   16-byte chunks of each row. Blocks walk the output in groups of 8 row
//   tiles, so one wave shares b's column panels in L2. The tensor maps
//   are encoded on the host per call.
// - stream (every lane, M <= 16, the decode shape): bound by b's bytes,
//   which are read once, 16 bytes a cp.async, through a 4-stage ring of
//   8 KB tiles. A block owns 128 columns and one split of K (whole tiles,
//   at most 256 rows; the wrapper plans the splits from the shapes alone,
//   about one wave of 4 blocks an SM); a's rows of that split are staged
//   once in shared memory. bf16 runs mma.sync m16n8k16 on a's rows padded
//   to 16, B fragments by ldmatrix.trans, each warp 16 columns over whole
//   tiles; fp32 (IEEE FMAs) and int8 (dp4a, the 4 x 4 bytes of a lane's
//   columns transposed by byte permutes) run on the CUDA cores, each of
//   the 8 warps on every 8th slice of a tile, their partials summed in a
//   fixed tree. The splits are summed by a second small kernel in split
//   order over a workspace: no atomics, the same bits every call.
// - mma (bf16 that is not TMA-aligned, int8 at M > 16): tensor cores
//   through mma.sync (m16n8k16 bf16, m16n8k32 s8), a 128 x 128 tile a
//   block, a 2-stage cp.async ring (element loads where a row start is
//   not 16-byte aligned), int8 B tiles transposed once in shared memory
//   with byte permutes (ldmatrix.trans moves 16-bit elements only).
// - fma (fp32 at M > 16): IEEE FMAs on the CUDA cores, each output's sum
//   in k order; bound by the FMA rate, so the design keeps the FFMA pipes
//   fed: a 128 x 128 tile a block of 128 threads, 8 x 16 outputs a
//   thread in registers; K tiles of 16 through a 4-stage ring, one
//   barrier a tile: b's tiles by cp.async as they lie (16-byte copies;
//   4-byte ones, zero-filled past the edges, where a row start is not
//   16-byte aligned or K, N are not whole 16 bytes), a's loaded into
//   registers three tiles ahead and stored K-major after a tile's FMAs (a
//   warp writes 32 consecutive rows of one k: no bank conflict), so that
//   a k's 8 rows and 16 columns of a thread are six broadcast LDS.128 for
//   128 FFMA, read while the previous k's FFMA run; 64 KB of ring, two
//   blocks an SM; outputs in 16-byte (fp32) or 8-byte (bf16) stores where
//   N is a multiple of 4.
//
// What the TPU kernel keeps out of device memory, and how this one does it:
// the Pallas kernel's (bm, bn) accumulator lives in VMEM scratch across
// the sequential K grid axis; here a block loops over K itself with the
// accumulators in registers, and each output is written once (stream:
// once a split, then merged). The Pallas driver pads a and b to whole
// blocks; here the ragged edges are zero-filled as tiles are loaded.
//
// What bounds it: at granite-3-2b's projections (M = 16384) 2 M N K
// operations against (M K + K N) elements read and M N written: far above
// the ridge, so the tensor-core rate (bf16, int8) or the CUDA cores' fp32
// rate. At decode (M <= 16) the bytes of b: the stream path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {


constexpr int kThreads = 256;
constexpr int kBM = 128;        // rows of out per block
constexpr int kBN = 128;        // columns of out per block
constexpr int kKBytes = 64;     // bytes of K per tile (32 bf16, 64 int8)
constexpr int kALd = 80;        // bytes per A row in shared memory (padded)

struct MatmulArgs {
  const void* a;
  const void* b;
  void* out;
  long long M, N, K, lda, ldb;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x32, row) * b (32x8, col); s8 in, s32 accumulate (wrapping).
__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
struct Lane;

// bf16: a K tile of 32 elements; B staged k-major ([k][n], padded rows).
template <>
struct Lane<__nv_bfloat16> {
  using Acc = float;
  using Raw = uint16_t;
  static constexpr int kBK = 32;
  static constexpr int kBLd = (kBN + 8) * 2;      // bytes per B row
  static constexpr int kBStage = kBK * kBLd;
  static constexpr int kBT = 0;                   // no transposed copy
};

// int8: a K tile of 64 elements; B staged k-major ([k][n], unpadded) and
// transposed once per tile into [n][k] rows of kALd bytes.
template <>
struct Lane<int8_t> {
  using Acc = int;
  using Raw = int8_t;
  static constexpr int kBK = 64;
  static constexpr int kBLd = kBN;
  static constexpr int kBStage = kBK * kBLd;
  static constexpr int kBT = kBN * kALd;
};

template <typename T>
constexpr int tc_smem_bytes() {
  return 2 * kBM * kALd + 2 * Lane<T>::kBStage + Lane<T>::kBT;
}

// One output element, rounded once to the output type.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(int* p, int v) { *p = v; }

// One K tile of a ([kBM][kKBytes] in rows of kALd bytes) and of b
// ([kBK][kBN] in rows of kBLd bytes) into one stage, zero outside
// [0, M) x [0, K) and [0, K) x [0, N). kVec: every row start is 16-byte
// aligned and K, N are whole 16-byte chunks (cp.async, src-size 0 past the
// edge); otherwise element loads.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(unsigned char* as,
                                          unsigned char* bs,
                                          const MatmulArgs& p, long long m0,
                                          long long n0, long long k0) {
  constexpr int kBK = Lane<T>::kBK;
  constexpr int kBLd = Lane<T>::kBLd;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  if (kVec) {
    constexpr int kEl = 16 / sizeof(T);              // elements per chunk
    constexpr int kAChunks = kKBytes / 16;           // per A row
    for (int i = threadIdx.x; i < kBM * kAChunks; i += kThreads) {
      const int r = i / kAChunks;
      const int c = (i % kAChunks) * kEl;
      const long long m = m0 + r, k = k0 + c;
      const bool ok = m < p.M && k < p.K;
      cp_async16(as + r * kALd + c * sizeof(T),
                 a + (ok ? m * p.lda + k : 0), ok);
    }
    constexpr int kBChunks = kBN / kEl;              // per B row
    for (int i = threadIdx.x; i < kBK * kBChunks; i += kThreads) {
      const int r = i / kBChunks;
      const int c = (i % kBChunks) * kEl;
      const long long k = k0 + r, n = n0 + c;
      const bool ok = k < p.K && n < p.N;
      cp_async16(bs + r * kBLd + c * sizeof(T),
                 b + (ok ? k * p.ldb + n : 0), ok);
    }
  } else {
    using Raw = typename Lane<T>::Raw;  // the elements' bits, copied
    const Raw* ar = reinterpret_cast<const Raw*>(a);
    const Raw* br = reinterpret_cast<const Raw*>(b);
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const long long m = m0 + r, k = k0 + c;
      *reinterpret_cast<Raw*>(as + r * kALd + c * sizeof(T)) =
          (m < p.M && k < p.K) ? ar[m * p.lda + k] : Raw(0);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i % kBN;
      const long long k = k0 + r, n = n0 + c;
      *reinterpret_cast<Raw*>(bs + r * kBLd + c * sizeof(T)) =
          (k < p.K && n < p.N) ? br[k * p.ldb + n] : Raw(0);
    }
  }
}

// int8: bs [64 k][128 n] -> bt [128 n][64 k] (rows of kALd bytes); each
// thread moves 4 x 4 byte blocks (four 32-bit words in, four out).
__device__ __forceinline__ void transpose_b_int8(const unsigned char* bs,
                                                 unsigned char* bt) {
  constexpr int kBlocksN = kBN / 4;
  for (int i = threadIdx.x; i < (64 / 4) * kBlocksN; i += kThreads) {
    const int k0 = (i / kBlocksN) * 4;
    const int n0 = (i % kBlocksN) * 4;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(bs + n0);
    const uint32_t w0 = src[(k0 + 0) * (kBN / 4)];
    const uint32_t w1 = src[(k0 + 1) * (kBN / 4)];
    const uint32_t w2 = src[(k0 + 2) * (kBN / 4)];
    const uint32_t w3 = src[(k0 + 3) * (kBN / 4)];
    const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
    const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
    const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
    const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
    *reinterpret_cast<uint32_t*>(bt + (n0 + 0) * kALd + k0) =
        __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(bt + (n0 + 1) * kALd + k0) =
        __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(bt + (n0 + 2) * kALd + k0) =
        __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(bt + (n0 + 3) * kALd + k0) =
        __byte_perm(hi01, hi23, 0x7632);
  }
}

// The tensor-core lanes: T in {bf16, int8}, O the output type.
template <typename T, typename O, bool kVec>
__global__ void __launch_bounds__(kThreads)
trim_matmul_tc_kernel(const MatmulArgs p) {
  using Acc = typename Lane<T>::Acc;
  constexpr int kBK = Lane<T>::kBK;
  constexpr int kBStage = Lane<T>::kBStage;
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                        // 2 stages of A
  unsigned char* bs = smem + 2 * kBM * kALd;       // 2 stages of B
  unsigned char* bt = bs + 2 * kBStage;            // int8: B transposed

  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64;   // the warp's 64 rows
  const int wn = (warp % 4) * 32;   // ... and 32 columns
  const int g8 = lane >> 2;
  const int t4 = lane & 3;

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = Acc(0);

  const long long n_tiles = (p.K + kBK - 1) / kBK;
  load_tile<T, kVec>(as, bs, p, m0, n0, 0);
  cp_async_commit();
  for (long long kt = 0; kt < n_tiles; ++kt) {
    const int st = static_cast<int>(kt & 1);
    if (kt + 1 < n_tiles)
      load_tile<T, kVec>(as + (st ^ 1) * kBM * kALd, bs + (st ^ 1) * kBStage,
                         p, m0, n0, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait_one();  // tile kt has landed (kt + 1 may be in flight)
    __syncthreads();
    const unsigned char* a_st = as + st * kBM * kALd;
    const unsigned char* b_st = bs + st * kBStage;
    // int8: [n][k] rows; one x4 per n tile holds both K steps' b0, b1
    uint32_t bq[4][4];
    if (kInt8) {
      transpose_b_int8(b_st, bt);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldmatrix_x4(bq[j], bt + (wn + j * 8 + (lane & 7)) * kALd +
                               (lane >> 3) * 16);
    }
    // two mma K steps of 32 bytes each
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], a_st + (wm + i * 16 + (lane & 15)) * kALd +
                               ks * 32 + (lane >> 4) * 16);
      uint32_t bf[4][2];
      if (kInt8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf[j][0] = bq[j][2 * ks];
          bf[j][1] = bq[j][2 * ks + 1];
        }
      } else {
        // [k][n] rows, transposed by ldmatrix: two n tiles per x4
        constexpr int kBLd = Lane<T>::kBLd;
        const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, b_st + (ks * 16 + (mi & 1) * 8 + rr) * kBLd +
                                   (wn + j * 8 + (mi >> 1) * 8) * 2);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // every warp is done with stage st (and bt)
  }

  O* out = static_cast<O*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long m = m0 + wm + i * 16 + g8 + (c >> 1) * 8;
        const long long n = n0 + wn + j * 8 + t4 * 2 + (c & 1);
        if (m < p.M && n < p.N) put(out + m * p.N + n, acc[i][j][c]);
      }
}

// ---------------------------------------------------------------------------
// fma path: fp32 at M > 16, on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFBM = 128;                   // rows of out a block
constexpr int kFBN = 128;                   // columns of out a block
constexpr int kFBK = 16;                    // K a stage
constexpr int kFStages = 4;                 // the ring's stages
constexpr int kFThreads = 128;              // 8 x 16 outputs a thread
constexpr int kFA = kFBK * kFBM;            // floats of a's tile, K-major
constexpr int kFB = kFBK * kFBN;            // floats of b's tile
constexpr int kFSmem = kFStages * (kFA + kFB) * 4;  // 65536 bytes
constexpr int kFBlocksPerSM = 2;

// A thread's share of a's K tile: kFAChunks chunks of 4 consecutive k of
// row threadIdx % kFBM.
constexpr int kFAChunks = kFBM * kFBK / 4 / kFThreads;
struct F32AFetch {
  float4 v[kFAChunks];
};

__device__ __forceinline__ int f32_a_k(int q) {
  return (threadIdx.x / kFBM) * 4 + q * 4 * (kFThreads / kFBM);
}

// a's K tile from device memory into registers (zero outside [0, M) x
// [0, K)). kVec: 16-byte loads (row starts 16-byte aligned, K whole 16
// bytes); otherwise element loads.
template <bool kVec>
__device__ __forceinline__ F32AFetch f32_fetch_a(const MatmulArgs& p,
                                                 long long m0, long long k0) {
  const float* a = static_cast<const float*>(p.a);
  const long long m = m0 + threadIdx.x % kFBM;
  F32AFetch f;
#pragma unroll
  for (int q = 0; q < kFAChunks; ++q) {
    const long long k = k0 + f32_a_k(q);
    if (kVec) {
      f.v[q] = m < p.M && k < p.K
                   ? __ldg(reinterpret_cast<const float4*>(a + m * p.lda + k))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      const float* row = a + m * p.lda;
      const bool ok = m < p.M;
      f.v[q] = make_float4(ok && k < p.K ? row[k] : 0.0f,
                           ok && k + 1 < p.K ? row[k + 1] : 0.0f,
                           ok && k + 2 < p.K ? row[k + 2] : 0.0f,
                           ok && k + 3 < p.K ? row[k + 3] : 0.0f);
    }
  }
  return f;
}

// The fetched values into a stage, transposed to K-major ([k][m]): a
// warp's 32 threads hold 32 consecutive rows of one k chunk, so each of
// the stores writes 32 consecutive floats (no bank conflict).
__device__ __forceinline__ void f32_store_a(float* as, const F32AFetch& f) {
  const int r = threadIdx.x % kFBM;
#pragma unroll
  for (int q = 0; q < kFAChunks; ++q) {
    const int k = f32_a_k(q);
    as[(k + 0) * kFBM + r] = f.v[q].x;
    as[(k + 1) * kFBM + r] = f.v[q].y;
    as[(k + 2) * kFBM + r] = f.v[q].z;
    as[(k + 3) * kFBM + r] = f.v[q].w;
  }
}

// 4 bytes global -> shared, asynchronously; zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// b's K tile (kFBK x kFBN, as it lies) into a stage by cp.async, zero
// outside [0, K) x [0, N): 16-byte copies when kVec, else 4-byte ones.
template <bool kVec>
__device__ __forceinline__ void f32_load_b(float* bs, const MatmulArgs& p,
                                           long long n0, long long k0) {
  const float* b = static_cast<const float*>(p.b);
#pragma unroll
  for (int q = 0; q < kFBK * kFBN / 4 / kFThreads; ++q) {
    const int i = threadIdx.x + q * kFThreads;
    const int r = i / (kFBN / 4), c = (i % (kFBN / 4)) * 4;
    const long long k = k0 + r, n = n0 + c;
    float* dst = bs + r * kFBN + c;
    if (kVec) {
      const bool ok = k < p.K && n < p.N;
      cp_async16(dst, ok ? b + k * p.ldb + n : b, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < p.K && n + e < p.N;
        cp_async4(dst + e, ok ? b + k * p.ldb + n + e : b, ok);
      }
    }
  }
}

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kFStages - 2) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four outputs of a row, rounded once each, at p (16-byte aligned for
// fp32, 8-byte for bf16).
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

// One k's fragments of a thread: a's 8 rows (r0 + {0..3}, r0 + 64 +
// {0..3}) and b's 16 columns (c0 + 32h + {0..3}).
struct F32Frag {
  float4 a[2], b[4];
};

__device__ __forceinline__ void f32_frag(F32Frag& f, const float* at,
                                         const float* bt, int k, int r0,
                                         int c0) {
  f.a[0] = *reinterpret_cast<const float4*>(&at[k * kFBM + r0]);
  f.a[1] = *reinterpret_cast<const float4*>(&at[k * kFBM + r0 + 64]);
#pragma unroll
  for (int h = 0; h < 4; ++h)
    f.b[h] = *reinterpret_cast<const float4*>(&bt[k * kFBN + c0 + h * 32]);
}

__device__ __forceinline__ void f32_fma(float (&acc)[8][16],
                                        const F32Frag& f) {
  const float av[8] = {f.a[0].x, f.a[0].y, f.a[0].z, f.a[0].w,
                       f.a[1].x, f.a[1].y, f.a[1].z, f.a[1].w};
  float bv[16];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    bv[4 * h] = f.b[h].x;
    bv[4 * h + 1] = f.b[h].y;
    bv[4 * h + 2] = f.b[h].z;
    bv[4 * h + 3] = f.b[h].w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// The fp32 lane: a kFBM x kFBN tile a block of 128 threads (16 x 8), each
// thread 8 x 16 outputs (rows r0 + {0..3} and r0 + 64 + {0..3}, columns
// c0 + 32h + {0..3}), summed in k order by IEEE FMAs. K tiles of kFBK
// through a kFStages ring, one barrier a tile: b's tiles by cp.async as
// they lie; a's loaded into registers three tiles ahead of use and
// stored K-major after a tile's FMAs, so that a k's 8 rows are two
// broadcast LDS.128 and its 16 columns four (each warp's reads one
// 64- or 128-byte wavefront). Each k's fragments are read while the
// previous k's 128 FFMA run.
template <typename O, bool kVec>
__global__ void __launch_bounds__(kFThreads, kFBlocksPerSM)
trim_matmul_f32_kernel(const MatmulArgs p) {
  extern __shared__ __align__(16) float fsm[];
  float* as = fsm;                      // [kFStages][kFBK][kFBM]
  float* bs = fsm + kFStages * kFA;     // [kFStages][kFBK][kFBN]
  const long long m0 = static_cast<long long>(blockIdx.y) * kFBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kFBN;
  const int r0 = (threadIdx.x / 8) * 4;
  const int c0 = (threadIdx.x % 8) * 4;
  const int nk = static_cast<int>((p.K + kFBK - 1) / kFBK);

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;

  // the ring's first kFStages - 1 tiles
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) {
      f32_store_a(as + s * kFA,
                  f32_fetch_a<kVec>(p, m0, static_cast<long long>(s) * kFBK));
      f32_load_b<kVec>(bs + s * kFB, p, n0, static_cast<long long>(s) * kFBK);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait_stages();  // b's tile t has landed (this thread's copies)
    __syncthreads();         // everyone's, a's too; stage t-1 is free
    const int nxt = t + kFStages - 1;
    const bool more = nxt < nk;
    F32AFetch fa;
    if (more) {
      fa = f32_fetch_a<kVec>(p, m0, static_cast<long long>(nxt) * kFBK);
      f32_load_b<kVec>(bs + (nxt % kFStages) * kFB, p, n0,
                       static_cast<long long>(nxt) * kFBK);
    }
    cp_async_commit();
    const float* at = as + (t % kFStages) * kFA;
    const float* bt = bs + (t % kFStages) * kFB;
    F32Frag f[2];
    f32_frag(f[0], at, bt, 0, r0, c0);
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      if (k + 1 < kFBK) f32_frag(f[(k + 1) & 1], at, bt, k + 1, r0, c0);
      f32_fma(acc, f[k & 1]);
    }
    if (more) f32_store_a(as + (nxt % kFStages) * kFA, fa);
  }
  cp_async_wait_all();

  O* out = static_cast<O*>(p.out);
  const bool row4 = p.N % 4 == 0;  // every 4 columns of a row aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + r0 + (i >> 2) * 64 + (i & 3);
    if (m >= p.M) continue;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const long long n = n0 + c0 + h * 32;
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      if (row4 && n + 4 <= p.N) {
        put4(out + m * p.N + n, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < p.N) put(out + m * p.N + n + j, v[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// stream path: M <= 16, bound by the bytes of b
// ---------------------------------------------------------------------------

constexpr int kSThreads = 256;
constexpr int kSWarps = kSThreads / 32;  // each warp one slice of a tile's K
constexpr int kSCols = 128;              // columns of b a block (4 a lane)
constexpr int kSStages = 4;
constexpr int kSMaxK = 256;              // K rows of one split, at most
constexpr int kSMaxRows = 16;            // rows of a, at most

// 16 bytes global -> shared, asynchronously; the last 16 - bytes of the
// chunk are zero-filled (bytes 0: nothing is read).
__device__ __forceinline__ void cp_async16n(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The stream path's per-lane constants: the accumulator (CUDA-core
// lanes), the elements' bits, the bytes of one staged b row (kSCols columns; bf16 rows padded by
// 16 bytes, so that ldmatrix.trans reads 8 rows conflict-free), the K rows
// of a stage, the bytes of a stage.
template <typename T>
struct StreamLane;
template <>
struct StreamLane<float> {
  using Acc = float;
  using Raw = uint32_t;
  static constexpr int kPitch = kSCols * 4;
  static constexpr int kKT = 16;
  static constexpr int kStage = kKT * kPitch;  // 8192
};
template <>
struct StreamLane<__nv_bfloat16> {
  using Raw = uint16_t;
  static constexpr int kPitch = kSCols * 2 + 16;
  static constexpr int kKT = 32;
  static constexpr int kStage = kKT * kPitch;  // 8704
  // a's rows: kSMaxK bf16 padded by 16 bytes (ldmatrix rows in distinct
  // bank groups)
  static constexpr int kAPitch = kSMaxK * 2 + 16;
};
template <>
struct StreamLane<int8_t> {
  using Acc = int;
  using Raw = int8_t;
  static constexpr int kPitch = kSCols;
  static constexpr int kKT = 64;
  static constexpr int kStage = kKT * kPitch;  // 8192
};

// Shared memory of a stream block. fp32, int8: the ring, then a's rows of
// the split (fp32 [k][kRows], int8 as 32-bit words [k / 4][kRows]); the
// warps' partials are summed in the ring after the loop. bf16: the ring,
// then a as [16][kAPitch bytes].
template <typename T, int kRows>
constexpr int stream_smem_bytes() {
  if constexpr (sizeof(T) == 2)
    return kSStages * StreamLane<T>::kStage +
           kSMaxRows * StreamLane<T>::kAPitch;
  else
    return kSStages * StreamLane<T>::kStage +
           kSMaxK * kRows * static_cast<int>(sizeof(T));
}
static_assert((kSWarps / 2) * 4 * kSMaxRows * 32 * 4 <=
                  kSStages * StreamLane<float>::kStage,
              "the warps' partials fit in the ring");

// One stage: b rows [k0, k0 + kKT) x columns [n0, n0 + kSCols) in rows of
// kPitch bytes, zero outside [0, K) x [0, N). kVec: b's base and row
// stride are 16-byte aligned (cp.async, the chunk at the N edge
// zero-filled past N); otherwise element loads.
template <typename T, bool kVec>
__device__ __forceinline__ void stream_load_b(unsigned char* dst,
                                              const MatmulArgs& p,
                                              long long k0, long long n0) {
  constexpr int kKT = StreamLane<T>::kKT;
  constexpr int kPitch = StreamLane<T>::kPitch;
  constexpr long long kEsz = sizeof(T);
  if (kVec) {
    const unsigned char* b = static_cast<const unsigned char*>(p.b);
    constexpr int kChunks = kSCols * static_cast<int>(kEsz) / 16;
    for (int i = threadIdx.x; i < kKT * kChunks; i += kSThreads) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const long long k = k0 + r;
      const long long n = n0 + c * (16 / kEsz);
      long long bytes = 0;
      if (k < p.K && n < p.N) {
        bytes = (p.N - n) * kEsz;
        bytes = bytes > 16 ? 16 : bytes;
      }
      cp_async16n(dst + r * kPitch + c * 16,
                  b + (bytes > 0 ? (k * p.ldb + n) * kEsz : 0),
                  static_cast<int>(bytes));
    }
  } else {
    using Raw = typename StreamLane<T>::Raw;
    const Raw* b = static_cast<const Raw*>(p.b);
    for (int i = threadIdx.x; i < kKT * kSCols; i += kSThreads) {
      const int r = i / kSCols;
      const int c = i % kSCols;
      const long long k = k0 + r, n = n0 + c;
      *reinterpret_cast<Raw*>(dst + r * kPitch + c * kEsz) =
          (k < p.K && n < p.N) ? b[k * p.ldb + n] : Raw(0);
    }
  }
}

// The split's first K row, and its K tiles (the last split may be short).
template <typename T>
__device__ __forceinline__ int stream_tiles(const MatmulArgs& p,
                                            int split_tiles,
                                            long long* k_first) {
  constexpr int kKT = StreamLane<T>::kKT;
  *k_first = static_cast<long long>(blockIdx.y) * split_tiles * kKT;
  const long long left = (p.K - *k_first + kKT - 1) / kKT;
  return static_cast<int>(left < split_tiles ? left : split_tiles);
}

// One (row, column) output of a split: to out (rounded once) when the
// split is the only one, else to its slice of the workspace.
template <typename O, typename Acc>
__device__ __forceinline__ void stream_put(const MatmulArgs& p, Acc* part,
                                           long long m, long long n, Acc v) {
  if (part == nullptr)
    put(static_cast<O*>(p.out) + m * p.N + n, v);
  else
    part[m * p.N + n] = v;
}

// The CUDA-core lanes: fp32 (IEEE FMAs) and int8 (dp4a, exact). a's rows
// [0, kRows) x K of the split are staged once, zero past M and K (fp32 as
// [k][kRows]; int8 as words [k / 4][kRows] of 4 k each); each lane owns 4
// columns and each of the 8 warps takes every 8th slice of a tile (fp32
// kKT / 8 rows, int8 two quads of 4 rows, the 4 x 4 bytes of a lane's
// columns transposed into one word a column by byte permutes); the warps'
// partials are summed in a fixed tree. Blocks (column block, split); ws
// null: one split, out written directly; else the split's partials go to
// ws (n_split, M, N).
template <typename T, typename O, int kRows, bool kVec>
__global__ void __launch_bounds__(kSThreads, kRows <= 4 ? 4 : 2)
trim_matmul_stream_fma_kernel(const MatmulArgs p, void* ws, int split_tiles) {
  using Acc = typename StreamLane<T>::Acc;
  constexpr int kKT = StreamLane<T>::kKT;
  constexpr int kPitch = StreamLane<T>::kPitch;
  constexpr int kStage = StreamLane<T>::kStage;
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* as = smem + kSStages * kStage;

  const long long n0 = static_cast<long long>(blockIdx.x) * kSCols;
  long long k_first;
  const int nt = stream_tiles<T>(p, split_tiles, &k_first);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

#pragma unroll
  for (int i = 0; i < kSStages - 1; ++i) {
    if (i < nt)
      stream_load_b<T, kVec>(ring + i * kStage, p, k_first + i * kKT, n0);
    cp_async_commit();
  }
  {
    const T* a = static_cast<const T*>(p.a);
    const int rows = nt * kKT;
    if constexpr (kInt8) {
      uint32_t* aw = reinterpret_cast<uint32_t*>(as);
      const int nq = rows / 4;
      for (int i = threadIdx.x; i < kRows * nq; i += kSThreads) {
        const int m = i / nq;
        const int q = i % nq;
        uint32_t w = 0;
        if (m < p.M) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long long k = k_first + 4 * q + j;
            if (k < p.K)
              w |= static_cast<uint32_t>(
                       static_cast<uint8_t>(a[m * p.lda + k]))
                   << (8 * j);
          }
        }
        aw[q * kRows + m] = w;
      }
    } else {
      float* af = reinterpret_cast<float*>(as);
      for (int i = threadIdx.x; i < kRows * rows; i += kSThreads) {
        const int m = i / rows;
        const int k = i % rows;
        af[k * kRows + m] =
            (m < p.M && k_first + k < p.K) ? a[m * p.lda + k_first + k] : 0.0f;
      }
    }
  }

  Acc acc[kRows][4];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = Acc(0);

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kSStages - 2>();  // tile i has landed
    __syncthreads();  // ... for every thread; tile i - 1's stage is free
    const int j = i + kSStages - 1;
    if (j < nt)
      stream_load_b<T, kVec>(ring + (j % kSStages) * kStage, p,
                             k_first + static_cast<long long>(j) * kKT, n0);
    cp_async_commit();
    const unsigned char* bt = ring + (i % kSStages) * kStage;
    if constexpr (kInt8) {
      constexpr int kQuads = kKT / 4 / kSWarps;
      const uint32_t* aw =
          reinterpret_cast<const uint32_t*>(as) + i * (kKT / 4) * kRows;
#pragma unroll
      for (int qq = 0; qq < kQuads; ++qq) {
        const int q = warp * kQuads + qq;
        const unsigned char* br = bt + 4 * q * kPitch + lane * 4;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(br);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(br + kPitch);
        const uint32_t w2 =
            *reinterpret_cast<const uint32_t*>(br + 2 * kPitch);
        const uint32_t w3 =
            *reinterpret_cast<const uint32_t*>(br + 3 * kPitch);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
        const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
        const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
        int col[4];
        col[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
        col[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
        col[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
        col[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
        const uint32_t* ar = aw + q * kRows;
#pragma unroll
        for (int m4 = 0; m4 < kRows; m4 += 4) {
          const uint4 av = *reinterpret_cast<const uint4*>(ar + m4);
          const int a4[4] = {static_cast<int>(av.x), static_cast<int>(av.y),
                             static_cast<int>(av.z), static_cast<int>(av.w)};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m4 + r][c] = __dp4a(a4[r], col[c], acc[m4 + r][c]);
        }
      }
    } else {
      constexpr int kRowsPer = kKT / kSWarps;
      const float* af = reinterpret_cast<const float*>(as) + i * kKT * kRows;
#pragma unroll
      for (int rr = 0; rr < kRowsPer; ++rr) {
        const int r = warp * kRowsPer + rr;
        const float4 bv =
            *reinterpret_cast<const float4*>(bt + r * kPitch + lane * 16);
        const float* ar = af + r * kRows;
#pragma unroll
        for (int m4 = 0; m4 < kRows; m4 += 4) {
          const float4 av = *reinterpret_cast<const float4*>(ar + m4);
          const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[m4 + q][0] = fmaf(a4[q], bv.x, acc[m4 + q][0]);
            acc[m4 + q][1] = fmaf(a4[q], bv.y, acc[m4 + q][1]);
            acc[m4 + q][2] = fmaf(a4[q], bv.z, acc[m4 + q][2]);
            acc[m4 + q][3] = fmaf(a4[q], bv.w, acc[m4 + q][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The warps' partials, summed in a fixed tree in the ring: warps
  // [h, 2h) hand theirs to warps [0, h), h = 4, 2, 1.
  Acc* buf = reinterpret_cast<Acc*>(ring);
#pragma unroll
  for (int h = kSWarps / 2; h >= 1; h /= 2) {
    if (warp >= h && warp < 2 * h) {
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          buf[(((warp - h) * kRows + m) * 4 + c) * 32 + lane] = acc[m][c];
    }
    __syncthreads();
    if (warp < h) {
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m][c] += buf[((warp * kRows + m) * 4 + c) * 32 + lane];
    }
    __syncthreads();
  }
  if (warp != 0) return;
  Acc* part = ws == nullptr ? nullptr
                            : static_cast<Acc*>(ws) + blockIdx.y * p.M * p.N;
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (m >= p.M) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long n = n0 + lane * 4 + c;
      if (n >= p.N) break;
      stream_put<O>(p, part, m, n, acc[m][c]);
    }
  }
}

// The bf16 lane: mma.sync m16n8k16 on a's rows padded to 16 (zero past
// M), staged once per split as [16][k] bf16 rows; each warp owns 16
// columns (two n8 tiles) over the whole of each K tile, its B fragments by
// ldmatrix.trans from the [k][n] tile, so no partials meet in the block.
template <typename O, bool kVec>
__global__ void __launch_bounds__(kSThreads, 4)
trim_matmul_stream_tc_kernel(const MatmulArgs p, void* ws, int split_tiles) {
  using L = StreamLane<__nv_bfloat16>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* as = smem + kSStages * L::kStage;

  const long long n0 = static_cast<long long>(blockIdx.x) * kSCols;
  long long k_first;
  const int nt = stream_tiles<__nv_bfloat16>(p, split_tiles, &k_first);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

#pragma unroll
  for (int i = 0; i < kSStages - 1; ++i) {
    if (i < nt)
      stream_load_b<__nv_bfloat16, kVec>(ring + i * L::kStage, p,
                                         k_first + i * L::kKT, n0);
    cp_async_commit();
  }
  {
    const uint16_t* a = static_cast<const uint16_t*>(p.a);
    const int rows = nt * L::kKT;
    for (int i = threadIdx.x; i < kSMaxRows * rows; i += kSThreads) {
      const int m = i / rows;
      const int k = i % rows;
      *reinterpret_cast<uint16_t*>(as + m * L::kAPitch + k * 2) =
          (m < p.M && k_first + k < p.K) ? a[m * p.lda + k_first + k]
                                         : uint16_t(0);
    }
  }

  float acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;

  const int mi = lane >> 3, rr = lane & 7;
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kSStages - 2>();  // tile i has landed
    __syncthreads();  // ... for every thread; tile i - 1's stage is free
    const int jn = i + kSStages - 1;
    if (jn < nt)
      stream_load_b<__nv_bfloat16, kVec>(
          ring + (jn % kSStages) * L::kStage, p,
          k_first + static_cast<long long>(jn) * L::kKT, n0);
    cp_async_commit();
    const unsigned char* b_st = ring + (i % kSStages) * L::kStage;
    const unsigned char* a_t = as + i * L::kKT * 2;
#pragma unroll
    for (int ks = 0; ks < L::kKT / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, a_t + (lane & 15) * L::kAPitch + ks * 32 +
                          (lane >> 4) * 16);
      uint32_t r[4];  // [k][n] rows, transposed: two n tiles per x4
      ldmatrix_x4_trans(r, b_st + (ks * 16 + (mi & 1) * 8 + rr) * L::kPitch +
                               (warp * 16 + (mi >> 1) * 8) * 2);
      mma(acc[0], af, r[0], r[1]);
      mma(acc[1], af, r[2], r[3]);
    }
  }
  cp_async_wait<0>();

  // acc[j][c]: row g8 + 8 (c >> 1), column 16 warp + 8 j + 2 t4 + (c & 1)
  float* part = ws == nullptr ? nullptr
                              : static_cast<float*>(ws) +
                                    blockIdx.y * p.M * p.N;
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long m = g8 + (c >> 1) * 8;
      const long long n = n0 + warp * 16 + j * 8 + t4 * 2 + (c & 1);
      if (m < p.M && n < p.N) stream_put<O>(p, part, m, n, acc[j][c]);
    }
}

// out = the splits' partials summed in split order, rounded once; the
// partials are loaded 8 at a time ahead of their sums, so the loads do not
// wait on each other.
template <typename Acc, typename O>
__global__ void __launch_bounds__(256)
trim_matmul_stream_merge(const Acc* ws, O* out, long long MN, int n_split) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * 256) {
    Acc s = Acc(0);
    for (int q0 = 0; q0 < n_split; q0 += 8) {
      Acc v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u < n_split) v[u] = ws[(q0 + u) * MN + i];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q0 + u < n_split) s = q0 + u == 0 ? v[u] : s + v[u];
    }
    put(out + i, s);
  }
}

// ---------------------------------------------------------------------------
// wgmma path: bf16, M > 16, TMA-aligned operands
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;   // a producer and two consumer warpgroups
constexpr int kWgBM = 128;        // rows of out a block (64 a consumer)
constexpr int kWgBN = 256;        // columns of out a block
constexpr int kWgBK = 64;         // K a stage: one 128-byte swizzled row
constexpr int kWgStages = 4;
constexpr int kWgGroup = 8;       // row tiles a raster group
constexpr int kWgA = kWgBM * 128;                 // a's tile, bytes
constexpr int kWgBBox = kWgBK * 128;              // one 64-column box of b
constexpr int kWgB = (kWgBN / 64) * kWgBBox;      // b's tile
constexpr int kWgStage = kWgA + kWgB;             // 48 KB
constexpr int kWgBar = kWgStages * kWgStage;
constexpr int kWgSmem = kWgBar + 2 * kWgStages * 8 + 1024;  // + alignment

// Box (inner x0, outer x1) of a 2-d tensor map into shared memory at
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x0, int x1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(bar)
      : "memory");
}

// d (64 x 256, fp32) += A (64 x 16) B (16 x 256), bf16 in: A from shared
// memory K-major (descriptor da), B from shared memory MN-major (the
// transpose bit set; descriptor db).
__device__ __forceinline__ void wgmma_m64n256_tb(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Two consecutive outputs (n, n + 1) of one row, rounded once.
__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The epilogue's staging of one consumer warpgroup's 64 x 256 outputs in
// the (by then idle) ring: rows padded by 16 bytes, so that the
// accumulator layout's stores (8 rows x 4 column pairs a warp) fall in
// distinct banks.
template <typename O>
struct WgEpilogue {
  static constexpr int kPitch = kWgBN * static_cast<int>(sizeof(O)) + 16;
  static constexpr int kBytes = 64 * kPitch;
  static constexpr int kChunks = kWgBN * static_cast<int>(sizeof(O)) / 16;
  static constexpr int kEl = 16 / static_cast<int>(sizeof(O));
};
static_assert(2 * WgEpilogue<float>::kBytes <= kWgBar,
              "both warpgroups' outputs fit in the ring");

template <typename O>
__global__ void __launch_bounds__(kWgThreads, 1)
trim_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const MatmulArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(sm);
  const uint32_t full0 = sbase + kWgBar;  // full[st] at full0 + 8 st
  const uint32_t empty0 = full0 + 8 * kWgStages;

  // Block -> (row tile, column tile): groups of kWgGroup row tiles, each
  // group's blocks column by column, so the blocks of one wave share b's
  // column panels (and a's row panels) in L2.
  const long long m_tiles = (p.M + kWgBM - 1) / kWgBM;
  const long long n_tiles = (p.N + kWgBN - 1) / kWgBN;
  const long long per_group = kWgGroup * n_tiles;
  const long long bid = blockIdx.x;
  const long long first_m = bid / per_group * kWgGroup;
  const long long rest = m_tiles - first_m;
  const long long gsz = rest < kWgGroup ? rest : kWgGroup;
  const long long in_group = bid % per_group;
  const long long m0 = (first_m + in_group % gsz) * kWgBM;
  const long long n0 = in_group / gsz * kWgBN;
  const int n_k = static_cast<int>((p.K + kWgBK - 1) / kWgBK);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 8);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full, kWgStages tiles ahead.
    regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_k; ++j) {
        const int st = j % kWgStages;
        mbar_wait(empty0 + 8 * st, ((j / kWgStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_arrive_expect_tx(full, kWgStage);
        const uint32_t dst = sbase + st * kWgStage;
        tma_load_2d(dst, &a_map, full, j * kWgBK, static_cast<int>(m0));
#pragma unroll
        for (int q = 0; q < kWgBN / 64; ++q)
          tma_load_2d(dst + kWgA + q * kWgBBox, &b_map, full,
                      static_cast<int>(n0) + 64 * q, j * kWgBK);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64).
  regs_inc<232>();
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128;
  const int warp = (ct % 128) / 32;
  const int lane = ct % 32;
  // acc[4 j + 2 i + c]: row 16 warp + g8 + 8 i, column 8 j + 2 t4 + c
  float acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0.0f;
  for (int j = 0; j < n_k; ++j) {
    const int st = j % kWgStages;
    mbar_wait(full0 + 8 * st, (j / kWgStages) & 1);
    const uint32_t as = sbase + st * kWgStage + wg * 64 * 128;
    const uint32_t bs = sbase + st * kWgStage + kWgA;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      wgmma_m64n256_tb(acc, sw128_desc(as + kk * 32, 16),
                       sw128_desc(bs + kk * 16 * 128, kWgBBox));
    wgmma_commit();
    wgmma_wait<1>();  // tile j - 1's products are done: free its stage
    pin(acc);
    if (j > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % kWgStages));
    }
  }
  wgmma_wait<0>();
  pin(acc);

  // Epilogue: round once into the ring (both warpgroups done reading it),
  // then write whole 16-byte chunks of each row, coalesced.
  using E = WgEpilogue<O>;
  named_barrier(1, 256);
  unsigned char* stage = sm + wg * E::kBytes;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      put2(reinterpret_cast<O*>(stage + (warp * 16 + g8 + 8 * i) * E::kPitch) +
               8 * j + 2 * t4,
           acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  named_barrier(2 + wg, 128);
  O* out = static_cast<O*>(p.out);
  const bool vec = (p.N * static_cast<long long>(sizeof(O))) % 16 == 0;
  for (int e = ct % 128; e < 64 * E::kChunks; e += 128) {
    const int r = e / E::kChunks;
    const int c = e % E::kChunks;
    const long long m = m0 + wg * 64 + r;
    const long long n = n0 + c * E::kEl;
    if (m >= p.M || n >= p.N) continue;
    const unsigned char* src = stage + r * E::kPitch + c * 16;
    O* dst = out + m * p.N + n;
    if (vec && n + E::kEl <= p.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int q = 0; q < E::kEl && n + q < p.N; ++q)
        dst[q] = reinterpret_cast<const O*>(src)[q];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

dim3 grid_of(const MatmulArgs& p) {
  return dim3(static_cast<unsigned>((p.N + kBN - 1) / kBN),
              static_cast<unsigned>((p.M + kBM - 1) / kBM));
}

template <typename T, typename O, bool kVec>
int launch_tc(const MatmulArgs& p, cudaStream_t s) {
  constexpr int kBytes = tc_smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      trim_matmul_tc_kernel<T, O, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  trim_matmul_tc_kernel<T, O, kVec><<<grid_of(p), kThreads, kBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch_tc_any(const MatmulArgs& p, bool vec, cudaStream_t s) {
  return vec ? launch_tc<T, O, true>(p, s) : launch_tc<T, O, false>(p, s);
}

template <typename O, bool kVec>
int launch_f32(const MatmulArgs& p, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      trim_matmul_f32_kernel<O, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.N + kFBN - 1) / kFBN),
                  static_cast<unsigned>((p.M + kFBM - 1) / kFBM));
  trim_matmul_f32_kernel<O, kVec><<<grid, kFThreads, kFSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename O>
int launch_f32_any(const MatmulArgs& p, bool vec, cudaStream_t s) {
  return vec ? launch_f32<O, true>(p, s) : launch_f32<O, false>(p, s);
}

// The splits' partials (n_split > 1) merged in split order into out.
template <typename Acc, typename O>
int launch_merge(const MatmulArgs& p, void* ws, int n_split, cudaStream_t s) {
  const long long MN = p.M * p.N;
  long long blocks = (MN + 255) / 256;
  blocks = blocks < 4096 ? blocks : 4096;
  trim_matmul_stream_merge<Acc, O><<<static_cast<unsigned>(blocks), 256, 0,
                                     s>>>(static_cast<const Acc*>(ws),
                                          static_cast<O*>(p.out), MN,
                                          n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_split_kernel(K kernel, int bytes, const MatmulArgs& p, void* ws,
                        int n_split, int split_tiles, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.N + kSCols - 1) / kSCols),
                  static_cast<unsigned>(n_split));
  kernel<<<grid, kSThreads, bytes, s>>>(p, n_split > 1 ? ws : nullptr,
                                        split_tiles);
  return static_cast<int>(cudaGetLastError());
}

// fp32, int8: 4 rows of a when M <= 4 (and b is 16-byte aligned), else
// 16.
template <typename T, typename O>
int launch_stream_fma(const MatmulArgs& p, bool vec, void* ws, int n_split,
                      int split_tiles, cudaStream_t s) {
  int rc;
  if (vec && p.M <= 4)
    rc = launch_split_kernel(trim_matmul_stream_fma_kernel<T, O, 4, true>,
                             stream_smem_bytes<T, 4>(), p, ws, n_split,
                             split_tiles, s);
  else if (vec)
    rc = launch_split_kernel(trim_matmul_stream_fma_kernel<T, O, 16, true>,
                             stream_smem_bytes<T, 16>(), p, ws, n_split,
                             split_tiles, s);
  else
    rc = launch_split_kernel(trim_matmul_stream_fma_kernel<T, O, 16, false>,
                             stream_smem_bytes<T, 16>(), p, ws, n_split,
                             split_tiles, s);
  if (rc != 0 || n_split == 1) return rc;
  return launch_merge<typename StreamLane<T>::Acc, O>(p, ws, n_split, s);
}

// bf16: mma.sync on rows padded to 16.
template <typename O>
int launch_stream_tc(const MatmulArgs& p, bool vec, void* ws, int n_split,
                     int split_tiles, cudaStream_t s) {
  constexpr int kBytes = stream_smem_bytes<__nv_bfloat16, kSMaxRows>();
  const int rc =
      vec ? launch_split_kernel(trim_matmul_stream_tc_kernel<O, true>, kBytes,
                                p, ws, n_split, split_tiles, s)
          : launch_split_kernel(trim_matmul_stream_tc_kernel<O, false>,
                                kBytes, p, ws, n_split, split_tiles, s);
  if (rc != 0 || n_split == 1) return rc;
  return launch_merge<float, O>(p, ws, n_split, s);
}

// The TMA map of a bf16 matrix of `outer` rows of `inner` elements, row
// stride `ld` elements (any value when outer is 1), boxes of box_inner x
// box_outer in the 128-byte swizzle; elements outside read as zeros.
// Returns a cudaError_t.
int encode_2d(CUtensorMap* map, const void* base, long long inner,
              long long outer, long long ld, int box_inner, int box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(
      outer > 1 ? ld * 2 : (inner * 2 + 15) / 16 * 16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename O>
int launch_wgmma(const MatmulArgs& p, cudaStream_t s) {
  CUtensorMap a_map, b_map;
  int rc = encode_2d(&a_map, p.a, p.K, p.M, p.lda, kWgBK, kWgBM);
  if (rc != 0) return rc;
  rc = encode_2d(&b_map, p.b, p.N, p.K, p.ldb, 64, kWgBK);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      trim_matmul_wgmma_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (p.M + kWgBM - 1) / kWgBM * ((p.N + kWgBN - 1) / kWgBN);
  trim_matmul_wgmma_kernel<O><<<static_cast<unsigned>(blocks), kWgThreads,
                                kWgSmem, s>>>(a_map, b_map, p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Codes shared with the wrapper.
//   lane: 0 fp32, 1 bf16, 2 int8;  out: 0 fp32, 1 bf16, 2 int32;
//   path: 0 mma, 1 fma, 2 wgmma, 3 stream.
// The tiles the wrapper plans and checks its grids against.
int trim_matmul_block_m() { return kBM; }
int trim_matmul_block_n() { return kBN; }
int trim_matmul_fma_block_m() { return kFBM; }
int trim_matmul_fma_block_n() { return kFBN; }
int trim_matmul_wgmma_block_m() { return kWgBM; }
int trim_matmul_wgmma_block_n() { return kWgBN; }
int trim_matmul_stream_rows() { return kSMaxRows; }
int trim_matmul_stream_cols() { return kSCols; }
int trim_matmul_stream_max_k() { return kSMaxK; }
int trim_matmul_stream_k_tile(int lane) {
  return lane == 0   ? StreamLane<float>::kKT
         : lane == 1 ? StreamLane<__nv_bfloat16>::kKT
                     : StreamLane<int8_t>::kKT;
}

const char* trim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a (M, K) with row stride lda, b (K, N) with row stride ldb (unit column
// strides), out (M, N) contiguous, on the path `path`. The stream path
// takes the wrapper's plan: n_split splits of split_tiles K tiles, and
// when n_split > 1 a workspace ws of (n_split, M, N) fp32 (int32 for
// int8). Returns the launch's cudaError_t, or cudaErrorInvalidValue for a
// lane/output pair the library does not hold or a path that cannot take
// the operands.
int trim_matmul(const void* a, const void* b, void* out, int lane,
                int out_kind, int path, long long M, long long N, long long K,
                long long lda, long long ldb, void* ws, int n_split,
                int split_tiles, void* stream) {
  constexpr int kBad = static_cast<int>(cudaErrorInvalidValue);
  MatmulArgs p;
  p.a = a;
  p.b = b;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = lda;
  p.ldb = ldb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return kBad;
  const bool pair = (lane == 0 && (out_kind == 0 || out_kind == 1)) ||
                    (lane == 1 && (out_kind == 0 || out_kind == 1)) ||
                    (lane == 2 && out_kind == 2);
  if (!pair) return kBad;
  const long long esz = lane == 0 ? 4 : lane == 1 ? 2 : 1;
  if (path == 0 || path == 1) {  // mma (bf16, int8), fma (fp32)
    if ((path == 1) != (lane == 0) ||
        (M + (path == 1 ? kFBM : kBM) - 1) / (path == 1 ? kFBM : kBM) >
            65535 ||
        (N + kFBN - 1) / kFBN >= (1ll << 31))
      return kBad;
    const bool vec = aligned16(a) && aligned16(b) && (lda * esz) % 16 == 0 &&
                     (ldb * esz) % 16 == 0 && (K * esz) % 16 == 0 &&
                     (N * esz) % 16 == 0;
    if (lane == 0)
      return out_kind == 0 ? launch_f32_any<float>(p, vec, s)
                           : launch_f32_any<__nv_bfloat16>(p, vec, s);
    if (lane == 2) return launch_tc_any<int8_t, int>(p, vec, s);
    return out_kind == 0 ? launch_tc_any<__nv_bfloat16, float>(p, vec, s)
                         : launch_tc_any<__nv_bfloat16, __nv_bfloat16>(p, vec,
                                                                       s);
  }
  if (path == 2) {  // wgmma: bf16, every base and row stride 16-byte
                    // aligned, no row overlapping the next
    const bool tma = aligned16(a) && aligned16(b) &&
                     (M == 1 || ((lda * 2) % 16 == 0 && lda >= K)) &&
                     (K == 1 || ((ldb * 2) % 16 == 0 && ldb >= N)) &&
                     M < (1ll << 31) &&
                     N < (1ll << 31) && K < (1ll << 31) &&
                     (M + kWgBM - 1) / kWgBM * ((N + kWgBN - 1) / kWgBN) <
                         (1ll << 31);
    if (lane != 1 || !tma) return kBad;
    return out_kind == 0 ? launch_wgmma<float>(p, s)
                         : launch_wgmma<__nv_bfloat16>(p, s);
  }
  if (path == 3) {  // stream: M <= kSMaxRows, the plan covers K exactly
    const long long kt = trim_matmul_stream_k_tile(lane);
    const long long span = static_cast<long long>(split_tiles) * kt;
    if (M > kSMaxRows || n_split < 1 || n_split > 65535 || split_tiles < 1 ||
        span > kSMaxK || n_split * span < K || (n_split - 1) * span >= K ||
        (n_split > 1 && ws == nullptr) ||
        (N + kSCols - 1) / kSCols >= (1ll << 31))
      return kBad;
    const bool vec = aligned16(b) && (K == 1 || (ldb * esz) % 16 == 0);
    if (lane == 0)
      return out_kind == 0
                 ? launch_stream_fma<float, float>(p, vec, ws, n_split,
                                                   split_tiles, s)
                 : launch_stream_fma<float, __nv_bfloat16>(p, vec, ws, n_split,
                                                           split_tiles, s);
    if (lane == 2)
      return launch_stream_fma<int8_t, int>(p, vec, ws, n_split, split_tiles,
                                            s);
    return out_kind == 0 ? launch_stream_tc<float>(p, vec, ws, n_split,
                                                   split_tiles, s)
                         : launch_stream_tc<__nv_bfloat16>(p, vec, ws, n_split,
                                                           split_tiles, s);
  }
  return kBad;
}

}  // extern "C"
