// TrIM matmul for Hopper (sm_90a): the port of the Pallas kernel
// `_matmul_kernel` (src/repro/kernels/trim_matmul.py:27), the K = 1 case
// of the TrIM dataflow: a weight-stationary blocked (M, K) @ (K, N) with
// the partial sums of the K axis held on chip and written once.
//
// What it computes: out[m, n] = sum_k a[m, k] * b[k, n] for a (M, K) and
// b (K, N) with row strides lda and ldb (unit column stride), into out
// (M, N) contiguous. Three lanes:
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 x bf16 -> fp32),
//   rounded once to the output type (bf16 or fp32);
// - int8: tensor cores through mma.sync m16n8k32 (s8 x s8 -> s32), an
//   int32 accumulator that wraps as the TPU kernel's does, int32 out;
// - fp32: IEEE fp32 on the CUDA cores (no TF32), one fused multiply-add
//   per k in order, fp32 (or bf16) out.
//
// What the TPU kernel keeps out of device memory, and how this one does it:
// - The Pallas kernel's (bm, bn) accumulator lives in VMEM scratch across
//   the sequential K grid axis. Here one block owns a 128 x 128 output tile
//   and loops over K itself; the accumulator stays in registers (64 per
//   thread) and each output is written once.
// - The Pallas driver pads a and b to whole blocks (a copy of each). Here
//   the ragged edges of M, K and N are zero-filled as the tiles are loaded:
//   cp.async with a source size of 0 when every row is 16-byte aligned,
//   element loads otherwise. No padded copy exists, and M may be 1.
// - Tiles of a and b are staged in shared memory by cp.async, two stages
//   deep, so the next K tile's load overlaps this one's products. A
//   fragments come from ldmatrix; bf16 B fragments from ldmatrix.trans
//   (b is K-major); int8 B tiles are transposed once in shared memory
//   (4 x 4 bytes per thread with byte permutes), since ldmatrix.trans moves
//   16-bit elements only.
//
// What bounds it: at granite-3-2b's projections (M = 16384) 2 M N K
// operations against (M K + K N) elements read and M N written: far above
// the ridge, so the tensor-core rate (bf16, int8) or the CUDA cores' fp32
// rate. At decode (M = 4) the bytes of b. This kernel is the simple one: a
// 128 x 128 x 64-byte tile, 8 warps each 64 x 32, mma.sync and no wgmma,
// TMA or warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;        // rows of out per block
constexpr int kBN = 128;        // columns of out per block
constexpr int kKBytes = 64;     // bytes of K per tile (32 bf16, 64 int8)
constexpr int kALd = 80;        // bytes per A row in shared memory (padded)
constexpr int kF32BK = 8;       // fp32 lane: K per tile

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

// The fp32 lane: a 128 x 128 tile, 8 x 8 outputs per thread (rows
// ty*4 + {0..3} and 64 + ty*4 + {0..3}, likewise columns), a K tile of 8.
template <typename O>
__global__ void __launch_bounds__(kThreads)
trim_matmul_f32_kernel(const MatmulArgs p) {
  __shared__ __align__(16) float as[kF32BK][kBM];   // a transposed: [k][m]
  __shared__ __align__(16) float bs[kF32BK][kBN];
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (long long k0 = 0; k0 < p.K; k0 += kF32BK) {
#pragma unroll
    for (int q = 0; q < kBM * kF32BK / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kF32BK, c = i % kF32BK;
      const long long m = m0 + r, k = k0 + c;
      as[c][r] = (m < p.M && k < p.K) ? a[m * p.lda + k] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBN * kF32BK / kThreads; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int r = i / kBN, c = i % kBN;
      const long long k = k0 + r, n = n0 + c;
      bs[r][c] = (k < p.K && n < p.N) ? b[k * p.ldb + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  O* out = static_cast<O*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long n = n0 + (j >> 2) * 64 + tx * 4 + (j & 3);
      if (n < p.N) put(out + m * p.N + n, acc[i][j]);
    }
  }
}

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

template <typename O>
int launch_f32(const MatmulArgs& p, cudaStream_t s) {
  trim_matmul_f32_kernel<O><<<grid_of(p), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Lane and output codes shared with the wrapper.
//   lane: 0 fp32, 1 bf16, 2 int8;  out: 0 fp32, 1 bf16, 2 int32.
// Tile of one block, which the wrapper checks its grid against.
int trim_matmul_block_m() { return kBM; }
int trim_matmul_block_n() { return kBN; }

const char* trim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a (M, K) with row stride lda, b (K, N) with row stride ldb (unit column
// strides), out (M, N) contiguous. Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for a lane/output pair the library does not hold.
int trim_matmul(const void* a, const void* b, void* out, int lane,
                int out_kind, long long M, long long N, long long K,
                long long lda, long long ldb, void* stream) {
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
  const long long esz = lane == 0 ? 4 : lane == 1 ? 2 : 1;
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   (lda * esz) % 16 == 0 && (ldb * esz) % 16 == 0 &&
                   (K * esz) % 16 == 0 && (N * esz) % 16 == 0;
  if (lane == 0 && out_kind == 0) return launch_f32<float>(p, s);
  if (lane == 0 && out_kind == 1) return launch_f32<__nv_bfloat16>(p, s);
  if (lane == 1 && out_kind == 0)
    return launch_tc_any<__nv_bfloat16, float>(p, vec, s);
  if (lane == 1 && out_kind == 1)
    return launch_tc_any<__nv_bfloat16, __nv_bfloat16>(p, vec, s);
  if (lane == 2 && out_kind == 2) return launch_tc_any<int8_t, int>(p, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
