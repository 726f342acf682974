// Flash attention for Hopper (sm_90a): the port of the Pallas kernel
// `_flash_kernel` (src/repro/kernels/flash_attention.py:38), on the layout
// of the model's attention core (src/repro/nn/attention.py:75).
//
// What it computes: for q (B, Sq, H, G, D) (H KV heads, G q heads sharing
// each), k and v (B, Sk, H, D), and each flattened row r = (s, g):
//   out[b, s, h, g] = sum_c p_c v[b, c, h] / max(sum_c p_c, 1e-20),
//   p_c = exp(q.k_c * D^-0.5 - max)   over the visible keys c,
// where key c is visible iff c < min(Sk, kv_length[b]) (kv_length is
// optional) and, when causal, c <= q_offset + s. A row with no visible key
// gives 0. The softmax statistics (m, l) and the accumulator are fp32; the
// output is rounded once to q's dtype.
//
// Two lanes:
// - bf16: tensor cores through mma.sync m16n8k16 (bf16 x bf16 -> fp32).
//   A block of 4 warps owns 64 flattened rows (16 per warp) of one (b, h):
//   the G q heads of a KV head share every K/V tile. The warp's Q
//   fragments stay in registers for the whole sweep; K/V tiles of 64 keys
//   are staged in shared memory by cp.async, two stages deep, so the next
//   tile's load overlaps this one's products. S = Q K^T stays in
//   registers, is masked and exponentiated there, and P is rounded to bf16
//   in registers as the A operand of P V (the C fragment of S is the A
//   fragment of P): the one rounding this lane adds beyond the output's.
// - fp32: IEEE on the CUDA cores (no TF32). A block of 128 threads owns 32
//   rows, 4 threads per row, each holding a quarter of the row's q and of
//   its accumulator; a score is the quad's partial dots summed by two
//   shuffles. K/V tiles of 32 keys in shared memory.
//
// What the TPU kernel keeps out of device memory, and how this one does:
// - The (Sq, Sk) scores never reach device memory: (m, l, acc) live in
//   registers across the key loop (the Pallas kernel keeps them in VMEM
//   scratch across its sequential kv grid axis; a CUDA block loops).
// - Tiles that causality or kv_length mask whole are never loaded: the key
//   loop ends at min(Sk, kv_length[b], q_offset + last row's s + 1) (the
//   Pallas kernel's pl.when skip). Keys of the last tile past
//   min(Sk, kv_length[b]) are zero-filled, never read: a stale or
//   uninitialised KV cache past the length never reaches the sum.
// - q, k, v are read in place through their strides (a view of the q
//   projection, a KV cache of S_max rows): no transpose to (B, H, S, D), no
//   repeat of the KV heads, no padding copy for ragged Sq or Sk.
//
// What bounds it: at the prefill shape (Sq = Sk = 4096, D = 64, G = 4)
// 4 Sq Sk D H G / 2 operations (causal) against (|q| + |k| + |v| + |out|)
// bytes: far above the ridge, so bound by bf16 tensor-core operations. At
// decode (Sq = 1) 4 G D operations per key against 4 D bytes read per key:
// bound by the bytes of the K/V cache read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBM = 64;       // bf16 lane: flattened rows per block
constexpr int kBN = 64;       // bf16 lane: keys per tile
constexpr int kF32Rows = 32;  // fp32 lane: rows per block (4 threads each)
constexpr int kF32Keys = 32;  // fp32 lane: keys per tile

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  const int* kv_length;  // (B,) or null
  long long Sq, Sk, H, G, q_offset;
  long long qsb, qss, qsh, qsg;
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  float scale;
  int causal;
};

// Keys [0, n_valid) of batch row b exist and are within kv_length.
__device__ __forceinline__ long long valid_keys(const FlashArgs& a,
                                                long long b) {
  long long n = a.Sk;
  if (a.kv_length != nullptr) {
    const long long len = a.kv_length[b];
    n = len < n ? len : n;
  }
  return n < 0 ? 0 : n;
}

// Keys the block's rows [r0, r0 + rows) can see at all: the loop's end.
__device__ __forceinline__ long long loop_keys(const FlashArgs& a,
                                               long long n_valid, long long r0,
                                               int rows) {
  if (!a.causal) return n_valid;
  const long long M = a.Sq * a.G;
  const long long r_last = (r0 + rows < M ? r0 + rows : M) - 1;
  long long n = a.q_offset + r_last / a.G + 1;
  n = n < 0 ? 0 : n;
  return n < n_valid ? n : n_valid;
}

__device__ __forceinline__ bool visible(const FlashArgs& a, long long key,
                                        long long n_valid, long long last) {
  return key < n_valid && (!a.causal || key <= last);
}

// ---------------------------------------------------------------------------
// bf16 lane: mma.sync
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

template <int D>
struct Bf16Smem {
  static constexpr int kLd = D + 8;         // padded row: conflict-free ldmatrix
  static constexpr int kTile = kBN * kLd;   // elements of one K or V tile
  static constexpr int kBytes = 2 * 2 * kTile * 2;  // 2 stages x (K, V)
};

// Keys [key0, key0 + kBN) of K and V into one stage; rows past n_valid are
// zero-filled and never read from device memory.
template <int D>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, const FlashArgs& a, long long key0,
    long long n_valid) {
  constexpr int kLd = Bf16Smem<D>::kLd;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const long long key = key0 + r;
    const bool ok = key < n_valid;
    const long long kk = ok ? key : 0;
    cp_async16(ks + r * kLd + c, kb + kk * a.kss + c, ok);
    cp_async16(vs + r * kLd + c, vb + kk * a.vss + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const FlashArgs a) {
  constexpr int kLd = Bf16Smem<D>::kLd;
  constexpr int kTile = Bf16Smem<D>::kTile;
  constexpr int kKc = D / 16;  // 16-wide slices of the head dim
  constexpr int kDn = D / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const long long b = blockIdx.z;
  const long long h = blockIdx.y;
  const long long M = a.Sq * a.G;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g8 = lane >> 2;  // fragment row within 8
  const int t4 = lane & 3;   // fragment column pair
  const bool warp_active = r0 + warp * 16 < M;

  // This thread's two rows (A: g8, B: g8 + 8 of the warp's 16).
  long long row[2], pos[2], grp[2], last[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = r0 + warp * 16 + g8 + 8 * i;
    row_ok[i] = row[i] < M;
    pos[i] = row_ok[i] ? row[i] / a.G : 0;
    grp[i] = row_ok[i] ? row[i] % a.G : 0;
    last[i] = a.q_offset + pos[i];
  }

  // The warp's Q fragments, resident for the whole sweep.
  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
  uint32_t qf[kKc][4];
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;  // a0, a2: row A; a1, a3: row B
      const int col = kc * 16 + (j >> 1) * 8 + t4 * 2;
      qf[kc][j] = row_ok[i] ? *reinterpret_cast<const uint32_t*>(
                                  qb + pos[i] * a.qss + grp[i] * a.qsg + col)
                            : 0u;
    }
  }

  const long long n_valid = valid_keys(a, b);
  const long long n_keys = loop_keys(a, n_valid, r0, kBM);
  const long long n_tiles = (n_keys + kBN - 1) / kBN;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb + h * a.ksh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb + h * a.vsh;

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};  // this thread's share; summed at the end
  float o[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.0f;

  if (n_tiles > 0) load_tile_bf16<D>(smem, smem + kTile, kb, vb, a, 0, n_valid);
  cp_async_commit();
  const int mi = lane >> 3;  // ldmatrix: the matrix this lane addresses
  const int rr = lane & 7;   // ... and its row
  for (long long j = 0; j < n_tiles; ++j) {
    const int st = static_cast<int>(j & 1);
    if (j + 1 < n_tiles)
      load_tile_bf16<D>(smem + (2 * (st ^ 1)) * kTile,
                        smem + (2 * (st ^ 1) + 1) * kTile, kb, vb, a,
                        (j + 1) * kBN, n_valid);
    cp_async_commit();
    cp_async_wait_one();  // tile j has landed (tile j + 1 may be in flight)
    __syncthreads();
    if (warp_active) {
      const __nv_bfloat16* ks = smem + (2 * st) * kTile;
      const __nv_bfloat16* vs = smem + (2 * st + 1) * kTile;
      const long long key0 = j * kBN;

      // S = Q K^T: 8 column tiles of 8 keys.
      float s[kBN / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = 0.0f;
#pragma unroll
        for (int kc = 0; kc < kKc; kc += 2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, ks + (nt * 8 + rr) * kLd + kc * 16 + mi * 8);
          mma_bf16(s[nt], qf[kc], kf[0], kf[1]);
          mma_bf16(s[nt], qf[kc + 1], kf[2], kf[3]);
        }
      }

      // Mask, scale and the running max.
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1;
          const long long key = key0 + nt * 8 + t4 * 2 + (c & 1);
          s[nt][c] = visible(a, key, n_valid, last[i]) ? s[nt][c] * a.scale
                                                       : kNegInf;
          mx[i] = fmaxf(mx[i], s[nt][c]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = expf(m_run[i] - mx[i]);
        m_run[i] = mx[i];
      }

      // P = exp(S - m), zero where masked; l and acc rescaled.
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1;
          const long long key = key0 + nt * 8 + t4 * 2 + (c & 1);
          s[nt][c] = visible(a, key, n_valid, last[i])
                         ? expf(s[nt][c] - mx[i])
                         : 0.0f;
          rs[i] += s[nt][c];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
      for (int dn = 0; dn < kDn; ++dn) {
        o[dn][0] *= alpha[0];
        o[dn][1] *= alpha[0];
        o[dn][2] *= alpha[1];
        o[dn][3] *= alpha[1];
      }

      // acc += P V: P (bf16) from registers, V^T fragments by ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < kDn; dn += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, vs + (kk * 16 + (mi & 1) * 8 + rr) * kLd + dn * 8 +
                      (mi >> 1) * 8);
          mma_bf16(o[dn], pa, vf[0], vf[1]);
          mma_bf16(o[dn + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }

  if (!warp_active) return;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    if (!row_ok[i]) continue;
    const float den = fmaxf(l_run[i], 1e-20f);
    __nv_bfloat16* dst =
        out + (((b * a.Sq + pos[i]) * a.H + h) * a.G + grp[i]) * D + t4 * 2;
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(dst + dn * 8) = __floats2bfloat162_rn(
          o[dn][2 * i] / den, o[dn][2 * i + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// fp32 lane: CUDA cores, IEEE
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const FlashArgs a) {
  constexpr int kVec = D / 16;  // float4s per thread per row
  __shared__ __align__(16) float ks[kF32Keys * D];
  __shared__ __align__(16) float vs[kF32Keys * D];

  const long long b = blockIdx.z;
  const long long h = blockIdx.y;
  const long long M = a.Sq * a.G;
  const long long r0 = static_cast<long long>(blockIdx.x) * kF32Rows;
  const int part = threadIdx.x & 3;  // this thread's quarter of the row
  const long long row = r0 + threadIdx.x / 4;
  const bool row_ok = row < M;
  const long long pos = row_ok ? row / a.G : 0;
  const long long grp = row_ok ? row % a.G : 0;
  const long long last = a.q_offset + pos;

  // Elements d = 16 i + 4 part + e (e < 4) of q and of the accumulator.
  float qv[4 * kVec];
  float acc[4 * kVec];
  const float* qrow = static_cast<const float*>(a.q) + b * a.qsb +
                      pos * a.qss + h * a.qsh + grp * a.qsg;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 t = row_ok
                         ? *reinterpret_cast<const float4*>(qrow + 16 * i +
                                                            4 * part)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    qv[4 * i] = t.x;
    qv[4 * i + 1] = t.y;
    qv[4 * i + 2] = t.z;
    qv[4 * i + 3] = t.w;
    acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.0f;
  }

  const long long n_valid = valid_keys(a, b);
  const long long n_keys = loop_keys(a, n_valid, r0, kF32Rows);
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  float m_run = kNegInf;
  float l_run = 0.0f;
  for (long long key0 = 0; key0 < n_keys; key0 += kF32Keys) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kF32Keys * (D / 4); i += kThreads) {
      const int r = i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      const long long key = key0 + r;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const bool ok = key < n_valid;
      *reinterpret_cast<float4*>(&ks[r * D + c]) =
          ok ? *reinterpret_cast<const float4*>(kb + key * a.kss + c) : zero;
      *reinterpret_cast<float4*>(&vs[r * D + c]) =
          ok ? *reinterpret_cast<const float4*>(vb + key * a.vss + c) : zero;
    }
    __syncthreads();

    float s[kF32Keys];
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(&ks[j * D + 16 * i + 4 * part]);
        dot += qv[4 * i] * t.x + qv[4 * i + 1] * t.y + qv[4 * i + 2] * t.z +
               qv[4 * i + 3] * t.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = visible(a, key0 + j, n_valid, last) ? dot * a.scale : kNegInf;
    }
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) mx = fmaxf(mx, s[j]);
    const float alpha = expf(m_run - mx);
    m_run = mx;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      s[j] = visible(a, key0 + j, n_valid, last) ? expf(s[j] - mx) : 0.0f;
      rs += s[j];
    }
    l_run = l_run * alpha + rs;
#pragma unroll
    for (int e = 0; e < 4 * kVec; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(&vs[j * D + 16 * i + 4 * part]);
        acc[4 * i] += s[j] * t.x;
        acc[4 * i + 1] += s[j] * t.y;
        acc[4 * i + 2] += s[j] * t.z;
        acc[4 * i + 3] += s[j] * t.w;
      }
    }
  }

  if (!row_ok) return;
  const float den = fmaxf(l_run, 1e-20f);
  float* dst = static_cast<float*>(a.out) +
               (((b * a.Sq + pos) * a.H + h) * a.G + grp) * D;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    *reinterpret_cast<float4*>(dst + 16 * i + 4 * part) =
        make_float4(acc[4 * i] / den, acc[4 * i + 1] / den,
                    acc[4 * i + 2] / den, acc[4 * i + 3] / den);
}

template <int D>
int launch_bf16(const FlashArgs& a, long long B, cudaStream_t stream) {
  constexpr int kBytes = Bf16Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.Sq * a.G + kBM - 1) / kBM),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  flash_attention_bf16_kernel<D><<<grid, kThreads, kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const FlashArgs& a, long long B, cudaStream_t stream) {
  const dim3 grid(
      static_cast<unsigned>((a.Sq * a.G + kF32Rows - 1) / kF32Rows),
      static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  flash_attention_f32_kernel<D><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tiles the wrapper validates against: rows per block of each lane.
int flash_attention_bf16_tile() { return kBM; }
int flash_attention_f32_tile() { return kF32Rows; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, H, G, D) with element strides (qsb, qss, qsh, qsg, 1); k, v
// (B, Sk, H, D) with strides (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1);
// out (B, Sq, H, G, D) contiguous in q's dtype; kv_length (B,) int32 or
// null. bf16 != 0 selects bfloat16, else fp32; D is 64 or 128. Every base
// and stride is 16-byte aligned (the wrapper checks). Returns the launch's
// cudaError_t.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    const void* kv_length, int bf16, int causal, int D,
                    long long B, long long Sq, long long Sk, long long H,
                    long long G, long long q_offset, long long qsb,
                    long long qss, long long qsh, long long qsg, long long ksb,
                    long long kss, long long ksh, long long vsb, long long vss,
                    long long vsh, float scale, void* stream) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.kv_length = static_cast<const int*>(kv_length);
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.G = G;
  a.q_offset = q_offset;
  a.qsb = qsb;
  a.qss = qss;
  a.qsh = qsh;
  a.qsg = qsg;
  a.ksb = ksb;
  a.kss = kss;
  a.ksh = ksh;
  a.vsb = vsb;
  a.vss = vss;
  a.vsh = vsh;
  a.scale = scale;
  a.causal = causal;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (D == 64) return launch_bf16<64>(a, B, s);
    if (D == 128) return launch_bf16<128>(a, B, s);
  } else {
    if (D == 64) return launch_f32<64>(a, B, s);
    if (D == 128) return launch_f32<128>(a, B, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
