// TrIM-SSD for Hopper (sm_90a): the port of the Pallas kernel `_ssd_kernel`
// (src/repro/kernels/trim_ssd.py:39), the Mamba2 chunked SSD scan, forward
// only.
//
// What it computes: for x (B, L, H, P), dt (B, L, H), A (H,), Bm and Cm
// (B, L, H, S) and D (H,), with the state h (P, S) of each (b, h) starting
// at 0, the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t h_t + D x_t.
// Only y is returned (in x's dtype), as the Pallas kernel does. x, Bm, Cm
// are fp32 or bf16; dt, A, D fp32; all sums are fp32. Any head dim P >= 1
// and state dim S >= 1, as the Pallas kernel (whole P and S a block).
//
// The design: Mamba2's own SSD decomposition in chunks of kT = 128 rows,
// with cum = cumsum(dt A) inside a chunk (a warp scan), as four launches on
// the caller's stream (one call of the entry point):
//   cb     for each (b, chunk, group): C B^T, only its lower triangle in
//          16-row tiles, into a scratch tensor, summed over S in 64-column
//          pieces in order. When Bm and Cm are one group expanded over the
//          heads (stride 0 over H) it is computed once per (b, chunk) and
//          every head reads it, else once per head.
//   state  for each (b, chunk, h, P tile, S tile): that tile of the chunk's
//          own end state dBx = (x o exp(cum_last - cum) dt)^T B (fp32
//          scratch; the tiles are independent outputs), and the chunk's
//          decay exp(cum_last).
//   pass   for each (b, h) and element of the state, in chunk order:
//          h_c = exp(cum_last,c) h_{c-1} + dBx_c, written in place as each
//          chunk's entering state (blocks split the state; no atomics).
//   out    for each (b, chunk, h, P tile):
//          y = (C B^T o tril(exp(cum_i - cum_j)) o dt_j) x
//              + exp(cum) o (C h_{c-1}^T) + D x,
//          C h^T summed over S tile by tile in order.
// P is tiled by kP = 64 and S by kS = 128: row p of h and column p of y
// depend only on column p of x, so a P tile is one more grid dimension of
// state, pass and out, and C B^T (independent of P) is shared by every P
// tile. The states are (B, NC, H, P', S') with P' and S' padded to whole
// tiles (zero rows and columns: x and B are zero-filled past P and S), so
// mamba2-130m's P = 64, S = 128 and jamba-1.5-large's P = S = 128 run
// whole tiles without a mask.
// `state` and `out` have B x NC x H x tiles blocks (NC chunks): 3072 at
// mamba2-130m's full width (one P and one S tile), 32768 at jamba's.
//
// Every product runs on the tensor cores through mma.sync:
// - fp32 lane: 3xTF32 on m16n8k8. Each fp32 operand is split into a TF32
//   high part and its remainder (read as TF32), and each product is
//   hi*hi + hi*lo + lo*hi with fp32 sums, which keeps about 21 of fp32's
//   24 bits. One TF32 pass keeps about 11 and cannot meet the fp32 lane's
//   tolerances (2e-5 on the test cases, 1e-4 x max|plain| at full width).
//   The MMA truncates its sums, so the cb and state stages sum each
//   k-step's passes apart and add them with rounded fp32 adds
//   (mma_split_at); the out stage, at its register limit, accumulates in
//   place.
// - bf16 lane: bf16 m16n8k16. A product of two bf16 values is exact in
//   fp32: C B^T is one pass; an operand computed in fp32 (the decayed
//   scores, x o w, the state) is split into two bf16 parts, two passes.
//
// What bounds each launch, at mamba2-130m's x (4, 4096, 24, 64), S = 128
// (PERF.md has each stage's time on the H100):
// - cb: 128 blocks (one group) of 1.2 M multiply-adds; small. Per head
//   (B/C not expanded with stride 0, as jamba's 8 groups repeated over 128
//   heads) it is H times that.
// - state: x and B stream through a ring of two 32-row slots (52 KB in
//   fp32, three blocks an SM), each piece landing under the products of the
//   one before; writes the states (100 MB).
// - pass: memory: the states read and written once.
// - out: h_{c-1} (cp.async, under C's first loads) and x (under C h^T) in
//   shared memory; C and the C B^T rows from L2 into registers a 16-k block
//   ahead, 16 bytes a lane; reads the states once. Past one S tile, the
//   next tile of h_{c-1} replaces the last in shared memory.
// In state and out the work around the MMAs (operand loads, the splits,
// address arithmetic) takes most of the time, more than the MMAs: the
// splits are integer adds and masks (split_tf32), the global A operands
// 16-byte loads, and each B fragment feeds two row tiles in out.
// The chunk of 128 keeps the states (B, NC, H, P', S') at 100 MB at
// mamba2-130m's width; a chunk of 64 would double them (four passes over
// them cost more than the whole bound); one of 256 would halve them but
// double the triangle's work (C B^T and the scores times x grow with the
// chunk).
//
// Chunking is math-neutral: the kernel's chunk is its own kT, whatever
// chunk the caller names (the plain version's); the two differ by rounding.
// Every sum runs in a fixed order (no atomics), so two calls give the same
// bits. Rows past L are zero-filled (dt = 0 leaves the state unchanged), and
// x, dt, Bm, Cm are read in place through their strides, a stride-0 view
// over H without a copy; cp.async takes rows whose starts and widths are
// whole 16 bytes, plain loads the rest. The wrapper allocates the scratch
// (states, C B^T, decays); the kernels allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kT = 128;        // the kernel's chunk
constexpr int kP = 64;         // head-dim tile
constexpr int kS = 128;        // state-dim tile
constexpr int kTiles = kT / 16;  // 16-row tiles of a chunk, one a warp
// C B^T of one chunk, packed: row tile w holds 16 rows of 16 (w + 1)
// columns (on and below the diagonal tile), 128 w (w + 1) floats in; each
// 16 columns of a row in the lane's permuted order (Lane::perm16).
constexpr int kCbFloats = 128 * kTiles * (kTiles + 1);

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  float* states;  // (B, NC, H, kP np, kS ns)
  float* cb;      // (B, NC, ng, kCbFloats)
  float* decay;   // (B, H, NC)
  long long L, H, NC;
  int P, S, ng;
  int np, ns;     // P and S tiles
  long long sp;   // a state row: kS ns floats (below 2^30)
  long long state_floats;  // one (b, chunk, h) state: kP np x kS ns
  int vec_x, vec_bc;  // rows may be copied in 16-byte pieces
  long long sxb, sxl, sxh;
  long long sdb, sdl, sdh;
  long long sbb, sbl, sbh;
  long long scb, scl, sch;
};

// ---------------------------------------------------------------------------
// PTX helpers
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// The two lanes: fragment layouts, operand splits and the MMA
// ---------------------------------------------------------------------------

// An A fragment (16 x K, row-major) and a B fragment (K x 8, column-major)
// of one mma.sync, each as its high part and its remainder (lo is left
// unset for an operand that the lane's type holds exactly).
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero:
// cvt.rna's rounding for finite v, as an add and a mask), lo the exact
// remainder, which the MMA reads truncated to TF32 (it ignores an
// operand's low 13 bits): 2^-10 of lo, 2^-21 of v.
template <bool Exact>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  if (!Exact) lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Two elements at consecutive k (v0 the lower) -> a bf16x2 register, and
// the remainders' bf16x2.
template <bool Exact>
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(v0, v1);
  if (!Exact) {
    const float h0 = __uint_as_float(hi << 16);
    const float h1 = __uint_as_float(hi & 0xffff0000u);
    lo = pack_bf16(v0 - h0, v1 - h1);
  }
}

// fp32 x/B/C: 3xTF32 on mma.sync m16n8k8.
struct F32Lane {
  using E = float;
  static constexpr int kK = 8;
  // fp32 data is never exact in TF32
  static constexpr bool kDataExact = false;
  static constexpr int kPer = 1;  // elements of one A register
  // n tiles whose k-step passes sum apart before they join the cb and
  // state stages' accumulators (mma_split_at)
  static constexpr int kPromote = 2;

  // element e of A register r: its row and column in the fragment
  __device__ __forceinline__ static int a_row(int r) {
    return ((threadIdx.x & 31) >> 2) + 8 * (r & 1);
  }
  __device__ __forceinline__ static int a_col(int r, int) {
    return (threadIdx.x & 3) + 4 * (r >> 1);
  }
  template <bool Exact>
  __device__ __forceinline__ static void a_split(const float (&v)[4][2],
                                                 FragA& a) {
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32<Exact>(v[r][0], a.hi[r], a.lo[r]);
  }

  // A 16-k block read 4 adjacent k a lane: MMA k-steps in it, where logical
  // column c = t + 4 q + 8 s of step s lies (4 t + 2 s + q), the logical
  // column of the lane's m-th element, and the fragments of step s.
  static constexpr int kSteps = 2;
  __device__ __forceinline__ static int perm16(int c) {
    return 4 * (c & 3) + 2 * (c >> 3) + ((c >> 2) & 1);
  }
  __device__ __forceinline__ static int logical16(int m) {
    return (threadIdx.x & 3) + 4 * (m & 1) + 8 * (m >> 1);
  }
  template <bool Exact>
  __device__ __forceinline__ static void a_from_block(const float (&v)[2][4],
                                                      int s, FragA& a) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32<Exact>(v[r & 1][2 * s + (r >> 1)], a.hi[r], a.lo[r]);
  }
  template <bool Exact>
  __device__ __forceinline__ static void b_from_block(const float (&v)[4],
                                                      int s, FragB& b) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      split_tf32<Exact>(v[2 * s + q], b.hi[q], b.lo[q]);
  }

  // Fragments from storage: A rows k-contiguous (element (row, k) at
  // p[row ld + k]); B k-contiguous (element (k, n) at p[n ld + k]) or
  // k-major (at p[k ld + n]).
  template <bool Exact, typename E>
  __device__ __forceinline__ static void a_frag_contig(const E* p, int ld,
                                                       FragA& a) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32<Exact>(to_f32(p[(g + 8 * (r & 1)) * ld + t + 4 * (r >> 1)]),
                        a.hi[r], a.lo[r]);
  }
  template <bool Exact, typename E>
  __device__ __forceinline__ static void b_frag_contig(const E* p, int ld,
                                                       FragB& b) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      split_tf32<Exact>(to_f32(p[g * ld + t + 4 * q]), b.hi[q], b.lo[q]);
  }
  template <bool Exact, typename E>
  __device__ __forceinline__ static void b_frag_major(const E* p, int ld,
                                                      FragB& b) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      split_tf32<Exact>(to_f32(p[(t + 4 * q) * ld + g]), b.hi[q], b.lo[q]);
  }
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// bf16 x/B/C: mma.sync m16n8k16, bf16 in, fp32 sums.
struct Bf16Lane {
  using E = __nv_bfloat16;
  static constexpr int kK = 16;
  // bf16 data is exact in the MMA's bf16 operands
  static constexpr bool kDataExact = true;
  static constexpr int kPer = 2;
  static constexpr int kPromote = 0;  // accumulate in place

  __device__ __forceinline__ static int a_row(int r) {
    return ((threadIdx.x & 31) >> 2) + 8 * (r & 1);
  }
  __device__ __forceinline__ static int a_col(int r, int e) {
    return 2 * (threadIdx.x & 3) + 8 * (r >> 1) + e;
  }
  template <bool Exact>
  __device__ __forceinline__ static void a_split(const float (&v)[4][2],
                                                 FragA& a) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16<Exact>(v[r][0], v[r][1], a.hi[r], a.lo[r]);
  }

  // as F32Lane's: one k-step a block, logical c = 2 t + 8 q + e at
  // 4 t + 2 q + e
  static constexpr int kSteps = 1;
  __device__ __forceinline__ static int perm16(int c) {
    return 4 * ((c >> 1) & 3) + 2 * (c >> 3) + (c & 1);
  }
  __device__ __forceinline__ static int logical16(int m) {
    return 2 * (threadIdx.x & 3) + 8 * (m >> 1) + (m & 1);
  }
  template <bool Exact>
  __device__ __forceinline__ static void a_from_block(const float (&v)[2][4],
                                                      int, FragA& a) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16<Exact>(v[r & 1][2 * (r >> 1)], v[r & 1][2 * (r >> 1) + 1],
                        a.hi[r], a.lo[r]);
  }
  template <bool Exact>
  __device__ __forceinline__ static void b_from_block(const float (&v)[4],
                                                      int, FragB& b) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
      split_bf16<Exact>(v[2 * q], v[2 * q + 1], b.hi[q], b.lo[q]);
  }

  // As F32Lane's. A bf16 operand that is exact is read as it lies: a
  // k-contiguous pair is one 32-bit load, a k-major pair two 16-bit loads
  // and a byte permute.
  template <bool Exact, typename E>
  __device__ __forceinline__ static void pair(const E* p, int step,
                                              uint32_t& hi, uint32_t& lo) {
    if constexpr (Exact && sizeof(E) == 2) {
      if (step == 1)
        hi = *reinterpret_cast<const uint32_t*>(p);
      else
        hi = __byte_perm(*reinterpret_cast<const unsigned short*>(p),
                         *reinterpret_cast<const unsigned short*>(p + step),
                         0x5410);
    } else {
      split_bf16<Exact>(to_f32(p[0]), to_f32(p[step]), hi, lo);
    }
  }
  template <bool Exact, typename E>
  __device__ __forceinline__ static void a_frag_contig(const E* p, int ld,
                                                       FragA& a) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pair<Exact>(p + (g + 8 * (r & 1)) * ld + 2 * t + 8 * (r >> 1), 1,
                  a.hi[r], a.lo[r]);
  }
  template <bool Exact, typename E>
  __device__ __forceinline__ static void b_frag_contig(const E* p, int ld,
                                                       FragB& b) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      pair<Exact>(p + g * ld + 2 * t + 8 * q, 1, b.hi[q], b.lo[q]);
  }
  template <bool Exact, typename E>
  __device__ __forceinline__ static void b_frag_major(const E* p, int ld,
                                                      FragB& b) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      pair<Exact>(p + (2 * t + 8 * q) * ld + g, ld, b.hi[q], b.lo[q]);
  }
  __device__ __forceinline__ static void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
}

// acc[n0 + n] += a b[n] for n < NB over the passes the operands need, the
// small terms first; pass-major, so that consecutive MMAs are independent.
// An MMA drops its products' bits below its accumulator's last place (it
// truncates where a CUDA-core add rounds to nearest: the probe of
// tools/ssd_precision.py), so a chain of MMAs into one accumulator drifts
// one way at the accumulator's scale. With G > 0 the passes of one k-step
// sum, G n tiles at a time, into a zeroed accumulator that fp32 adds join
// to acc: the truncations stay at the scale of one k-step's products.
// G = 0 accumulates in place.
template <class Lane, bool EA, bool EB, int G, int NT, int NB>
__device__ __forceinline__ void mma_split_at(float (&acc)[NT][4], int n0,
                                             const FragA& a,
                                             const FragB (&b)[NB]) {
  if constexpr (G > 0) {
    static_assert(NB % G == 0, "n tiles in whole groups");
#pragma unroll
    for (int n1 = 0; n1 < NB; n1 += G) {
      float t[G][4];
      zero(t);
      if (!EA)
#pragma unroll
        for (int n = 0; n < G; ++n) Lane::mma(t[n], a.lo, b[n1 + n].hi);
      if (!EB)
#pragma unroll
        for (int n = 0; n < G; ++n) Lane::mma(t[n], a.hi, b[n1 + n].lo);
#pragma unroll
      for (int n = 0; n < G; ++n) Lane::mma(t[n], a.hi, b[n1 + n].hi);
#pragma unroll
      for (int n = 0; n < G; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n0 + n1 + n][i] += t[n][i];
    }
  } else {
    if (!EA)
#pragma unroll
      for (int n = 0; n < NB; ++n) Lane::mma(acc[n0 + n], a.lo, b[n].hi);
    if (!EB)
#pragma unroll
      for (int n = 0; n < NB; ++n) Lane::mma(acc[n0 + n], a.hi, b[n].lo);
#pragma unroll
    for (int n = 0; n < NB; ++n) Lane::mma(acc[n0 + n], a.hi, b[n].hi);
  }
}

// 4 adjacent floats from global memory (16 bytes, aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// This lane's elements of an A fragment, f(row, col) relative to its
// corner, as v[register][element].
template <class Lane, class F>
__device__ __forceinline__ void gather_a(F f, float (&v)[4][2]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < Lane::kPer; ++e)
      v[r][e] = f(Lane::a_row(r), Lane::a_col(r, e));
}

// One warp, MT row tiles sharing each B fragment: acc[m] (16 x 8 NT) +=
// A_m (16 x [k0, k1)) B ([k0, k1) x 8 NT). af(m, k, frag) and bf(k, n,
// frag) build the fragments at k (B's columns from n); EA / EB: the operand
// is exact in the lane's MMA type (no remainder pass).
template <class Lane, bool EA, bool EB, int G, int MT, int NT, class AF,
          class BF>
__device__ __forceinline__ void warp_gemm(float (&acc)[MT][NT][4], int k0,
                                          int k1, AF af, BF bf) {
#pragma unroll 2
  for (int k = k0; k < k1; k += Lane::kK) {
    FragA a[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) af(m, k, a[m]);
    FragB b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) bf(k, 8 * n, b[n]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
      mma_split_at<Lane, EA, EB, G>(acc[m], 0, a[m], b);
  }
}

// ---------------------------------------------------------------------------
// Shared-memory tiles
// ---------------------------------------------------------------------------

// Leading dims (elements) that keep each fragment load free of bank
// conflicts. "contig": the fragment steps along a row (k contiguous);
// "major": down the rows (k is the row). TF32 fragments read single words
// (a row offset of 4 mod 32 words for contig, 8 for major); bf16 fragments
// read bf16 pairs (4 words mod 32 for contig; two rows of 8 mod 32 words
// apart for major).
template <class Lane, int W>
__host__ __device__ constexpr int ld_contig() {
  return Lane::kK == 8 ? W + 4 : W + 8;
}
template <int W>
__host__ __device__ constexpr int ld_major() {
  return W + 8;
}
// Start of row tile w of the packed C B^T.
__device__ __forceinline__ int cb_tile_start(int w) {
  return 128 * w * (w + 1);
}

template <typename E>
__device__ __forceinline__ E zero_elem() {
  return from_f32<E>(0.0f);
}

// Rows [r0, r1) and columns [c0, c1) of a tile in shared memory (row r at
// dst + r ld) from global memory (row r at src + r stride); rows past
// `nrows` and columns past `ncols` are zero. With vec, 16-byte cp.async
// pieces (the caller commits the group); else plain loads.
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, int ld, const E* src,
                                          long long stride, int r0, int r1,
                                          int c0, int c1, int nrows,
                                          int ncols, bool vec) {
  constexpr int kPer = 16 / sizeof(E);
  if (vec) {
    const int per_row = (c1 - c0) / kPer;
    for (int i = threadIdx.x; i < (r1 - r0) * per_row; i += blockDim.x) {
      const int r = r0 + i / per_row, c = c0 + (i % per_row) * kPer;
      const bool ok = r < nrows && c < ncols;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    const int w = c1 - c0;
    for (int i = threadIdx.x; i < (r1 - r0) * w; i += blockDim.x) {
      const int r = r0 + i / w, c = c0 + i % w;
      dst[r * ld + c] =
          (r < nrows && c < ncols) ? src[r * stride + c] : zero_elem<E>();
    }
  }
}

// dt of chunk c into dts (0 past L); then, by warp 0, cum = cumsum(dt A)
// within the chunk: each lane sums 4 rows in order, a warp scan adds the
// lanes before it. The caller synchronises before reading cum.
__device__ __forceinline__ void chunk_cum(const SsdArgs& a, long long b,
                                          long long h, long long c, int n,
                                          float* dts, float* cum) {
  const int tid = threadIdx.x;
  const float* db = a.dt + b * a.sdb + h * a.sdh + c * kT * a.sdl;
  if (tid < kT) dts[tid] = tid < n ? db[tid * a.sdl] : 0.0f;
  __syncthreads();
  if (tid < 32) {
    const float A = a.A[h];
    float v[4], run = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      run = __fadd_rn(run, __fmul_rn(dts[4 * tid + i], A));
      v[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) cum[4 * tid + i] = excl + v[i];
  }
}

// ---------------------------------------------------------------------------
// cb: C B^T of a chunk, lower triangle, per (b, chunk, group)
// ---------------------------------------------------------------------------

template <class Lane>
struct CbSmem {
  using E = typename Lane::E;
  static constexpr int kLd = ld_contig<Lane, kS>();
  static constexpr int kBytes = 2 * kT * kLd * sizeof(E);
};

template <class Lane>
__global__ void __launch_bounds__(kThreads, 1) ssd_cb_kernel(const SsdArgs a) {
  using E = typename Lane::E;
  using Sm = CbSmem<Lane>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* cs = reinterpret_cast<E*>(smem);
  E* bs = cs + kT * Sm::kLd;

  const long long g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int n = static_cast<int>(a.L - c * kT < kT ? a.L - c * kT : kT);
  const E* cb = static_cast<const E*>(a.C) + b * a.scb + g * a.sch +
                c * kT * a.scl;
  const E* bb = static_cast<const E*>(a.B) + b * a.sbb + g * a.sbh +
                c * kT * a.sbl;
  // the state's columns in pieces of 64 through a ring of two slots (the
  // tile's two column halves): each piece lands under the products of the
  // one before, and the pieces are summed in order
  const int pieces = (a.S + 63) / 64;
  const auto load_piece = [&](int i) {
    const int slot = 64 * (i & 1);
    load_tile(cs + slot, Sm::kLd, cb + 64 * i, a.scl, 0, kT, 0, 64, n,
              a.S - 64 * i, a.vec_bc);
    load_tile(bs + slot, Sm::kLd, bb + 64 * i, a.sbl, 0, kT, 0, 64, n,
              a.S - 64 * i, a.vec_bc);
    cp_async_commit();
  };
  load_piece(0);
  if (pieces > 1) load_piece(1);

  const int w = threadIdx.x >> 5;
  const int g4 = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  float* out = a.cb + ((b * a.NC + c) * a.ng + g) * kCbFloats +
               cb_tile_start(w);
  const int width = 16 * (w + 1);  // this row tile's columns
  constexpr bool kE = Lane::kDataExact;
  float acc[2][1][8][4];  // column pieces of 64 (the second for w >= 4)
  zero(acc[0][0]);
  zero(acc[1][0]);
#pragma unroll 1
  for (int i = 0; i < pieces; ++i) {
    if (i + 1 < pieces)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const int slot = 64 * (i & 1);
#pragma unroll
    for (int piece = 0; piece < 2; ++piece) {
      if (64 * piece >= width) continue;
      warp_gemm<Lane, kE, kE, Lane::kPromote>(
          acc[piece], slot, slot + 64,
          [&](int, int k, FragA& f) {
            Lane::template a_frag_contig<kE>(cs + 16 * w * Sm::kLd + k,
                                             Sm::kLd, f);
          },
          [&](int k, int j, FragB& f) {
            Lane::template b_frag_contig<kE>(
                bs + (64 * piece + j) * Sm::kLd + k, Sm::kLd, f);
          });
    }
    if (i + 2 < pieces) {
      __syncthreads();  // every warp is done with slot i % 2
      load_piece(i + 2);
    }
  }
  // each 16 columns in the order the out stage's lanes read them
  // (Lane::perm16): a lane's 4 columns of a block adjacent
#pragma unroll
  for (int piece = 0; piece < 2; ++piece)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 64 * piece + 8 * nt + 2 * t4 + (i & 1);
        if (j < width)
          out[(g4 + 8 * (i >> 1)) * width + (j & ~15) + Lane::perm16(j & 15)] =
              acc[piece][0][nt][i];
      }
}

// ---------------------------------------------------------------------------
// state: a chunk's own end state and decay, per (b, chunk, h, P tile,
// S tile)
// ---------------------------------------------------------------------------

// The chunk's rows stream through a ring of two slots of kPiece rows (52 KB
// in fp32, three blocks an SM): each piece lands under the products of the
// one before.
constexpr int kPiece = 32;

template <class Lane>
struct StateSmem {
  using E = typename Lane::E;
  static constexpr int kLdx = ld_major<kP>();
  static constexpr int kLdb = ld_major<kS>();
  static constexpr int kSlot = kPiece * (kLdx + kLdb) * sizeof(E);
  static constexpr int kDts = 2 * kSlot;
  static constexpr int kCum = kDts + kT * 4;
  static constexpr int kW = kCum + kT * 4;
  static constexpr int kBytes = kW + kT * 4;
};

constexpr int kStateThreads = 128;  // 4 warps of 32 x 64 outputs

template <class Lane>
__global__ void __launch_bounds__(kStateThreads, 4)
    ssd_state_kernel(const SsdArgs a) {
  using E = typename Lane::E;
  using Sm = StateSmem<Lane>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem + Sm::kDts);
  float* cum = reinterpret_cast<float*>(smem + Sm::kCum);
  float* ws = reinterpret_cast<float*>(smem + Sm::kW);
  // slot i: x rows [kPiece][kLdx], then B rows [kPiece][kLdb]
  const auto xs = [&](int i) {
    return reinterpret_cast<E*>(smem + (i & 1) * Sm::kSlot);
  };
  const auto bs = [&](int i) { return xs(i) + kPiece * Sm::kLdx; };

  // blockIdx.x: (h, P tile, S tile), the S tile fastest
  const int st = static_cast<int>(blockIdx.x % a.ns);
  const int pt = static_cast<int>(blockIdx.x / a.ns % a.np);
  const long long h = blockIdx.x / a.ns / a.np, c = blockIdx.y,
                  b = blockIdx.z;
  const int n = static_cast<int>(a.L - c * kT < kT ? a.L - c * kT : kT);
  const E* xb = static_cast<const E*>(a.x) + b * a.sxb + h * a.sxh +
                c * kT * a.sxl + kP * pt;
  const E* bb = static_cast<const E*>(a.B) + b * a.sbb + h * a.sbh +
                c * kT * a.sbl + kS * st;
  // piece i: rows kPiece i .. kPiece (i + 1) of the tile's x and B
  // columns, into slot i % 2
  const auto load_piece = [&](int i) {
    const int r0 = kPiece * i;
    load_tile(xs(i), Sm::kLdx, xb + r0 * a.sxl, a.sxl, 0, kPiece, 0, kP,
              n - r0, a.P - kP * pt, a.vec_x);
    load_tile(bs(i), Sm::kLdb, bb + r0 * a.sbl, a.sbl, 0, kPiece, 0, kS,
              n - r0, a.S - kS * st, a.vec_bc);
    cp_async_commit();
  };
  load_piece(0);
  load_piece(1);
  chunk_cum(a, b, h, c, n, dts, cum);
  __syncthreads();
  const float cum_last = cum[kT - 1];
  if (threadIdx.x < kT)
    ws[threadIdx.x] = expf(cum_last - cum[threadIdx.x]) * dts[threadIdx.x];
  if (threadIdx.x == 0 && pt == 0 && st == 0)
    a.decay[(b * a.H + h) * a.NC + c] = expf(cum_last);

  // dBx[p][s] = sum_t (x[t][p] w[t]) B[t][s]. This warp: rows p0 + 0..31
  // (two tiles sharing each B fragment), columns s0 + 0..63.
  const int w = threadIdx.x >> 5;
  const int p0 = 32 * (w & 1), s0 = 64 * (w >> 1);
  constexpr bool kE = Lane::kDataExact;
  float acc[2][8][4];
  zero(acc[0]);
  zero(acc[1]);
  constexpr int kPieces = kT / kPiece;
#pragma unroll 1
  for (int i = 0; i < kPieces; ++i) {
    if (i + 1 < kPieces)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // piece i landed (and ws, the first time)
    const E* xp = xs(i);
    const E* bp = bs(i);
    const float* wp = ws + kPiece * i;
    warp_gemm<Lane, false, kE, Lane::kPromote>(
        acc, 0, kPiece,
        [&](int m, int k, FragA& f) {
          float v[4][2];
          gather_a<Lane>(
              [&](int r, int c) {
                const int t = k + c;
                return to_f32(xp[t * Sm::kLdx + p0 + 16 * m + r]) * wp[t];
              },
              v);
          Lane::template a_split<false>(v, f);
        },
        [&](int k, int n, FragB& f) {
          Lane::template b_frag_major<kE>(bp + k * Sm::kLdb + s0 + n, Sm::kLdb,
                                          f);
        });
    if (i + 2 < kPieces) {
      __syncthreads();  // every warp is done with slot i % 2
      load_piece(i + 2);
    }
  }
  const int g4 = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  float* out = a.states + ((b * a.NC + c) * a.H + h) * a.state_floats +
               kP * pt * a.sp + kS * st;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(out + (p0 + 16 * m + g4 + 8 * hr) * a.sp +
                                   s0 + 8 * nt + 2 * t4) =
            make_float2(acc[m][nt][2 * hr], acc[m][nt][2 * hr + 1]);
}

// ---------------------------------------------------------------------------
// pass: entering states, in chunk order, per (b, h) and element of the
// state
// ---------------------------------------------------------------------------

constexpr int kPassThreads = 256;
// blocks per (b, h) and whole P x S tile: one float4 a thread
constexpr int kPassBlocksPerTile = kP * kS / 4 / kPassThreads;

__global__ void __launch_bounds__(kPassThreads)
    ssd_pass_kernel(const SsdArgs a) {
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long step = a.H * (a.state_floats / 4);  // one chunk on
  float4* st = reinterpret_cast<float4*>(a.states) +
               (b * a.NC * a.H + h) * (a.state_floats / 4) +
               static_cast<long long>(blockIdx.x) * kPassThreads +
               threadIdx.x;
  const float* dec = a.decay + (b * a.H + h) * a.NC;
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  constexpr int kAhead = 8;  // loads in flight ahead of the recurrence
  for (long long c0 = 0; c0 < a.NC; c0 += kAhead) {
    float4 v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      if (c0 + k < a.NC) v[k] = st[(c0 + k) * step];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k >= a.NC) break;
      st[(c0 + k) * step] = run;
      const float d = dec[c0 + k];
      run.x = d * run.x + v[k].x;
      run.y = d * run.y + v[k].y;
      run.z = d * run.z + v[k].z;
      run.w = d * run.w + v[k].w;
    }
  }
}

// ---------------------------------------------------------------------------
// out: y of a chunk, per (b, chunk, h)
// ---------------------------------------------------------------------------

constexpr int kOutThreads = 128;  // 4 warps, two row tiles each

template <class Lane>
struct OutSmem {
  using E = typename Lane::E;
  // h is read 4 adjacent k a lane (16 bytes): a row offset of 16 mod 32
  // words keeps a quarter-warp's reads on distinct banks
  static constexpr int kLdh = kS + 16;
  static constexpr int kLdx = ld_major<kP>();
  static constexpr int kHs = 0;
  static constexpr int kXs = kHs + kP * kLdh * 4;
  static constexpr int kDts = kXs + kT * kLdx * sizeof(E);
  static constexpr int kCum = kDts + kT * 4;
  static constexpr int kBytes = kCum + kT * 4;
};

// The out stage's MMAs accumulate in place (mma_split_at with G = 0): at
// 168 registers, three blocks an SM, it has none for a k-step's own
// accumulator; with two blocks an SM it would cost more than the cb and
// state stages' sums apart, and gain less precision (PERF.md section 6).
// Warp w takes row tiles w and kTiles - 1 - w: the triangle's work is the
// same for every warp, and each B fragment (h, x) feeds both tiles. Only h
// and x are staged (72 KB in fp32, three blocks an SM); C and the C B^T
// rows, each read by one warp once, come from global memory (L2: every
// head of a group reads the same) straight into registers, one 16-k block
// ahead of their products, 4 adjacent k a lane: the reduction order of
// C h^T is permuted alike on both sides, and C B^T is stored permuted.
template <class Lane>
__global__ void __launch_bounds__(kOutThreads, 3)
    ssd_out_kernel(const SsdArgs a) {
  using E = typename Lane::E;
  using Sm = OutSmem<Lane>;
  constexpr bool kE = Lane::kDataExact;
  constexpr int kSteps = Lane::kSteps;
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem + Sm::kHs);
  E* xs = reinterpret_cast<E*>(smem + Sm::kXs);
  float* dts = reinterpret_cast<float*>(smem + Sm::kDts);
  float* cum = reinterpret_cast<float*>(smem + Sm::kCum);

  // blockIdx.x: (h, P tile), the P tile fastest (both read the same C)
  const int pt = static_cast<int>(blockIdx.x % a.np);
  const long long h = blockIdx.x / a.np, c = blockIdx.y, b = blockIdx.z;
  const int n = static_cast<int>(a.L - c * kT < kT ? a.L - c * kT : kT);
  const E* cb = static_cast<const E*>(a.C) + b * a.scb + h * a.sch +
                c * kT * a.scl;
  const E* xb = static_cast<const E*>(a.x) + b * a.sxb + h * a.sxh +
                c * kT * a.sxl + kP * pt;
  // rows kP pt .. kP (pt + 1) of h_{c-1}, a row of a.sp floats
  const float* hb = a.states + ((b * a.NC + c) * a.H + h) * a.state_floats +
                    kP * pt * a.sp;
  const float* cbg = a.cb + ((b * a.NC + c) * a.ng + (a.ng == 1 ? 0 : h)) *
                                kCbFloats;
  // group 0: h_{c-1}'s first S tile, under C's first loads; group 1: x,
  // under C h^T
  load_tile(hs, Sm::kLdh, hb, a.sp, 0, kP, 0, kS, kP, kS, true);
  cp_async_commit();
  load_tile(xs, Sm::kLdx, xb, a.sxl, 0, kT, 0, kP, n, a.P - kP * pt,
            a.vec_x);
  cp_async_commit();
  chunk_cum(a, b, h, c, n, dts, cum);

  const int w = threadIdx.x >> 5;
  const int g4 = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
  const int tl[2] = {w, kTiles - 1 - w};  // the warp's row tiles
  float acc[2][8][4];
  zero(acc[0]);
  zero(acc[1]);
  cp_async_wait<1>();
  __syncthreads();  // h and cum

  // C h^T over the state, S tile by S tile in order. Rows past L read row
  // n - 1 (their y is not stored); with S not whole tiles or rows off 16
  // bytes, element loads with checks.
  {
    const int sp = static_cast<int>(a.sp);
    const bool fast = a.vec_bc && a.S == sp;
    const E* crow[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int t = 16 * tl[i] + g4 + 8 * rh;
        crow[i][rh] = cb + (t < n ? t : n - 1) * a.scl;
      }
    // bf16: C's elements are exact, and a row's 4 adjacent ones are the A
    // registers' two pairs as they lie
    constexpr bool kRawC = sizeof(E) == 2;
    float nv[2][2][4];
    uint2 nr[2][2];
    const auto load_c = [&](int kb) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const E* src = crow[i][rh] + kb + 4 * t4;
          if (fast) {
            if constexpr (kRawC)
              nr[i][rh] = __ldg(reinterpret_cast<const uint2*>(src));
            else
              load4(src, nv[i][rh]);
          } else {
            const int t = 16 * tl[i] + g4 + 8 * rh;
            float v[4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
              v[m] = t < n && kb + 4 * t4 + m < a.S ? to_f32(src[m]) : 0.0f;
            if constexpr (kRawC)
              nr[i][rh] = make_uint2(pack_bf16(v[0], v[1]),
                                     pack_bf16(v[2], v[3]));
            else
#pragma unroll
              for (int m = 0; m < 4; ++m) nv[i][rh][m] = v[m];
          }
        }
    };
    load_c(0);
#pragma unroll 1
    for (int k = 0; k < sp; k += 16) {
      const int kb = k % kS;  // the column in the staged S tile
      if (kb == 0 && k > 0) {
        __syncthreads();  // every warp is done with the last S tile of h
        load_tile(hs, Sm::kLdh, hb + k, sp, 0, kP, 0, kS, kP, kS, true);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      FragA fa[2][kSteps];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          if constexpr (kRawC) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
              fa[i][st].hi[r] = r >> 1 ? nr[i][r & 1].y : nr[i][r & 1].x;
          } else {
            Lane::template a_from_block<kE>(nv[i], st, fa[i][st]);
          }
        }
      if (k + 16 < sp) load_c(k + 16);
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        float bv[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(
              hs + (8 * (4 * nh + q) + g4) * Sm::kLdh + kb + 4 * t4);
          bv[q][0] = t.x;
          bv[q][1] = t.y;
          bv[q][2] = t.z;
          bv[q][3] = t.w;
        }
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          FragB fb[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            Lane::template b_from_block<false>(bv[q], st, fb[q]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_split_at<Lane, kE, false, 0>(acc[i], 4 * nh, fa[i][st],
                                             fb);
        }
      }
    }
  }
  // times exp(cum) of each row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float e0 = expf(cum[16 * tl[i] + g4]);
    const float e1 = expf(cum[16 * tl[i] + g4 + 8]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[i][nt][0] *= e0;
      acc[i][nt][1] *= e0;
      acc[i][nt][2] *= e1;
      acc[i][nt][3] *= e1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // x

  // + (C B^T o tril(exp(cum_i - cum_j)) o dt_j) x over j up to each tile's
  // last row (width[0] <= width[1])
  {
    const int width[2] = {16 * (tl[0] + 1), 16 * (tl[1] + 1)};
    const float* grow[2][2];
    float ct[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        grow[i][rh] = cbg + cb_tile_start(tl[i]) + (g4 + 8 * rh) * width[i] +
                      4 * t4;
        ct[i][rh] = cum[16 * tl[i] + g4 + 8 * rh];
      }
    float nv[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) load4(grow[i][rh], nv[i][rh]);
#pragma unroll 1
    for (int kb = 0; kb < width[1]; kb += 16) {
      const bool both = kb < width[0];
      int jj[4];
      float cj[4], dj[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        jj[m] = kb + Lane::logical16(m);
        cj[m] = cum[jj[m]];
        dj[m] = dts[jj[m]];
      }
      FragA fa[2][kSteps];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 0 && !both) continue;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int t = 16 * tl[i] + g4 + 8 * rh;
#pragma unroll
          for (int m = 0; m < 4; ++m)
            nv[i][rh][m] = jj[m] <= t ? nv[i][rh][m] *
                                            expf(ct[i][rh] - cj[m]) * dj[m]
                                      : 0.0f;
        }
#pragma unroll
        for (int st = 0; st < kSteps; ++st)
          Lane::template a_from_block<false>(nv[i], st, fa[i][st]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (kb + 16 < width[i])
#pragma unroll
          for (int rh = 0; rh < 2; ++rh)
            load4(grow[i][rh] + kb + 16, nv[i][rh]);
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        FragB fb[8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          Lane::template b_frag_major<kE>(
              xs + (kb + st * Lane::kK) * Sm::kLdx + 8 * nt, Sm::kLdx, fb[nt]);
        if (both) mma_split_at<Lane, false, kE, 0>(acc[0], 0, fa[0][st], fb);
        mma_split_at<Lane, false, kE, 0>(acc[1], 0, fa[1][st], fb);
      }
    }
  }
  // + D x, stored in x's dtype
  const float Dh = a.D[h];
  E* yb = static_cast<E*>(a.y) + ((b * a.L + c * kT) * a.H + h) * a.P +
          kP * pt;
  const long long y_row = a.H * a.P;
  const int pn = a.P - kP * pt;  // this tile's columns of y
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * tl[i] + g4 + 8 * (e >> 1);
        const int p = 8 * nt + 2 * t4 + (e & 1);
        if (t < n && p < pn)
          yb[t * y_row + p] =
              from_f32<E>(acc[i][nt][e] + to_f32(xs[t * Sm::kLdx + p]) * Dh);
      }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <class Lane>
int launch(const SsdArgs& a, long long B, cudaStream_t stream) {
  cudaError_t err;
  if ((err = set_smem(ssd_cb_kernel<Lane>, CbSmem<Lane>::kBytes)) ||
      (err = set_smem(ssd_state_kernel<Lane>, StateSmem<Lane>::kBytes)) ||
      (err = set_smem(ssd_out_kernel<Lane>, OutSmem<Lane>::kBytes)))
    return static_cast<int>(err);
  const unsigned nc = static_cast<unsigned>(a.NC);
  const unsigned h = static_cast<unsigned>(a.H);
  const unsigned bb = static_cast<unsigned>(B);
  const unsigned tiles = static_cast<unsigned>(a.np * a.ns);
  ssd_cb_kernel<Lane><<<dim3(a.ng, nc, bb), kThreads, CbSmem<Lane>::kBytes,
                        stream>>>(a);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_state_kernel<Lane><<<dim3(h * tiles, nc, bb), kStateThreads,
                           StateSmem<Lane>::kBytes, stream>>>(a);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_pass_kernel<<<dim3(kPassBlocksPerTile * tiles, h, bb), kPassThreads, 0,
                    stream>>>(a);
  if ((err = cudaGetLastError())) return static_cast<int>(err);
  ssd_out_kernel<Lane><<<dim3(h * a.np, nc, bb), kOutThreads,
                         OutSmem<Lane>::kBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Tiles, chunk and scratch sizes the wrapper plans and allocates with.
int trim_ssd_tile_p() { return kP; }
int trim_ssd_tile_s() { return kS; }
int trim_ssd_chunk() { return kT; }
int trim_ssd_cb_floats() { return kCbFloats; }
int trim_ssd_pass_blocks_per_tile() { return kPassBlocksPerTile; }

const char* trim_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, L, H, P) with element strides (sxb, sxl, sxh, 1); dt (B, L, H)
// fp32 with strides (sdb, sdl, sdh); A, D (H,) fp32 contiguous; Bm, Cm
// (B, L, H, S) in x's dtype with strides (s*b, s*l, s*h, 1), s*h may be 0;
// y (B, L, H, P) contiguous in x's dtype. bf16 != 0 selects bfloat16 for
// x, Bm, Cm and y, else fp32. Any P, S >= 1. Scratch, fp32 and contiguous,
// NC = ceil(L / trim_ssd_chunk()), P' and S' P and S rounded up to whole
// tiles (trim_ssd_tile_p(), trim_ssd_tile_s()): states (B, NC, H, P', S'),
// cb (B, NC, ng, trim_ssd_cb_floats()), decay (B, H, NC); ng is 1 when Bm
// and Cm both have stride 0 over H (one group, C B^T shared by the heads),
// else H. vec_x / vec_bc: every row of x / of Bm and Cm starts on 16 bytes
// and its P / S elements are whole 16 bytes. Returns cudaErrorInvalidValue
// for arguments out of range, among them a call the launch grid cannot
// hold (B, NC or H past 65535, H x tiles past 2^31 - 1, S' from 2^30),
// else the first launch's cudaError_t that is not cudaSuccess, or
// cudaSuccess.
int trim_ssd(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* D, void* y, void* states, void* cb,
             void* decay, int bf16, long long B, long long L, long long H,
             int P, int S, int ng, int vec_x, int vec_bc, long long sxb,
             long long sxl, long long sxh, long long sdb, long long sdl,
             long long sdh, long long sbb, long long sbl, long long sbh,
             long long scb, long long scl, long long sch, void* stream) {
  const long long np = (P + kP - 1) / kP, ns = (S + kS - 1) / kS;
  const long long NC = (L + kT - 1) / kT;
  if (P < 1 || S < 1 || L < 1 || H < 1 || B < 1 || B > 65535 ||
      NC > 65535 || H > 65535 || H * np * ns > 0x7fffffffLL ||
      kS * ns >= (1LL << 30) ||
      kPassBlocksPerTile * np * ns > 0x7fffffffLL ||
      !(ng == 1 || ng == H) || (ng == 1 && H > 1 && (sbh != 0 || sch != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = Bm;
  a.C = Cm;
  a.D = static_cast<const float*>(D);
  a.y = y;
  a.states = static_cast<float*>(states);
  a.cb = static_cast<float*>(cb);
  a.decay = static_cast<float*>(decay);
  a.L = L;
  a.H = H;
  a.NC = NC;
  a.P = P;
  a.S = S;
  a.ng = ng;
  a.np = static_cast<int>(np);
  a.ns = static_cast<int>(ns);
  a.sp = kS * ns;
  a.state_floats = kP * np * kS * ns;
  a.vec_x = vec_x;
  a.vec_bc = vec_bc;
  a.sxb = sxb;
  a.sxl = sxl;
  a.sxh = sxh;
  a.sdb = sdb;
  a.sdl = sdl;
  a.sdh = sdh;
  a.sbb = sbb;
  a.sbl = sbl;
  a.sbh = sbh;
  a.scb = scb;
  a.scl = scl;
  a.sch = sch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<Bf16Lane>(a, B, s);
  return launch<F32Lane>(a, B, s);
}

}  // extern "C"
