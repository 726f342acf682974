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
// Three kernels, chosen by dtype and shape:
// - bf16, more than kSplitRows flattened rows (prefill): warpgroup MMA
//   (wgmma) on K and V tiles brought in by TMA (one CUtensorMap each over
//   (D, Sk, H, B) with the caller's strides, 128-byte swizzle) into a
//   ring of stages with mbarriers. A block owns 64 rows per warpgroup
//   (16 positions x G = 4: the G q heads of a KV head share every tile)
//   of one (b, h). Each warpgroup loads its Q once into shared memory
//   (cp.async, the same swizzle); per tile S = Q K^T is wgmma with both
//   operands in shared memory, the softmax runs on S in registers (exp2
//   with scale * log2(e) folded into one FFMA; the mask only on tiles
//   that cross the causal diagonal or n_valid; fp32 m, l and O), and
//   O += P V is wgmma with P (rounded to bf16 once: the one rounding this
//   lane adds beyond the output's) in registers and V read MN-major (the
//   transpose bit). Blocks take the (b, h) pairs two by two, the longest
//   (last) row tiles of the two first (prefill_block); the sums run in a
//   fixed order (the same bits every call).
//   flash_prefill_kernel (D = 128, 256) has no warp that only loads:
//   ptxas gives every thread of a block the same registers, and a block
//   of 2 warpgroups plus one loading warp puts 3 warps on one of an SM's
//   four 16384-register sub-partitions, capping every thread at 168
//   registers; setmaxnreg does not lift that cap for ptxas, which then
//   spills and serializes the wgmma chain. Two warpgroups alone get 255.
//   Thread 0 loads the first kStages tiles, and the last warp to read a
//   stage (a shared-memory count) loads the tile kStages on into it, so
//   no warp waits for a free slot.
//   * D = 256 (gemma-7b): 128 rows, 80-key tiles, 2 stages, 256 threads.
//     Shared memory: Q 2 x 64 x 256 x 2 B = 64 KB, K and V 2 stages x
//     2 x 80 x 256 x 2 B = 160 KB: 224 KB + 48 B of barriers and counts,
//     of the 227 KB of a block. Registers a thread: O 64 x 256 fp32 / 128
//     threads = 128, S 64 x 80 / 128 = 40, P 20 (bf16 pairs), all live at
//     once, and the rest for addresses and row state: ptxas uses 232 of
//     255, no spill. The warpgroup overlaps its own chain: tile j's S = Q K_j^T
//     and the previous tile's O += P_{j-1} V_{j-1} are issued together,
//     the softmax of S_j runs while P_{j-1} V_{j-1} is still on the
//     tensor cores (wgmma_wait<1>), and O is rescaled once that is done
//     (only when a row's max has grown by 2^kRescaleLog2, at D = 128 too).
//     K and V of a stage have mbarriers and counts of their own: K is
//     freed once S is in, V once P V is done.
//   * D = 128: 128 rows, 128-key tiles, 2 stages, the serial chain (S,
//     softmax, P V; one mbarrier and count a stage); 32 + 128 KB.
//   flash_prefill_wg_kernel (D <= 64, the head dim padded to 64 columns)
//   keeps a producer warpgroup beside three consumers (its comment says
//   why): 192 rows, 128-key tiles, 3 stages, the serial chain.
// - bf16, at most kSplitRows rows (decode): split over the keys in one
//   launch (flash-decoding). Blocks (split, h, b); a split is whole
//   kSplitTile-key tiles, planned on the host from B, H, the rows and Sk
//   alone (flash_attention.py:decode_splits). In a block each of 4 warps
//   streams 32-key sub-tiles round robin through its own 2-stage cp.async
//   ring (keys past the split or n_valid zero-filled, never read), with
//   the mma.sync m16n8k16 inner loop on its 16-row fragment (16-key
//   sub-tiles at D = 256, so that the 4 rings fit in 132 KB); the warps'
//   (m, l, acc) merge in shared memory, the block writes its fp32 partial
//   to the caller's scratch, and the block that arrives last at its
//   (b, h)'s counter merges every split in split order (the log-sum-exp
//   merge of src/repro/nn/decode_attn.py:128-132; the same bits every
//   call) and resets the counter to 0. The counters are the wrapper's,
//   one buffer per stream: two launches in flight at once must not share
//   one.
// - fp32: IEEE FMAs on the CUDA cores (no TF32), register-tiled, on the
//   head dim padded to 32 columns (F32Tile<D>, F32Split<D>).
//   * More than kSplitRows rows (prefill, flash_prefill_f32_kernel): a
//     block of 8 warps owns 128 rows of one (b, h), taken in
//     prefill_block's order; Q stays in shared memory, K and V come in
//     tiles (64 keys at D <= 64, 32 at 128, 16 at 256) through a 2-stage
//     cp.async ring in dynamic shared memory (keys past n_valid and
//     columns past D zero-filled). A warp owns 16 rows; its lane (rg, kg)
//     = (lane / 8, lane % 8) holds rows rg + 4 i (i < 4) x keys kg + 8 j of
//     S = Q K^T and the same rows x columns 4 kg + 32 c (+ 0..3) of O, so
//     one float4 read from shared memory feeds 4 to 8 FMAs: per 4 columns
//     of the head dim 4 Q and kKeys / 8 K float4s for 16 kKeys / 8 FMAs;
//     per 4 keys of P V 4 P float4s and 4 kDP / 32 V float4s for 16 kDP /
//     8 FMAs. Rows and keys are padded (Q, K rows by 4 floats, P rows by 8)
//     so that the 4 rows and 8 keys a warp reads at once, and P's writes,
//     fall in distinct banks. The softmax runs on S in registers (exp2
//     with scale * log2(e) folded into one FFMA, row max over the 8 lanes
//     of a row by shuffles), P passes to P V through the warp's own rows
//     of shared memory (a __syncwarp, no block barrier), one
//     __syncthreads a tile guards the ring. A warp skips the tiles past
//     its own rows' causal reach; the mask runs only on tiles that cross
//     n_valid or the warp's diagonal.
//   * At most kSplitRows rows (decode, flash_decode_split_f32_kernel): the
//     bf16 split decode's plan and merge (decode_splits, the last block
//     merging the fp32 partials in split order), with fp32 sub-tiles: a
//     warp's sub-tile is 32 segments of 32 floats (32 / (kDP / 32) keys),
//     one a lane for S (partial dots summed over a key's segments by
//     shuffles), and for P V a lane owns float4 columns of every row
//     (with the keys cut among lane groups below kDP = 128).
//
// Head dims: 8, 16, 32, 64, 128 and 256, the ones the Pallas kernel is
// driven at (it blocks only the sequence). Below a lane's unit of the
// head dim (64 on the prefill, 32 on the split decode and the fp32 lane)
// a kernel works on the dim padded with zeros to that unit: it
// reads the D real columns of q, k and v (TMA fills the box's columns
// past D with zeros, cp.async zero-fills, the fp32 loads select 0),
// writes the D real columns of the output, and scales by D^-0.5 of the
// true D. Nothing is padded in device memory.
//
// What the TPU kernel keeps out of device memory, and how this one does:
// - The (Sq, Sk) scores never reach device memory: (m, l, acc) live in
//   registers across the key loop (the Pallas kernel keeps them in VMEM
//   scratch across its sequential kv grid axis; a CUDA block loops).
// - Tiles that causality or kv_length mask whole are never loaded: the key
//   loop ends at min(Sk, kv_length[b], q_offset + last row's s + 1) (the
//   Pallas kernel's pl.when skip). A stale or uninitialised KV cache past
//   the length never reaches the sum: its scores are selected to -inf,
//   and its V rows are zero-filled (cp.async) or, in the one TMA tile that
//   holds n_valid, zeroed in shared memory before P V (0 x NaN is NaN).
// - q, k, v are read in place through their strides (a view of the q
//   projection, a KV cache of S_max rows): no transpose to (B, H, S, D), no
//   repeat of the KV heads, no padding copy for ragged Sq or Sk (TMA
//   zero-fills rows past Sk).
//
// What bounds it: at the prefill shape (Sq = Sk = 4096, D = 64, G = 4)
// 4 Sq Sk D H G / 2 operations (causal) against (|q| + |k| + |v| + |out|)
// bytes: far above the ridge, so bound by bf16 tensor-core operations; at
// D = 64 one exp2 per score costs the MUFU unit as much time as the
// score's 256 tensor-core operations, which the consumer warpgroups
// overlap with each other's products (a third warpgroup at D = 64 hides
// more of each one's serial product-softmax-product chain); at D = 256
// the products are 4x the exp2s' time, and the shared memory's 128 bytes
// a clock an SM come near their bound too (each warpgroup's m64n80k16
// reads 2 KB of Q and 2.5 KB of K from shared memory, each m64n128k16 of
// P V 4 KB of V, besides the TMA writes). At decode
// (Sq = 1) 4 G D operations per key against 4 D bytes read per key: bound
// by the bytes of the K/V cache read, so the split puts enough blocks in
// flight to fill the card. The fp32 prefill is bound by the FMAs (4 Sq Sk
// D H G / 2 causal at 67 TFLOP/s); a thread's tile keeps its shared-memory
// reads below its FMAs (12 float4s for 128 FMAs at D = 64), so that the
// FMA pipes, not the shared memory, set the pace.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
// bf16 prefill: keys per K/V tile at D = 256 (PfTile<D> and PfWgTile<D>
// give each head dim's geometry)
constexpr int kD256Keys = 80;
// flash_prefill_kernel's running row max moves once a new one exceeds it
// by 2^kRescaleLog2 (in the scores' units: 256x)
constexpr float kRescaleLog2 = 8.0f;
// (b, h) pairs whose blocks the prefill runs together (prefill_block)
constexpr long long kPrefillPairs = 2;
// bf16 split decode: rows (one mma.sync fragment), the split's unit in
// keys, warps, stages of a warp's ring (SplitSmem<D> gives a warp's
// sub-tile in keys)
constexpr int kSplitRows = 16;
constexpr int kSplitTile = 64;
constexpr int kSplitWarps = kThreads / 32;
constexpr int kSplitStages = 2;

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
  // (B, Sq, H, G) each, or null: the partial entry's row max (in
  // natural-log units) and row sum, written beside the normalised output
  float* m_out;
  float* l_out;
};

struct SplitArgs {
  float* scratch;  // (B, H, n_split, M, D + 2): acc, m, l; null if n_split 1
  int* counters;   // (B, H) arrivals, 0 between launches
  int n_split;
  int split_tiles;  // kSplitTile-key tiles per split
};

// The partial entry's statistics of row r of (b, h) on the split path: m
// from units of log2 to natural-log units (a row with no visible key keeps
// kNegInf's order).
__device__ __forceinline__ void write_stats(const FlashArgs& a, long long b,
                                            long long h, int r, float m,
                                            float l) {
  const long long i = ((b * a.Sq + r / a.G) * a.H + h) * a.G + r % a.G;
  a.m_out[i] = m * 0.6931471805599453f;
  a.l_out[i] = l;
}

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

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// 2^x on the MUFU unit (-inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, fp32) = A (64 x 16) B (16 x 128) [+ d when scale_d], bf16 in:
// A and B from shared memory, both K-major (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 80, fp32) = A (64 x 16) B (16 x 80) [+ d when scale_d], bf16 in:
// A and B from shared memory, both K-major (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_m64n80(float (&d)[40], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// bf16 prefill: wgmma, TMA, a producer warp and two or three consumers
// ---------------------------------------------------------------------------

// The block's geometry at head dim D = 128 or 256 (tile arithmetic in the
// file header). Dynamic shared memory, in bytes from a 1024-byte aligned
// base: each warpgroup's Q (64 rows), then the ring of kStages (K tile, V
// tile) pairs, then a K and a V mbarrier a stage (the tile has landed)
// and a K and a V count a stage of the warps that have read it (K is read
// once S is in, V once P V is done). A tile is D / 64 column blocks of 64
// bf16 x rows, each row 128 bytes in the 128-byte swizzle (what TMA
// writes and wgmma reads).
template <int D>
struct PfTile {
  static_assert(D == 128 || D == 256, "flash_prefill_kernel is built for "
                "D = 128 and 256 (flash_prefill_wg_kernel takes D <= 64)");
  static constexpr int kDP = D;  // the head dim
  // two warpgroups of 64 rows, rows and threads per block; ptxas may give
  // every thread 255 registers under __launch_bounds__(kThreads, 1): each
  // of an SM's four 16384-register sub-partitions holds 2 of the 8 warps
  static constexpr int kWGs = 2;
  static constexpr int kRows = 64 * kWGs;
  static constexpr int kThreads = 128 * kWGs;
  static constexpr int kRegs = 255;
  static constexpr int kKeys = D == 256 ? kD256Keys : 128;  // keys per tile
  static constexpr int kStages = 2;
  static constexpr bool kOverlap = D == 256;
  static constexpr int kDB = kDP / 64;           // 64-column blocks
  static constexpr int kQBlk = 64 * 128;         // a Q column block
  static constexpr int kBlk = kKeys * 128;       // a K or V column block
  static constexpr int kWgQ = kDB * kQBlk;       // one warpgroup's Q
  static constexpr int kTile = kDB * kBlk;       // one K or V tile
  static constexpr int kRing = kWGs * kWgQ;
  static constexpr int kBar = kRing + kStages * 2 * kTile;
  // + two mbarriers and two arrival counters a stage, + alignment
  static constexpr int kBytes = kBar + 2 * kStages * (8 + 4) + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
  // a thread's O (kDP / 2 fp32) and S (kKeys / 2 fp32), and with the
  // overlap P (kKeys / 4 bf16 pairs) too, live together, with at least 24
  // registers left for addresses and row state
  static_assert(kDP / 2 + kKeys / 2 + (kOverlap ? kKeys / 4 : 0) + 24 <= kRegs,
                "O, S and P do not fit a thread's registers");
};

// Block -> (row tile r0, b, h) of either prefill kernel: the (b, h) pairs
// in groups of kPrefillPairs, in a group the last (longest, when causal)
// row tiles first, of each pair in turn. The blocks in flight then read
// the K and V of a few pairs, which stay in L2 (with every pair's row
// tile taken in turn, the blocks in flight span up to 132 pairs, whose K
// and V L2 does not hold: 4 MB a pair at gemma-7b's 4096 keys).
__device__ __forceinline__ void prefill_block(long long n_rt, long long BH,
                                              long long H, int rows,
                                              long long& r0, long long& b,
                                              long long& h) {
  const long long bid = blockIdx.x;
  const long long g0 = bid / (kPrefillPairs * n_rt) * kPrefillPairs;
  const long long in_g = bid % (kPrefillPairs * n_rt);
  const long long g_n = kPrefillPairs < BH - g0 ? kPrefillPairs : BH - g0;
  const long long bh = g0 + in_g % g_n;
  r0 = (n_rt - 1 - in_g / g_n) * rows;
  b = bh / H;
  h = bh % H;
}

// The shared-memory descriptors step by their start address: adding
// bytes / 16 to one moves it that many bytes (no carry out of its 14-bit
// address field within a block's shared memory).

// S = Q K^T of one warpgroup's 64 rows (64 x kKeys, fp32), both operands
// in shared memory, K-major (descriptors dq of its Q, dk of the K tile).
template <int D>
__device__ __forceinline__ void prefill_qk(float (&s)[PfTile<D>::kKeys / 2],
                                           uint64_t dq, uint64_t dk) {
  using L = PfTile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t a = dq + ((kk / 4) * L::kQBlk + (kk % 4) * 32) / 16;
    const uint64_t b = dk + ((kk / 4) * L::kBlk + (kk % 4) * 32) / 16;
    if constexpr (L::kKeys == 128)
      wgmma_ss_m64n128(s, a, b, kk > 0);
    else
      wgmma_ss_m64n80(s, a, b, kk > 0);
  }
}

// O += P V: P from registers (the accumulator layout of S is the
// A-fragment layout of P), 16 keys per wgmma, the V tile (descriptor dv)
// read MN-major; at D = 128 one m64n128 a 16 keys, at D = 256 two.
template <int D>
__device__ __forceinline__ void prefill_pv(
    float (&o)[PfTile<D>::kDP / 2],
    const uint32_t (&p)[PfTile<D>::kKeys / 16][4], uint64_t dv) {
  using L = PfTile<D>;
#pragma unroll
  for (int kk = 0; kk < L::kKeys / 16; ++kk)
#pragma unroll
    for (int hh = 0; hh < L::kDP / 128; ++hh)
      wgmma_rs_m64n128(*reinterpret_cast<float(*)[64]>(o + 64 * hh), p[kk],
                       dv + (hh * 2 * L::kBlk + kk * 16 * 128) / 16);
}

template <int D>
__global__ void __launch_bounds__(PfTile<D>::kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const FlashArgs a, const int B) {
  using L = PfTile<D>;
  constexpr int kDP = L::kDP;
  constexpr int kDB = L::kDB;
  constexpr int kKeys = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  // warp-uniform by construction (a lane's broadcast): the barriers' and
  // descriptors' arithmetic stays in uniform registers
  const uint32_t sbase = __shfl_sync(0xffffffffu, smem_addr(sm), 0);
  // stage st's K tile has landed: the mbarrier at kfull + 8 st; its V
  // tile: vfull + 8 st; the warps that have read its K (V), counted up
  // without reset: arrivals[st] (arrivals[kStages + st])
  const uint32_t kfull = sbase + L::kBar;
  const uint32_t vfull = kfull + 8 * L::kStages;
  int* arrivals = reinterpret_cast<int*>(sm + L::kBar + 16 * L::kStages);

  const long long M = a.Sq * a.G;
  const long long BH = static_cast<long long>(B) * a.H;
  const long long n_rt = (M + L::kRows - 1) / L::kRows;
  long long r0, b, h;
  prefill_block(n_rt, BH, a.H, L::kRows, r0, b, h);
  const int n_valid = static_cast<int>(valid_keys(a, b));
  const int n_keys = static_cast<int>(loop_keys(a, n_valid, r0, L::kRows));
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  // K_t (kv 0), V_t (kv 1) or both (kv 2) into stage t % kStages, by one
  // thread; the serial chain waits for both on the K mbarrier.
  auto load = [&](int kv, int t) {
    const int st = t % L::kStages;
    const uint32_t full = (kv == 1 ? vfull : kfull) + 8 * st;
    mbar_arrive_expect_tx(full, (kv == 2 ? 2 : 1) * L::kTile);
#pragma unroll
    for (int i = kv & 1; i < (kv ? 2 : 1); ++i)
#pragma unroll
      for (int db = 0; db < kDB; ++db)
        tma_load_4d(sbase + L::kRing + st * 2 * L::kTile + i * L::kTile +
                        db * L::kBlk,
                    i ? &v_map : &k_map, full, db * 64, t * kKeys,
                    static_cast<int>(h), static_cast<int>(b));
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(kfull + 8 * st, 1);
      mbar_init(vfull + 8 * st, 1);
      arrivals[st] = arrivals[L::kStages + st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < L::kStages && t < n_tiles; ++t) {
      if (L::kOverlap) {
        load(0, t);
        load(1, t);
      } else {
        load(2, t);
      }
    }
  }
  __syncthreads();

  // Warpgroup wg owns rows [r0 + 64 wg, r0 + 64 wg + 64).
  const int ct = threadIdx.x % 128;
  // warp-uniform by construction, as sbase
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int warp = ct / 32;
  const int lane = ct % 32;
  const int g8 = lane >> 2;  // accumulator row within 8
  const int t4 = lane & 3;   // accumulator column pair
  const long long wr0 = r0 + wg * 64;
  // this warpgroup's Q, stage st's K tile and V tile (descriptors made
  // where they are used, from warp-uniform addresses)
  const uint32_t qs = sbase + wg * L::kWgQ;
  auto dk = [&](int st) {
    return sw128_desc(sbase + L::kRing + st * 2 * L::kTile, 16);
  };
  auto dv = [&](int st) {
    return sw128_desc(sbase + L::kRing + st * 2 * L::kTile + L::kTile,
                      L::kBlk);
  };
  {
    // Q into shared memory once by cp.async, in the tiles' swizzle; rows
    // past M are zero-filled.
    constexpr int kChunks = kDP / 8;  // 16-byte chunks per row
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
    for (int i = ct; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const long long row = wr0 + r;
      const bool ok = row < M;
      cp_async16(sm + wg * L::kWgQ + (c / 8) * L::kQBlk + r * 128 +
                     (((c % 8) ^ (r & 7)) << 4),
                 ok ? qb + (row / a.G) * a.qss + (row % a.G) * a.qsg + c * 8
                    : qb,
                 ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }

  // This thread's two rows (g8, g8 + 8 of its warp's 16): the last key
  // each sees when causal; the warpgroup's first row's, for the tiles that
  // need no causal mask.
  long long row[2];
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wr0 + warp * 16 + g8 + 8 * i;
    last[i] = static_cast<int>(a.q_offset + row[i] / a.G);
  }
  const int first_last = static_cast<int>(a.q_offset + wr0 / a.G);
  const int Sk = static_cast<int>(a.Sk);
  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)

  float o[kDP / 2];  // o[4 j + 2 i + c]: row i, column 8 j + 2 t4 + c
#pragma unroll
  for (int e = 0; e < kDP / 2; ++e) o[e] = 0.0f;
  // S = Q K^T of a tile (64 x kKeys, fp32): s[4 n + 2 i + c] is row i,
  // key 8 n + 2 t4 + c; after the softmax, P unrounded
  float s[kKeys / 2];
  uint32_t p[kKeys / 16][4];  // P in bf16, the A fragments of P V
  float m_run[2] = {-INFINITY, -INFINITY};  // in units of log2
  float l_run[2] = {0.0f, 0.0f};  // this thread's share; summed at the end
  float alpha[2], rs[2];
  bool rescale = false;  // the warp's last softmax moved its running max

  // The tile holding n_valid: TMA zero-fills only past Sk, and V rows in
  // [n_valid, Sk) may hold anything (a cache past kv_length). Each
  // warpgroup zeroes them before its P V of the tile (both write the same
  // zeros).
  auto zero_v = [&](int j, int st) {
    const int key0 = j * kKeys;
    if (key0 + kKeys > n_valid && n_valid < Sk) {
      unsigned char* vg = sm + L::kRing + st * 2 * L::kTile + L::kTile;
      for (int i = ct; i < kKeys * kDB * 8; i += 128) {
        const int r = i / (kDB * 8);
        const int c = i % (kDB * 8);
        if (key0 + r >= n_valid)
          *reinterpret_cast<uint4*>(vg + (c / 8) * L::kBlk + r * 128 +
                                    (c % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    }
  };
  // The online softmax of tile j on S in registers, in units of log2:
  // p = 2^(s sl2 - m) (exp2 with scale * log2(e) folded into one FFMA),
  // the mask only on tiles that cross n_valid or the causal diagonal.
  // Leaves P (unrounded) in s, whether O is to be rescaled in rescale,
  // each row's factor in alpha (1 where not) and its sum of P in rs;
  // touches no O.
  auto softmax = [&](int j) {
    const int key0 = j * kKeys;
    if (key0 + kKeys > n_valid ||
        (a.causal && key0 + kKeys - 1 > first_last)) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + n * 8 + t4 * 2 + (c & 1);
          if (key >= n_valid || (a.causal && key > last[c >> 1]))
            s[4 * n + c] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[4 * n + c]);
    float m_new[2], mu[2];
    bool grow = false;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m_run[i], mx[i] * sl2);
      grow |= m_new[i] > m_run[i] + kRescaleLog2;
    }
    // The running max moves only when a row of the warp outgrows it by
    // 2^kRescaleLog2: then every row takes its new max and O its rescale
    // (warp-wide, so the 2 x kDP / 2 multiplies are skipped or done by the
    // whole warp). Else P is taken against the older max: each p is at most
    // 2^kRescaleLog2, which fp32 l and O hold and bf16 rounds to the same
    // relative precision, and O / l is the same sum.
    rescale = __any_sync(0xffffffffu, grow);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = 1.0f;
      if (rescale) {
        const float m = m_new[i] == -INFINITY ? 0.0f : m_new[i];
        alpha[i] = ex2(m_run[i] - m);
        m_run[i] = m_new[i];
      }
      mu[i] = m_run[i] == -INFINITY ? 0.0f : m_run[i];  // a row with no key
      rs[i] = 0.0f;
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[4 * n + c] = ex2(fmaf(s[4 * n + c], sl2, -mu[c >> 1]));
        rs[c >> 1] += s[4 * n + c];
      }
  };
  // P rounded to bf16 once: the one rounding this lane adds beyond the
  // output's.
  auto round_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  // This warp has read K_t (kv 0), V_t (kv 1) or both (kv 2): the last
  // of the block's warps to say so for a stage loads the tile kStages on
  // into it. No warp only loads (with one, a sub-partition would hold
  // three warps and ptxas would cap every thread at 168 registers), and
  // none waits for a free slot. Each warp's reads of the stage are done
  // (wgmma_wait) before its count, so the load follows all of them.
  auto release = [&](int kv, int t) {
    if (lane == 0) {
      const int before =
          atomicAdd(arrivals + (kv & 1) * L::kStages + t % L::kStages, 1);
      if ((before + 1) % (4 * L::kWGs) == 0 && t + L::kStages < n_tiles)
        load(kv, t + L::kStages);
    }
  };

  if (!L::kOverlap) {
    // The serial chain: S_j, its softmax, then O += P_j V_j.
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % L::kStages;
      mbar_wait(kfull + 8 * st, (j / L::kStages) & 1);
      wgmma_fence();
      prefill_qk<D>(s, sw128_desc(qs, 16), dk(st));
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      softmax(j);
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
      if (rescale) {
#pragma unroll
        for (int e = 0; e < kDP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      }
      round_p();
      zero_v(j, st);
      wgmma_fence();
      prefill_pv<D>(o, p, dv(st));
      wgmma_commit();
      wgmma_wait<0>();
      pin(o);
      release(2, j);
    }
  } else if (n_tiles > 0) {
    // Tile 0: S, then its softmax (O is still 0: nothing to rescale).
    mbar_wait(kfull, 0);
    wgmma_fence();
    prefill_qk<D>(s, sw128_desc(qs, 16), dk(0));
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);
    release(0, 0);
    softmax(0);
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = rs[i];
    round_p();
    // Tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} issued together; the
    // softmax of S_j runs on the CUDA cores and MUFU while the tensor
    // cores still work on P_{j-1} V_{j-1}; O is rescaled once that is done.
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % L::kStages;
      const int prev = (j - 1) % L::kStages;
      mbar_wait(kfull + 8 * st, (j / L::kStages) & 1);
      mbar_wait(vfull + 8 * prev, ((j - 1) / L::kStages) & 1);
      zero_v(j - 1, prev);
      wgmma_fence();
      prefill_qk<D>(s, sw128_desc(qs, 16), dk(st));
      wgmma_commit();
      prefill_pv<D>(o, p, dv(prev));
      wgmma_commit();

      wgmma_wait<1>();  // S_j is in
      pin(s);
      release(0, j);
      softmax(j);
      wgmma_wait<0>();  // and P_{j-1} V_{j-1}
      pin(o);
      release(1, j - 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
      if (rescale) {
#pragma unroll
        for (int e = 0; e < kDP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
      }
      round_p();
    }
    const int st = (n_tiles - 1) % L::kStages;
    mbar_wait(vfull + 8 * st, ((n_tiles - 1) / L::kStages) & 1);
    zero_v(n_tiles - 1, st);
    wgmma_fence();
    prefill_pv<D>(o, p, dv(st));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
    release(1, n_tiles - 1);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[i] >= M) continue;
    const float den = fmaxf(l, 1e-20f);
    __nv_bfloat16* dst =
        out +
        (((b * a.Sq + row[i] / a.G) * a.H + h) * a.G + row[i] % a.G) * D +
        t4 * 2;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(dst + jd * 8) = __floats2bfloat162_rn(
          o[4 * jd + 2 * i] / den, o[4 * jd + 2 * i + 1] / den);
  }
}

// The prefill at D <= 64 (granite-3-2b's and seamless-m4t-large-v2's head
// dim, 64, and the smoke configs' 8-32, padded to 64 columns): three
// consumer warpgroups and a producer warpgroup, cut to 24
// registers by setmaxnreg, whose one thread keeps a 3-stage ring of
// 128-key K and V tiles full; each consumer runs the serial chain (S, its
// softmax, P V). ptxas caps the 512 threads at 128 registers, which the
// serial chain fits. At D = 64 the loop is held by the CUDA cores and
// MUFU as much as by the tensor cores, and this layout keeps the tile
// arithmetic (descriptors, barriers) in the producer and the uniform
// datapath: on the H100 it runs granite-3-2b's and the seamless encoder's
// prefills faster than a two-warpgroup block without a producer (PERF.md,
// kernel 5). Below D = 64 every product runs on the padded 64 columns
// (their Q and K columns past D are zeros), so that the code is D = 64's:
// skipping the zero slices of S = Q K^T left ptxas 8 bytes short at 128
// registers. Dynamic shared memory, in bytes from a 1024-byte aligned
// base: each consumer warpgroup's Q (64 rows), then the ring of kStages
// (K tile, V tile) pairs, then the full and empty mbarriers, in the layout
// of PfTile's.
template <int D>
struct PfWgTile {
  static_assert(D <= 64, "the producer-warpgroup prefill is built for "
                "D <= 64");
  static constexpr int kDP = 64;  // the head dim, padded
  // consumer warpgroups of 64 rows, rows and threads per block (with the
  // producer warpgroup), registers of a consumer thread after setmaxnreg
  // (the producer keeps 24: 128 x 24 + 128 kWGs x kRegs <= 65536), keys
  // per K/V tile
  static constexpr int kWGs = 3;
  static constexpr int kRows = 64 * kWGs;
  static constexpr int kThreads = 128 * (kWGs + 1);
  static constexpr int kRegs = 160;
  static constexpr int kStages = 3;
  static constexpr int kKeys = 128;
  static constexpr int kDB = kDP / 64;           // 64-column blocks
  static constexpr int kQBlk = 64 * 128;         // a Q column block
  static constexpr int kBlk = kKeys * 128;       // a K or V column block
  static constexpr int kWgQ = kDB * kQBlk;       // one warpgroup's Q
  static constexpr int kTile = kDB * kBlk;       // one K or V tile
  static constexpr int kRing = kWGs * kWgQ;
  static constexpr int kBar = kRing + kStages * 2 * kTile;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;  // + alignment
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

template <int D>
__global__ void __launch_bounds__(PfWgTile<D>::kThreads, 1)
flash_prefill_wg_kernel(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const FlashArgs a, const int B) {
  using L = PfWgTile<D>;
  constexpr int kDP = L::kDP;
  constexpr int kDB = L::kDB;
  constexpr int kKeys = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = smem_addr(sm);
  const uint32_t full0 = sbase + L::kBar;  // full[st] at full0 + 8 st
  const uint32_t empty0 = full0 + 8 * L::kStages;

  const long long M = a.Sq * a.G;
  const long long BH = static_cast<long long>(B) * a.H;
  const long long n_rt = (M + L::kRows - 1) / L::kRows;
  long long r0, b, h;
  prefill_block(n_rt, BH, a.H, L::kRows, r0, b, h);
  const int n_valid = static_cast<int>(valid_keys(a, b));
  const int n_keys = static_cast<int>(loop_keys(a, n_valid, r0, L::kRows));
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, 4 * L::kWGs);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full, kStages tiles ahead. A box
    // is 64 columns wide, so the bytes of a tile are the same below
    // D = 64 (its columns past D come in as zeros).
    regs_dec<24>();
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % L::kStages;
        mbar_wait(empty0 + 8 * st, ((j / L::kStages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_arrive_expect_tx(full, 2 * L::kTile);
        const uint32_t ks = sbase + L::kRing + st * 2 * L::kTile;
#pragma unroll
        for (int db = 0; db < kDB; ++db) {
          tma_load_4d(ks + db * L::kBlk, &k_map, full, db * 64, j * kKeys,
                      static_cast<int>(h), static_cast<int>(b));
          tma_load_4d(ks + L::kTile + db * L::kBlk, &v_map, full, db * 64,
                      j * kKeys, static_cast<int>(h), static_cast<int>(b));
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [r0 + 64 wg, r0 + 64 wg + 64).
  regs_inc<L::kRegs>();
  const int ct = threadIdx.x - 128;
  const int wg = ct / 128;
  const int warp = (ct % 128) / 32;
  const int lane = ct % 32;
  const int g8 = lane >> 2;  // accumulator row within 8
  const int t4 = lane & 3;   // accumulator column pair
  const long long wr0 = r0 + wg * 64;
  const uint32_t qs = sbase + wg * L::kWgQ;
  {
    // Q into shared memory once, in the tiles' swizzle; rows past M and
    // columns past D are 0.
    constexpr int kChunks = kDP / 8;  // 16-byte chunks per row
    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
    for (int i = ct % 128; i < 64 * kChunks; i += 128) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const long long row = wr0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < M && c < D / 8)
        val = *reinterpret_cast<const uint4*>(qb + (row / a.G) * a.qss +
                                              (row % a.G) * a.qsg + c * 8);
      *reinterpret_cast<uint4*>(sm + wg * L::kWgQ + (c / 8) * L::kQBlk +
                                r * 128 + (((c % 8) ^ (r & 7)) << 4)) = val;
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }

  // This thread's two rows (g8, g8 + 8 of its warp's 16): the last key
  // each sees when causal; the warpgroup's first row's, for the tiles that
  // need no causal mask.
  long long row[2];
  int last[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = wr0 + warp * 16 + g8 + 8 * i;
    last[i] = static_cast<int>(a.q_offset + row[i] / a.G);
  }
  const int first_last = static_cast<int>(a.q_offset + wr0 / a.G);
  const int Sk = static_cast<int>(a.Sk);
  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)

  float o[kDP / 2];  // o[4 j + 2 i + c]: row i, column 8 j + 2 t4 + c
#pragma unroll
  for (int e = 0; e < kDP / 2; ++e) o[e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // in units of log2
  float l_run[2] = {0.0f, 0.0f};  // this thread's share; summed at the end

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % L::kStages;
    mbar_wait(full0 + 8 * st, (j / L::kStages) & 1);
    const uint32_t ks = sbase + L::kRing + st * 2 * L::kTile;
    const uint32_t vs = ks + L::kTile;
    const int key0 = j * kKeys;
    if (key0 + kKeys > n_valid && n_valid < Sk) {
      // The tile holding n_valid: TMA zero-fills only past Sk, and V rows
      // in [n_valid, Sk) may hold anything (a cache past kv_length). The
      // consumer warpgroups zero them together before any one's P V.
      unsigned char* vg = sm + L::kRing + st * 2 * L::kTile + L::kTile;
      for (int i = ct; i < kKeys * kDB * 8; i += 128 * L::kWGs) {
        const int r = i / (kDB * 8);
        const int c = i % (kDB * 8);
        if (key0 + r >= n_valid)
          *reinterpret_cast<uint4*>(vg + (c / 8) * L::kBlk + r * 128 +
                                    (c % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();
      named_barrier(1 + L::kWGs, 128 * L::kWGs);
    }

    // S = Q K^T (64 x kKeys, fp32): s[4 n + 2 i + c] is row i, key 8 n +
    // 2 t4 + c of the tile.
    float s[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDP / 16; ++kk) {
      const uint64_t dq = sw128_desc(qs + (kk / 4) * L::kQBlk + (kk % 4) * 32,
                                     16);
      const uint64_t dk = sw128_desc(ks + (kk / 4) * L::kBlk + (kk % 4) * 32,
                                     16);
      wgmma_ss_m64n128(s, dq, dk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);

    // Mask only the tiles that cross n_valid or the causal diagonal.
    if (key0 + kKeys > n_valid ||
        (a.causal && key0 + kKeys - 1 > first_last)) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + n * 8 + t4 * 2 + (c & 1);
          if (key >= n_valid || (a.causal && key > last[c >> 1]))
            s[4 * n + c] = -INFINITY;
        }
    }

    // Online softmax in units of log2: p = 2^(s sl2 - m).
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[4 * n + c]);
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i] * sl2);
      mu[i] = m_new == -INFINITY ? 0.0f : m_new;  // a row with no key yet
      alpha[i] = ex2(m_run[i] - mu[i]);
      m_run[i] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[4 * n + c] = ex2(fmaf(s[4 * n + c], sl2, -mu[c >> 1]));
        rs[c >> 1] += s[4 * n + c];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
    for (int e = 0; e < kDP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V: P rounded to bf16 in registers (the accumulator layout of
    // S is the A-fragment layout of P), 16 keys per wgmma.
    uint32_t p[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    wgmma_fence();
    pin(o);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs_m64n64(o, p[kk], sw128_desc(vs + kk * 16 * 128, L::kBlk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // the stage is free
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[i] >= M) continue;
    const float den = fmaxf(l, 1e-20f);
    __nv_bfloat16* dst =
        out +
        (((b * a.Sq + row[i] / a.G) * a.H + h) * a.G + row[i] % a.G) * D +
        t4 * 2;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(dst + jd * 8) = __floats2bfloat162_rn(
          o[4 * jd + 2 * i] / den, o[4 * jd + 2 * i + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// bf16 decode: split over the keys, mma.sync, merged in the same launch
// ---------------------------------------------------------------------------

// The head dim padded to 32 (two 16-wide mma.sync slices, four 8-wide
// output tiles: the fragment loops step by two), a warp's sub-tile in
// keys (16 at D = 256: 4 warps x 2 stages x (K + V) of 32 keys would take
// 264 KB), and the dynamic shared memory.
template <int D>
struct SplitSmem {
  static constexpr int kDP = D < 32 ? 32 : D;
  static constexpr int kSub = D == 256 ? 16 : 32;
  static constexpr int kLd = kDP + 8;  // padded row: conflict-free ldmatrix
  static constexpr int kTile = kSub * kLd;  // elements of a K or V sub-tile
  static constexpr int kWarp = kSplitStages * 2 * kTile;  // a warp's ring
  static constexpr int kRing = kSplitWarps * kWarp * 2;   // bytes
  // after the loop: every warp's (m, l) and acc for the 16 rows, fp32
  static constexpr int kMerge = kSplitWarps * kSplitRows * (kDP + 2) * 4;
  static constexpr int kBytes = kRing > kMerge ? kRing : kMerge;
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

// Keys [key0, key0 + kSub) of K and V into a warp's stage; keys at or
// past `end`, and columns past D, are zero-filled and never read from
// device memory.
template <int D>
__device__ __forceinline__ void load_sub(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                         const __nv_bfloat16* kb,
                                         const __nv_bfloat16* vb,
                                         const FlashArgs& a, int key0, int end,
                                         int lane) {
  constexpr int kLd = SplitSmem<D>::kLd;
  constexpr int kChunks = SplitSmem<D>::kDP / 8;
  for (int i = lane; i < SplitSmem<D>::kSub * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = key0 + r < end && c < D;
    const long long key = ok ? key0 + r : 0;
    cp_async16(ks + r * kLd + c, kb + key * a.kss + (ok ? c : 0), ok);
    cp_async16(vs + r * kLd + c, vb + key * a.vss + (ok ? c : 0), ok);
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// The end of a split decode block (either lane), after its warps' (m, l)
// (wm, wl: kSplitWarps x kSplitRows, m in units of log2, kNegInf where a
// row saw no key) and accumulators (wo: kSplitWarps x kSplitRows rows of
// kDP) are in shared memory: the block's partial, warp by warp in order,
// goes to the caller's scratch, or with one split is the output; the block
// that arrives last at its (b, h)'s counter merges every split in split
// order (the log-sum-exp merge of src/repro/nn/decode_attn.py:128-132: the
// same bits every call), writes the output (and the partial entry's
// statistics) and resets the counter to 0. `merging` is a shared flag.
template <int D, int kDP, typename T>
__device__ __forceinline__ void split_finish(const FlashArgs& a,
                                             const SplitArgs& sp, long long b,
                                             long long h, int split, int M,
                                             const float* wm, const float* wl,
                                             const float* wo, T* out,
                                             int& merging) {
  const long long bh = b * a.H + h;
  const int rec = D + 2;  // a partial row: acc[D], m, l
  float* part = sp.n_split == 1 ? nullptr
                                : sp.scratch + (bh * sp.n_split + split) *
                                                   static_cast<long long>(M) *
                                                   rec;
  for (int e = threadIdx.x; e < M * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    float mb = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mb = fmaxf(mb, wm[w * kSplitRows + r]);
    float lb = 0.0f, ob = 0.0f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = ex2(wm[w * kSplitRows + r] - mb);
      lb += wl[w * kSplitRows + r] * wt;
      ob += wo[(w * kSplitRows + r) * kDP + d] * wt;
    }
    if (sp.n_split == 1) {
      store_out(out + (((b * a.Sq + r / a.G) * a.H + h) * a.G + r % a.G) * D +
                    d,
                ob / fmaxf(lb, 1e-20f));
      if (d == 0 && a.m_out != nullptr) write_stats(a, b, h, r, mb, lb);
    } else {
      part[r * rec + d] = ob;
      if (d == 0) {
        part[r * rec + D] = mb;
        part[r * rec + D + 1] = lb;
      }
    }
  }
  if (sp.n_split == 1) return;

  // The last block of (b, h) to arrive merges every split, in split order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    merging = atomicAdd(sp.counters + bh, 1) == sp.n_split - 1;
  __syncthreads();
  if (!merging) return;
  __threadfence();
  const float* parts =
      sp.scratch + bh * sp.n_split * static_cast<long long>(M) * rec;
  for (int e = threadIdx.x; e < M * D; e += kThreads) {
    const int r = e / D;
    const int d = e % D;
    float mg = kNegInf;
    for (int q = 0; q < sp.n_split; ++q)
      mg = fmaxf(mg, __ldcg(parts + (static_cast<long long>(q) * M + r) *
                                        rec + D));
    float lg = 0.0f, og = 0.0f;
    for (int q = 0; q < sp.n_split; ++q) {
      const float* pr = parts + (static_cast<long long>(q) * M + r) * rec;
      const float wt = ex2(__ldcg(pr + D) - mg);
      lg += __ldcg(pr + D + 1) * wt;
      og += __ldcg(pr + d) * wt;
    }
    store_out(out + (((b * a.Sq + r / a.G) * a.H + h) * a.G + r % a.G) * D + d,
              og / fmaxf(lg, 1e-20f));
    if (d == 0 && a.m_out != nullptr) write_stats(a, b, h, r, mg, lg);
  }
  if (threadIdx.x == 0) sp.counters[bh] = 0;  // ready for the next launch
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const FlashArgs a, const SplitArgs sp) {
  constexpr int kDP = SplitSmem<D>::kDP;
  constexpr int kSub = SplitSmem<D>::kSub;
  constexpr int kLd = SplitSmem<D>::kLd;
  constexpr int kTile = SplitSmem<D>::kTile;
  constexpr int kKc = kDP / 16;  // 16-wide slices of the (padded) head dim
  constexpr int kDn = kDP / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int merging;

  const int split = blockIdx.x;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int M = static_cast<int>(a.Sq * a.G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g8 = lane >> 2;  // fragment row within 8
  const int t4 = lane & 3;   // fragment column pair

  // This thread's two rows (g8, g8 + 8): every warp holds all 16.
  int last[2];
  bool row_ok[2];
  long long pos[2], grp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g8 + 8 * i;
    row_ok[i] = row < M;
    pos[i] = row_ok[i] ? row / a.G : 0;
    grp[i] = row_ok[i] ? row % a.G : 0;
    last[i] = static_cast<int>(a.q_offset + pos[i]);
  }
  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qsb + h * a.qsh;
  uint32_t qf[kKc][4];
#pragma unroll
  for (int kc = 0; kc < kKc; ++kc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = j & 1;  // a0, a2: row A; a1, a3: row B
      const int col = kc * 16 + (j >> 1) * 8 + t4 * 2;
      qf[kc][j] = row_ok[i] && col < D
                      ? *reinterpret_cast<const uint32_t*>(
                            qb + pos[i] * a.qss + grp[i] * a.qsg + col)
                      : 0u;
    }
  }

  // The split's keys [lo, hi), cut at the loop's end; this warp's
  // sub-tiles are warp, warp + kSplitWarps, ...
  const long long n_valid = valid_keys(a, b);
  const int n_keys = static_cast<int>(loop_keys(a, n_valid, 0, kSplitRows));
  const int lo = split * sp.split_tiles * kSplitTile;
  const int hi = min(lo + sp.split_tiles * kSplitTile, n_keys);
  const int n_sub = hi > lo ? (hi - lo + kSub - 1) / kSub : 0;
  const int mine =
      n_sub > warp ? (n_sub - warp + kSplitWarps - 1) / kSplitWarps : 0;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ksb + h * a.ksh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vsb + h * a.vsh;
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * SplitSmem<D>::kWarp;
  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)

  float m_run[2] = {-INFINITY, -INFINITY};  // in units of log2
  float l_run[2] = {0.0f, 0.0f};  // this thread's share; summed below
  float o[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[dn][c] = 0.0f;

  if (mine > 0)
    load_sub<D>(ring, ring + kTile, kb, vb, a, lo + warp * kSub, hi, lane);
  cp_async_commit();
  const int mi = lane >> 3;  // ldmatrix: the matrix this lane addresses
  const int rr = lane & 7;   // ... and its row
  for (int it = 0; it < mine; ++it) {
    const int st = it & 1;
    if (it + 1 < mine) {
      __nv_bfloat16* nx = ring + (st ^ 1) * 2 * kTile;
      load_sub<D>(nx, nx + kTile, kb, vb, a,
                  lo + (warp + (it + 1) * kSplitWarps) * kSub, hi, lane);
    }
    cp_async_commit();
    cp_async_wait_one();  // sub-tile it has landed
    __syncwarp();
    const __nv_bfloat16* ks = ring + st * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    const int key0 = lo + (warp + it * kSplitWarps) * kSub;

    // S = Q K^T: 4 column tiles of 8 keys.
    float s[kSub / 8][4];
#pragma unroll
    for (int nt = 0; nt < kSub / 8; ++nt) {
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
    // Mask only the sub-tiles that cross hi or the first row's diagonal.
    if (key0 + kSub > hi ||
        (a.causal && key0 + kSub - 1 > a.q_offset)) {
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + nt * 8 + t4 * 2 + (c & 1);
          if (key >= hi || (a.causal && key > last[c >> 1]))
            s[nt][c] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[nt][c]);
    float mu[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i] * sl2);
      mu[i] = m_new == -INFINITY ? 0.0f : m_new;
      alpha[i] = ex2(m_run[i] - mu[i]);
      m_run[i] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = ex2(fmaf(s[nt][c], sl2, -mu[c >> 1]));
        rs[c >> 1] += s[nt][c];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[dn][c] *= alpha[c >> 1];

    // acc += P V: P (bf16) from registers, V^T fragments by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kDn; dn += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (mi & 1) * 8 + rr) * kLd +
                                  dn * 8 + (mi >> 1) * 8);
        mma_bf16(o[dn], pa, vf[0], vf[1]);
        mma_bf16(o[dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncwarp();  // the stage is read before the next load refills it
  }
  cp_async_wait_all();

  // The warps' partials into shared memory (over the rings: every warp is
  // done with its own), m at -1e30 where a row saw no key.
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem_raw);
  float* wl = wm + kSplitWarps * kSplitRows;
  float* wo = wl + kSplitWarps * kSplitRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int wr = warp * kSplitRows + g8 + 8 * i;
    if (t4 == 0) {
      wm[wr] = m_run[i] == -INFINITY ? kNegInf : m_run[i];
      wl[wr] = l;
    }
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn) {
      wo[wr * kDP + dn * 8 + 2 * t4] = o[dn][2 * i];
      wo[wr * kDP + dn * 8 + 2 * t4 + 1] = o[dn][2 * i + 1];
    }
  }
  __syncthreads();
  split_finish<D, kDP>(a, sp, b, h, split, M, wm, wl, wo,
                       static_cast<__nv_bfloat16*>(a.out), merging);
}

// ---------------------------------------------------------------------------
// fp32 lane: IEEE FMAs on the CUDA cores, register-tiled
// ---------------------------------------------------------------------------

// The fp32 prefill's block at head dim D (file header). Dynamic shared
// memory, in floats: Q (kRows rows of kQLd), then the ring of kStages (K
// tile: kKeys rows of kQLd; V tile: kKeys rows of kDP), then P (kRows rows
// of kPLd, each warp writing and reading only its own 16).
template <int D>
struct F32Tile {
  static constexpr int kDP = D < 32 ? 32 : D;  // the head dim, padded
  static constexpr int kWarps = 8;
  static constexpr int kKeys = D <= 64 ? 64 : (D == 128 ? 32 : 16);
  static constexpr int kStages = 2;
  static constexpr int kTR = 4;  // rows a lane: rg + 4 i
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWarpRows = 4 * kTR;
  static constexpr int kRows = kWarpRows * kWarps;
  static constexpr int kTK = kKeys / 8;   // keys a lane: kg + 8 j
  static constexpr int kTD = kDP / 32;    // float4 columns a lane: 4 kg + 32 c
  static constexpr int kQLd = kDP + 4;    // a Q or K row, padded
  static constexpr int kPLd = kKeys + 8;  // a P row, padded
  static constexpr int kKTile = kKeys * kQLd;
  static constexpr int kStage = kKTile + kKeys * kDP;
  static constexpr int kQ = kRows * kQLd;
  static constexpr int kP = kQ + kStages * kStage;  // P's offset
  static constexpr int kBytes = 4 * (kP + kRows * kPLd);
  static_assert(kBytes <= 232448, "more shared memory than a block has");
  static_assert(kDP % 32 == 0 && kKeys % 8 == 0, "a warp's 8 lane columns");
};

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::kThreads, 1)
flash_prefill_f32_kernel(const FlashArgs a, const int B) {
  using L = F32Tile<D>;
  constexpr int kDP = L::kDP;
  constexpr int kKeys = L::kKeys;
  constexpr int kTR = L::kTR;
  constexpr int kTK = L::kTK;
  constexpr int kTD = L::kTD;
  constexpr int kQLd = L::kQLd;
  constexpr int kPLd = L::kPLd;
  extern __shared__ __align__(16) float fsm[];

  const long long M = a.Sq * a.G;
  const long long BH = static_cast<long long>(B) * a.H;
  const long long n_rt = (M + L::kRows - 1) / L::kRows;
  long long r0, b, h;
  prefill_block(n_rt, BH, a.H, L::kRows, r0, b, h);
  const long long n_valid = valid_keys(a, b);
  const long long n_keys = loop_keys(a, n_valid, r0, L::kRows);
  const int n_tiles = static_cast<int>((n_keys + kKeys - 1) / kKeys);
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  const int tid = threadIdx.x;

  // Q once (rows past M and columns past D zero-filled), in the first
  // cp.async group with K/V tile 0.
  for (int i = tid; i < L::kRows * (kDP / 4); i += L::kThreads) {
    const int r = i / (kDP / 4);
    const int c = (i % (kDP / 4)) * 4;
    const long long row = r0 + r;
    const bool ok = row < M && c < D;
    cp_async16(fsm + r * kQLd + c,
               ok ? qb + (row / a.G) * a.qss + (row % a.G) * a.qsg + c : qb,
               ok);
  }
  // K/V tile t into stage t % kStages: keys past n_valid (a cache past
  // kv_length may hold NaN) and columns past D zero-filled.
  auto load = [&](int t) {
    float* ks = fsm + L::kQ + (t % L::kStages) * L::kStage;
    float* vs = ks + L::kKTile;
    const long long key0 = static_cast<long long>(t) * kKeys;
    for (int i = tid; i < kKeys * (kDP / 4); i += L::kThreads) {
      const int r = i / (kDP / 4);
      const int c = (i % (kDP / 4)) * 4;
      const long long key = key0 + r;
      const bool ok = key < n_valid && c < D;
      cp_async16(ks + r * kQLd + c, ok ? kb + key * a.kss + c : kb, ok);
      cp_async16(vs + r * kDP + c, ok ? vb + key * a.vss + c : vb, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < L::kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }

  // This lane's rows wr0 + rg + 4 i and keys kg + 8 j of a tile; the
  // warp's rows' causal reach (w_first: its first row's last key, w_last:
  // its last row's).
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = lane / 8;
  const int kg = lane % 8;
  const long long wr0 = r0 + L::kWarpRows * warp;
  const long long w_end = wr0 + L::kWarpRows < M ? wr0 + L::kWarpRows : M;
  const bool w_live = wr0 < M;
  const long long w_first = a.q_offset + wr0 / a.G;
  const long long w_last = a.q_offset + (w_end - 1) / a.G;
  long long last[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) last[i] = a.q_offset + (wr0 + rg + 4 * i) / a.G;
  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)
  const float* qw = fsm + (L::kWarpRows * warp + rg) * kQLd;
  float* pw = fsm + L::kP + (L::kWarpRows * warp + rg) * kPLd;

  float o[kTR][kTD][4];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int c = 0; c < kTD; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.0f;
  float m_run[kTR], l_run[kTR];  // m in units of log2; l this lane's share
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // Tile t has landed for every thread, and every thread is done with
    // tile t - 1, whose stage the load kStages - 1 tiles on takes.
    cp_async_wait<L::kStages - 2>();
    __syncthreads();
    if (t + L::kStages - 1 < n_tiles) load(t + L::kStages - 1);
    cp_async_commit();
    const long long key0 = static_cast<long long>(t) * kKeys;
    if (!w_live || (a.causal && key0 > w_last)) continue;
    const float* ks = fsm + L::kQ + (t % L::kStages) * L::kStage;
    const float* vs = ks + L::kKTile;

    // S = Q K^T: per 4 columns 4 Q float4s (rows) and kTK K float4s.
    float s[kTR][kTK];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTK; ++j) s[i][j] = 0.0f;
    const float* kt = ks + kg * kQLd;
#pragma unroll
    for (int c = 0; c < kDP; c += 4) {
      float4 qa[kTR];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qw + 4 * i * kQLd + c);
#pragma unroll
      for (int j = 0; j < kTK; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kt + 8 * j * kQLd + c);
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          s[i][j] = fmaf(qa[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv.w, s[i][j]);
        }
      }
    }
    // Mask only the tiles that cross n_valid or the warp's diagonal.
    if (key0 + kKeys > n_valid ||
        (a.causal && key0 + kKeys - 1 > w_first)) {
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTK; ++j) {
          const long long key = key0 + kg + 8 * j;
          if (key >= n_valid || (a.causal && key > last[i]))
            s[i][j] = -INFINITY;
        }
    }
    // Online softmax in units of log2: p = 2^(s sl2 - m); P into the warp's
    // rows of shared memory.
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kTK; ++j) mx = fmaxf(mx, s[i][j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx * sl2);
      const float mu = m_new == -INFINITY ? 0.0f : m_new;  // no key yet
      const float alpha = ex2(m_run[i] - mu);
      m_run[i] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kTK; ++j) {
        const float p = ex2(fmaf(s[i][j], sl2, -mu));
        rs += p;
        pw[4 * i * kPLd + kg + 8 * j] = p;
      }
      l_run[i] = l_run[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < kTD; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
    }
    __syncwarp();

    // O += P V: per 4 keys 4 P float4s (rows) and 4 kTD V float4s.
    const float* vt = vs + 4 * kg;
#pragma unroll
    for (int j = 0; j < kKeys; j += 4) {
      float4 pa[kTR];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
        pa[i] = *reinterpret_cast<const float4*>(pw + 4 * i * kPLd + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < kTD; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vt + (j + e) * kDP + 32 * c);
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            const float p = e == 0 ? pa[i].x
                            : e == 1 ? pa[i].y
                            : e == 2 ? pa[i].z
                                     : pa[i].w;
            o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
            o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
            o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
          }
        }
      }
    }
    __syncwarp();  // P is read before the next tile's softmax writes it
  }
  cp_async_wait_all();

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const long long row = wr0 + rg + 4 * i;
    if (row >= M) continue;
    const long long idx =
        ((b * a.Sq + row / a.G) * a.H + h) * a.G + row % a.G;
    if (a.m_out != nullptr && kg == 0) {
      // the partial entry's statistics, m in natural-log units
      a.m_out[idx] =
          m_run[i] == -INFINITY ? kNegInf : m_run[i] * 0.6931471805599453f;
      a.l_out[idx] = l;
    }
    const float den = fmaxf(l, 1e-20f);
    float* dst = out + idx * D + 4 * kg;
#pragma unroll
    for (int c = 0; c < kTD; ++c)
      if (4 * kg + 32 * c < D)
        *reinterpret_cast<float4*>(dst + 32 * c) =
            make_float4(o[i][c][0] / den, o[i][c][1] / den, o[i][c][2] / den,
                        o[i][c][3] / den);
  }
}

// The fp32 split decode's sub-tiles at head dim D (file header). A row of
// kDP floats is kSegs segments of 32; a warp's sub-tile holds 32 segments
// (kSub keys), one a lane in S = Q K^T. Dynamic shared memory, in floats:
// q (kSplitRows rows of kDP), each warp's P (kSplitRows x kSub), then each
// warp's ring of kSplitStages (K sub-tile: 32 segments; V sub-tile: kSub
// rows of kDP); after the loop the warps' (m, l, acc) over all of it. q's
// and K's 16-byte chunk c of segment g lies at chunk c ^ (g % 8), so that
// the 8 segments a quarter-warp reads at once fall in distinct banks.
// kBlocks of them fit an SM's shared memory (228 KB, 1 KB a block
// reserved) and its registers.
template <int D>
struct F32Split {
  static constexpr int kDP = D < 32 ? 32 : D;
  static constexpr int kSegs = kDP / 32;
  static constexpr int kSub = 32 / kSegs;
  static constexpr int kStage = 32 * 32 + kSub * kDP;
  static constexpr int kQ = kSplitRows * kDP;
  static constexpr int kP = kSplitWarps * kSplitRows * kSub;
  static constexpr int kRing = kSplitWarps * kSplitStages * kStage;
  static constexpr int kMerge = kSplitWarps * kSplitRows * (kDP + 2);
  static constexpr int kBytes =
      4 * (kQ + kP + kRing > kMerge ? kQ + kP + kRing : kMerge);
  static constexpr int kBlocks = D == 256 ? 2 : 3;
  // P V: a lane owns kOwn float4 columns (lane % kCw + 32 c) of every row,
  // over the keys of its group (lane / kCw) of kKG
  static constexpr int kCh = kDP / 4;
  static constexpr int kCw = kCh < 32 ? kCh : 32;
  static constexpr int kOwn = kCh / kCw;
  static constexpr int kKG = 32 / kCw;
  static_assert(kSplitTile % kSub == 0 && kSub % kKG == 0, "sub-tiles");
  static_assert(kBlocks * (kBytes + 1024 + 16) <= 233472,
                "kBlocks blocks do not fit an SM's shared memory");
};

// The float offset of 16-byte chunk c (< 8) of 32-float segment g.
__device__ __forceinline__ int seg_chunk(int g, int c) {
  return g * 32 + 4 * (c ^ (g & 7));
}

// R: the rows the block computes, M (= Sq G) rounded up to 1, 4, 8 or
// kSplitRows (rows past M are zeros, never written). At R = kSplitRows an
// SM holds 2 blocks (the accumulators of 16 rows need more than the 168
// registers a thread of 3 blocks may have).
template <int D, int R>
__global__ void __launch_bounds__(kThreads,
                                  R > 8 ? 2 : F32Split<D>::kBlocks)
flash_decode_split_f32_kernel(const FlashArgs a, const SplitArgs sp) {
  using L = F32Split<D>;
  constexpr int kDP = L::kDP;
  constexpr int kSegs = L::kSegs;
  constexpr int kSub = L::kSub;
  constexpr int kCw = L::kCw;
  constexpr int kOwn = L::kOwn;
  extern __shared__ __align__(16) float fsm[];
  __shared__ int merging;

  const int split = blockIdx.x;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int M = static_cast<int>(a.Sq * a.G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // q once; rows past M and columns past D are 0.
  const float* qb = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  for (int i = threadIdx.x; i < R * (kDP / 4); i += kThreads) {
    const int r = i / (kDP / 4);
    const int c = (i % (kDP / 4)) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < M && c < D)
      val = *reinterpret_cast<const float4*>(qb + (r / a.G) * a.qss +
                                             (r % a.G) * a.qsg + c);
    *reinterpret_cast<float4*>(fsm + r * kDP +
                               seg_chunk(c / 32, (c % 32) / 4)) = val;
  }
  __syncthreads();

  // The split's keys [lo, hi), cut at the loop's end; this warp's
  // sub-tiles are warp, warp + kSplitWarps, ...
  const long long n_valid = valid_keys(a, b);
  const long long n_keys = loop_keys(a, n_valid, 0, kSplitRows);
  const long long lo =
      static_cast<long long>(split) * sp.split_tiles * kSplitTile;
  const long long end =
      lo + static_cast<long long>(sp.split_tiles) * kSplitTile;
  const long long hi = end < n_keys ? end : n_keys;
  const int n_sub = hi > lo ? static_cast<int>((hi - lo + kSub - 1) / kSub) : 0;
  const int mine =
      n_sub > warp ? (n_sub - warp + kSplitWarps - 1) / kSplitWarps : 0;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + h * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + h * a.vsh;
  float* pw = fsm + L::kQ + warp * kSplitRows * kSub;
  float* ring = fsm + L::kQ + L::kP + warp * kSplitStages * L::kStage;
  // Keys [key0, key0 + kSub) into a stage; keys at or past hi and columns
  // past D zero-filled.
  auto load = [&](float* ks, long long key0) {
    float* vs = ks + 32 * 32;
    for (int i = lane; i < kSub * (kDP / 4); i += 32) {
      const int r = i / (kDP / 4);
      const int c = (i % (kDP / 4)) * 4;
      const long long key = key0 + r;
      const bool ok = key < hi && c < D;
      cp_async16(ks + seg_chunk(r * kSegs + c / 32, (c % 32) / 4),
                 ok ? kb + key * a.kss + c : kb, ok);
      cp_async16(vs + r * kDP + c, ok ? vb + key * a.vss + c : vb, ok);
    }
  };
  const float sl2 = a.scale * 1.4426950408889634f;  // scale * log2(e)
  const int seg = lane % kSegs;  // S: this lane's segment of key lane / kSegs
  const int col = lane % kCw;    // P V: this lane's first float4 column
  const int grp = lane / kCw;    // ... and key group

  float m_run[R], l_run[R];  // m in units of log2; l the lanes of segment 0
  float o[R][kOwn][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOwn; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][c][e] = 0.0f;
  }

  if (mine > 0) load(ring, lo + static_cast<long long>(warp) * kSub);
  cp_async_commit();
  for (int it = 0; it < mine; ++it) {
    const int st = it & 1;
    if (it + 1 < mine)
      load(ring + (st ^ 1) * L::kStage,
           lo + static_cast<long long>(warp + (it + 1) * kSplitWarps) * kSub);
    cp_async_commit();
    cp_async_wait_one();  // sub-tile it has landed
    __syncwarp();
    const float* ks = ring + st * L::kStage;
    const float* vs = ks + 32 * 32;
    const long long key0 =
        lo + static_cast<long long>(warp + it * kSplitWarps) * kSub;
    const long long key = key0 + lane / kSegs;
    const bool edge = key0 + kSub > hi ||
                      (a.causal && key0 + kSub - 1 > a.q_offset);

    // S = Q K^T: this lane's segment's dot with each row, summed over the
    // key's kSegs lanes.
    float dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dot[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 k4 =
          *reinterpret_cast<const float4*>(ks + seg_chunk(lane, c));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(fsm + r * kDP + seg_chunk(seg, c));
        dot[r] = fmaf(q4.x, k4.x, dot[r]);
        dot[r] = fmaf(q4.y, k4.y, dot[r]);
        dot[r] = fmaf(q4.z, k4.z, dot[r]);
        dot[r] = fmaf(q4.w, k4.w, dot[r]);
      }
    }
    // Each row's online softmax in units of log2, P into the warp's
    // shared memory.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = dot[r];
#pragma unroll
      for (int off = 1; off < kSegs; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (edge && (key >= hi || (a.causal && key > a.q_offset + r / a.G)))
        s = -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = kSegs; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx * sl2);
      const float mu = m_new == -INFINITY ? 0.0f : m_new;
      const float alpha = ex2(m_run[r] - mu);
      m_run[r] = m_new;
      const float p = ex2(fmaf(s, sl2, -mu));
      l_run[r] = l_run[r] * alpha + (seg == 0 ? p : 0.0f);
#pragma unroll
      for (int c = 0; c < kOwn; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][c][e] *= alpha;
      if (seg == 0) pw[r * kSub + lane / kSegs] = p;
    }
    __syncwarp();

    // O += P V over this lane's keys (grp, grp + kKG, ...).
#pragma unroll
    for (int t = 0; t < kSub / L::kKG; ++t) {
      const int j = grp + L::kKG * t;
      float4 vv[kOwn];
#pragma unroll
      for (int c = 0; c < kOwn; ++c)
        vv[c] = *reinterpret_cast<const float4*>(vs + j * kDP +
                                                 4 * (col + 32 * c));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pw[r * kSub + j];
#pragma unroll
        for (int c = 0; c < kOwn; ++c) {
          o[r][c][0] = fmaf(p, vv[c].x, o[r][c][0]);
          o[r][c][1] = fmaf(p, vv[c].y, o[r][c][1]);
          o[r][c][2] = fmaf(p, vv[c].z, o[r][c][2]);
          o[r][c][3] = fmaf(p, vv[c].w, o[r][c][3]);
        }
      }
    }
    __syncwarp();  // the stage and P are read before they are written again
  }
  cp_async_wait_all();

  // The warps' partials into shared memory (over q, P and the rings: every
  // warp is done with them): l summed over the lanes, the accumulator over
  // the key groups, m at kNegInf where a row saw no key.
  __syncthreads();
  float* wm = fsm;
  float* wl = wm + kSplitWarps * kSplitRows;
  float* wo = wl + kSplitWarps * kSplitRows;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float l = l_run[r];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
#pragma unroll
    for (int c = 0; c < kOwn; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int off = kCw; off < 32; off <<= 1)
          o[r][c][e] += __shfl_xor_sync(0xffffffffu, o[r][c][e], off);
    const int wr = warp * kSplitRows + r;
    if (lane == 0) {
      wm[wr] = m_run[r] == -INFINITY ? kNegInf : m_run[r];
      wl[wr] = l;
    }
    if (grp == 0) {
#pragma unroll
      for (int c = 0; c < kOwn; ++c)
        *reinterpret_cast<float4*>(wo + wr * kDP + 4 * (col + 32 * c)) =
            make_float4(o[r][c][0], o[r][c][1], o[r][c][2], o[r][c][3]);
    }
  }
  __syncthreads();
  split_finish<D, kDP>(a, sp, b, h, split, M, wm, wl, wo,
                       static_cast<float*>(a.out), merging);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The TMA map of a k or v (B, Sk, H, D) bf16 tensor with element strides
// (sb, ss, sh, 1), as (D, Sk, H, B), boxes of 64 x `keys` in the 128-byte
// swizzle; rows past Sk, and below D = 64 the box's columns past D, read
// as zeros. Returns a cudaError_t.
int encode_kv(CUtensorMap* map, const void* base, int D, int keys,
              long long B, long long Sk, long long H, long long sb,
              long long ss, long long sh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Sk > 0 ? Sk : 1),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                           static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  for (int i = 0; i < 3; ++i)  // never stepped (extent 1): any legal value
    if (strides[i] == 0)
      strides[i] = i == 0 ? dims[0] * 2 : strides[i - 1] * dims[i];
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(keys), 1, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
         dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The prefill at head dim D: flash_prefill_wg_kernel at D <= 64,
// flash_prefill_kernel at D = 128 and 256.
template <int D>
using PrefillTile = std::conditional_t<(D <= 64), PfWgTile<D>, PfTile<D>>;

template <int D>
int launch_prefill(const FlashArgs& a, long long B, cudaStream_t stream) {
  using L = PrefillTile<D>;
  CUtensorMap k_map, v_map;
  int rc = encode_kv(&k_map, a.k, D, L::kKeys, B, a.Sk, a.H, a.ksb, a.kss,
                     a.ksh);
  if (rc != 0) return rc;
  rc = encode_kv(&v_map, a.v, D, L::kKeys, B, a.Sk, a.H, a.vsb, a.vss,
                 a.vsh);
  if (rc != 0) return rc;
  auto* kernel = [] {
    if constexpr (D <= 64)
      return flash_prefill_wg_kernel<D>;
    else
      return flash_prefill_kernel<D>;
  }();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (a.Sq * a.G + L::kRows - 1) / L::kRows * B * a.H;
  kernel<<<static_cast<unsigned>(blocks), L::kThreads, L::kBytes, stream>>>(
      k_map, v_map, a, static_cast<int>(B));
  return static_cast<int>(cudaGetLastError());
}

// The split decode (bf16: flash_decode_split_kernel; fp32:
// flash_decode_split_f32_kernel at the rows bucket R): blocks (split, h,
// b).
template <int D, bool kBf16, int R = kSplitRows>
int launch_split(const FlashArgs& a, const SplitArgs& sp, long long B,
                 cudaStream_t stream) {
  constexpr int kBytes =
      kBf16 ? SplitSmem<D>::kBytes : F32Split<D>::kBytes;
  auto* kernel = [] {
    if constexpr (kBf16)
      return flash_decode_split_kernel<D>;
    else
      return flash_decode_split_f32_kernel<D, R>;
  }();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(sp.n_split),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  kernel<<<grid, kThreads, kBytes, stream>>>(a, sp);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 split decode at the rows bucket of M = Sq G (1, 4, 8 or
// kSplitRows).
template <int D>
int launch_split_f32(const FlashArgs& a, const SplitArgs& sp, long long B,
                     cudaStream_t stream) {
  const long long M = a.Sq * a.G;
  if (M <= 1) return launch_split<D, false, 1>(a, sp, B, stream);
  if (M <= 4) return launch_split<D, false, 4>(a, sp, B, stream);
  if (M <= 8) return launch_split<D, false, 8>(a, sp, B, stream);
  return launch_split<D, false, kSplitRows>(a, sp, B, stream);
}

template <int D>
int launch_f32(const FlashArgs& a, long long B, cudaStream_t stream) {
  using L = F32Tile<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (a.Sq * a.G + L::kRows - 1) / L::kRows * B * a.H;
  flash_prefill_f32_kernel<D>
      <<<static_cast<unsigned>(blocks), L::kThreads, L::kBytes, stream>>>(
          a, static_cast<int>(B));
  return static_cast<int>(cudaGetLastError());
}

// fn(std::integral_constant<int, D>) for the head dims the kernels are
// built for; another D is refused.
template <typename Fn>
int by_head_dim(int D, Fn fn) {
  switch (D) {
    case 8: return fn(std::integral_constant<int, 8>());
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 128: return fn(std::integral_constant<int, 128>());
    case 256: return fn(std::integral_constant<int, 256>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


}  // namespace

extern "C" {

// Tiles the wrapper validates against: the bf16 prefill's geometry at
// head dim D into out[7] (rows a block, keys a tile, ring stages, consumer
// warpgroups, dynamic shared memory bytes, threads a block, registers a
// thread), returning 0 (or cudaErrorInvalidValue for another D); the fp32
// lane's at D into out[8] (the prefill's rows a block, keys a tile, ring
// stages, threads a block and dynamic shared memory bytes; the split
// decode's keys a warp's sub-tile, dynamic shared memory bytes and blocks
// an SM); the split path's rows and key unit.
int flash_attention_prefill_tile(int D, int* out) {
  return by_head_dim(D, [&](auto d) {
    constexpr int D = decltype(d)::value;
    using L = PrefillTile<D>;
    // ptxas's registers a thread: a sub-partition's 16384 over its share
    // of the block's warps, in units of 8, at most 255
    constexpr int kWarps = (L::kThreads / 32 + 3) / 4;
    constexpr int kRegs = 16384 / (32 * kWarps) / 8 * 8;
    const int v[7] = {L::kRows,  L::kKeys,    L::kStages,
                      L::kWGs,   L::kBytes,   L::kThreads,
                      kRegs > 255 ? 255 : kRegs};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return 0;
  });
}
int flash_attention_f32_tile(int D, int* out) {
  return by_head_dim(D, [&](auto d) {
    constexpr int D = decltype(d)::value;
    using L = F32Tile<D>;
    using S = F32Split<D>;
    const int v[8] = {L::kRows,  L::kKeys, L::kStages, L::kThreads,
                      L::kBytes, S::kSub,  S::kBytes,  S::kBlocks};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return 0;
  });
}
int flash_attention_split_rows() { return kSplitRows; }
int flash_attention_split_tile() { return kSplitTile; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, Sq, H, G, D) with element strides (qsb, qss, qsh, qsg, 1); k, v
// (B, Sk, H, D) with strides (ksb, kss, ksh, 1) and (vsb, vss, vsh, 1);
// out (B, Sq, H, G, D) contiguous in q's dtype; kv_length (B,) int32 or
// null. bf16 != 0 selects bfloat16, else fp32; D is 8, 16, 32, 64, 128 or
// 256. Every base and stride is 16-byte aligned (the wrapper checks).
// n_split > 0 takes the split path (Sq G <= kSplitRows) with n_split
// splits of split_tiles kSplitTile-key tiles, fp32 scratch (B, H, n_split,
// Sq G, D + 2) (null when n_split is 1) and (B, H) int32 counters at 0;
// else the prefill path. m_out and l_out, (B, Sq, H, G) fp32 each, are
// null but on the split path and the fp32 prefill, which then also write
// each row's (merged) max, in natural-log units, and sum there: the
// partials that a sequence-sharded decode merges across ranks. Returns the
// launch's cudaError_t.
int flash_attention_ml(const void* q, const void* k, const void* v,
                       void* out, const void* kv_length, int bf16, int causal,
                       int D, long long B, long long Sq, long long Sk,
                       long long H, long long G, long long q_offset,
                       long long qsb, long long qss, long long qsh,
                       long long qsg, long long ksb, long long kss,
                       long long ksh, long long vsb, long long vss,
                       long long vsh, void* scratch, void* counters,
                       int n_split, int split_tiles, float scale, void* stream,
                       void* m_out, void* l_out) {
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
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    if (Sq * G > kSplitRows || counters == nullptr ||
        (n_split > 1 && scratch == nullptr) || split_tiles < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    SplitArgs sp;
    sp.scratch = static_cast<float*>(scratch);
    sp.counters = static_cast<int*>(counters);
    sp.n_split = n_split;
    sp.split_tiles = split_tiles;
    return by_head_dim(D, [&](auto d) {
      constexpr int DD = decltype(d)::value;
      return bf16 ? launch_split<DD, true>(a, sp, B, s)
                  : launch_split_f32<DD>(a, sp, B, s);
    });
  }
  if (bf16 && m_out != nullptr)  // the prefill path writes no statistics
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return by_head_dim(
        D, [&](auto d) { return launch_prefill<decltype(d)::value>(a, B, s); });
  return by_head_dim(
      D, [&](auto d) { return launch_f32<decltype(d)::value>(a, B, s); });
}

// The attention entry: flash_attention_ml without the statistics.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    const void* kv_length, int bf16, int causal, int D,
                    long long B, long long Sq, long long Sk, long long H,
                    long long G, long long q_offset, long long qsb,
                    long long qss, long long qsh, long long qsg, long long ksb,
                    long long kss, long long ksh, long long vsb, long long vss,
                    long long vsh, void* scratch, void* counters, int n_split,
                    int split_tiles, float scale, void* stream) {
  return flash_attention_ml(q, k, v, out, kv_length, bf16, causal, D, B, Sq,
                            Sk, H, G, q_offset, qsb, qss, qsh, qsg, ksb, kss,
                            ksh, vsb, vss, vsh, scratch, counters, n_split,
                            split_tiles, scale, stream, nullptr, nullptr);
}

}  // extern "C"
