// TrIM causal depthwise conv1d for Hopper (sm_90a): the port of the Pallas
// kernel `_trim_conv1d_kernel` (src/repro/kernels/trim_conv1d.py:24).
//
// What it computes: the Mamba short conv
//   out[b, l, d] = sum_{k < K} x[b, l - K + 1 + k, d] * w[k, d]
// with zeros before position 0, for x (B, L, D) and w (K, D) in fp32 or
// bf16 (w in x's dtype), K from 1 to 8. The sum is taken in fp32, tap by tap
// in order k = 0..K-1 from 0.0f with __fmul_rn / __fadd_rn (no fused
// multiply-add, whatever -fmad says), and rounded once to x's dtype: the
// same bits as the plain PyTorch version (`trim_conv1d_plain`).
//
// What the TPU kernel keeps out of device memory, and how this one does it:
// - The Pallas kernel reads a second, "previous" tile only for its K-1 halo
//   and needs a zero-padded copy of x. Here nothing is staged in shared
//   memory and nothing is padded: a thread owns one 16-byte vector of
//   channels (8 bf16 or 4 fp32) over a run of `span` consecutive positions
//   and reads x with 16-byte loads straight into registers, 4 (bf16) or
//   8 (fp32) rows at a time, all in flight at once, zeros before
//   position 0. Only the first chunk of a run re-reads the K-1 rows
//   before it (served from L2); later chunks slide the K-input window on
//   in registers.
// - The K weights of the thread's channels stay in registers (fp32) for
//   the whole run; each input enters the window once and is used K times
//   from registers (the triangular reuse in 1-D).
// - Each output row is written once, as one 16-byte store. There is no
//   __syncthreads and no shared memory.
// - The grid is fitted to the card from the shape alone: the wrapper
//   (`kernels/trim_conv1d.py:plan`) picks the span so that B x runs x
//   (D / 16 bytes) threads fill about one wave of the resident blocks of
//   132 SMs (blocks_per_sm(K) each), so no shape ends on a short tail
//   wave.
//
// Strides: x's rows (stride_l) and images (stride_b) may be strided, so a
// column slice of a wider tensor (Mamba's xBC inside in_proj's output) is
// read in place; only channels d < D of a row are ever read. The channel
// stride must be 1. Where x's rows are not 16-byte aligned, or a thread's
// vector is cut by D, that thread loads and stores element by element. The
// output is contiguous (B, L, D). Offsets are 64-bit.
//
// What bounds it: 2*K operations per output against 2 elements moved (one
// read, one write), far below the H100's ridge, so it is bound by bytes:
// (B*L*D*2 + K*D) * sizeof(T) over 3.35 TB/s. The halo re-reads add
// (K-1)/span of x's bytes, from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;

// Positions a thread loads at once: 4 rows of 16 bytes in bf16 (fewer
// registers held for the loads), 8 in fp32.
template <typename T>
__host__ __device__ constexpr int rows_of() {
  return sizeof(T) == 2 ? 4 : 8;
}

// Resident blocks an SM the launch bounds ask for: 128 registers a thread
// up to K = 4, 255 above (the window and weights grow with K).
__host__ __device__ constexpr int blocks_per_sm(int K) {
  return K <= 4 ? 2 : 1;
}

struct Conv1dArgs {
  const void* x;
  const void* w;
  void* out;
  long long L, D, stride_b, stride_l;
  long long span;     // positions a thread owns (the last run may be short)
  long long runs;     // ceil(L / span)
  long long dvecs;    // ceil(D / V)
  long long threads;  // B * runs * dvecs
  int vec;   // every row of x starts 16-byte aligned
  int ovec;  // every row of out starts 16-byte aligned
  int wvec;  // every row of w starts 16-byte aligned
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of x's dtype -> V fp32 values (exact).
__device__ __forceinline__ void unpack(const uint4 r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4 r, float (&v)[8]) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(u[q] << 16);
    v[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
  }
}

// V fp32 values -> 16 bytes of the output dtype, each rounded once.
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    u[q] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The first n channels of p into v (fp32), zeros past them: 16 bytes at
// once when vec (then n is V).
template <typename T, int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const T* p, bool vec,
                                         int n) {
  if (vec) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = e < n ? to_f32(p[e]) : 0.0f;
  }
}

// One output row from the window (win[k] is x at l - K + 1 + k): the taps
// summed in order from 0.0f, each product and sum rounded on its own.
template <typename T, int K, int V>
__device__ __forceinline__ void put_row(T* p, const float (&win)[K][V],
                                        const float (&wr)[K][V], bool vec,
                                        int n) {
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      acc[e] = __fadd_rn(acc[e], __fmul_rn(win[k][e], wr[k][e]));
  }
  if (vec) {
    *reinterpret_cast<uint4*>(p) = pack(acc);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < n) p[e] = from_f32<T>(acc[e]);
  }
}

template <int K, int V>
__device__ __forceinline__ void slide(float (&win)[K][V]) {
#pragma unroll
  for (int k = 0; k < K - 1; ++k)
#pragma unroll
    for (int e = 0; e < V; ++e) win[k][e] = win[k + 1][e];
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(K))
trim_conv1d_kernel(const Conv1dArgs a) {
  constexpr int V = 16 / sizeof(T);  // channels a thread owns
  constexpr int kRows = rows_of<T>();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (t >= a.threads) return;
  // neighbouring threads take neighbouring channel vectors of one run
  const long long dv = t % a.dvecs;
  const long long rest = t / a.dvecs;
  const long long run = rest % a.runs;
  const long long b = rest / a.runs;
  const long long d0 = dv * V;
  const int n = static_cast<int>(a.D - d0 < V ? a.D - d0 : V);
  const bool xv = a.vec && n == V;
  const bool ov = a.ovec && n == V;
  const long long l0 = run * a.span;
  const long long l1 = l0 + a.span < a.L ? l0 + a.span : a.L;
  const T* __restrict__ xp = static_cast<const T*>(a.x) + b * a.stride_b + d0;
  T* __restrict__ op = static_cast<T*>(a.out) + b * a.L * a.D + d0;

  float wr[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
    load_vec<T, V>(wr[k], static_cast<const T*>(a.w) + k * a.D + d0,
                   a.wvec && n == V, n);

  // the window before l0: positions l0-K+1 .. l0-1, zeros before 0
  float win[K][V];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const long long l = l0 - (K - 1) + k;
    if (l >= 0) {
      load_vec<T, V>(win[k], xp + l * a.stride_l, xv, n);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) win[k][e] = 0.0f;
    }
  }

  long long l = l0;
  if (xv) {
    // whole chunks: kRows 16-byte loads in flight, then kRows outputs
    for (; l + kRows <= l1; l += kRows) {
      uint4 raw[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        raw[r] = __ldg(reinterpret_cast<const uint4*>(xp +
                                                      (l + r) * a.stride_l));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        unpack(raw[r], win[K - 1]);
        put_row<T, K, V>(op + (l + r) * a.D, win, wr, ov, n);
        slide<K, V>(win);
      }
    }
  }
  // the rest of the run (or all of it where x's rows are not aligned or D
  // cuts the vector) a row at a time
  for (; l < l1; ++l) {
    load_vec<T, V>(win[K - 1], xp + l * a.stride_l, xv, n);
    put_row<T, K, V>(op + l * a.D, win, wr, ov, n);
    slide<K, V>(win);
  }
}

template <typename T>
int launch(const Conv1dArgs& a, int K, cudaStream_t stream) {
  const long long blocks = (a.threads + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (K) {
    case 1: trim_conv1d_kernel<T, 1><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: trim_conv1d_kernel<T, 2><<<grid, kThreads, 0, stream>>>(a); break;
    case 3: trim_conv1d_kernel<T, 3><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: trim_conv1d_kernel<T, 4><<<grid, kThreads, 0, stream>>>(a); break;
    case 5: trim_conv1d_kernel<T, 5><<<grid, kThreads, 0, stream>>>(a); break;
    case 6: trim_conv1d_kernel<T, 6><<<grid, kThreads, 0, stream>>>(a); break;
    case 7: trim_conv1d_kernel<T, 7><<<grid, kThreads, 0, stream>>>(a); break;
    case 8: trim_conv1d_kernel<T, 8><<<grid, kThreads, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Limits and geometry the wrapper plans and validates against.
int trim_conv1d_max_k() { return kMaxK; }
int trim_conv1d_threads() { return kThreads; }
int trim_conv1d_rows(int bf16) {
  return bf16 ? rows_of<__nv_bfloat16>() : rows_of<float>();
}
int trim_conv1d_blocks_per_sm(int K) { return blocks_per_sm(K); }

const char* trim_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, L, D) with element strides (stride_b, stride_l, 1), w (K, D)
// contiguous in x's dtype, out (B, L, D) contiguous; bf16 != 0 selects
// bfloat16, else fp32; `span` positions a thread (the wrapper's plan).
// Returns the launch's cudaError_t.
int trim_conv1d(const void* x, const void* w, void* out, int bf16,
                long long B, long long L, long long D, int K,
                long long stride_b, long long stride_l, long long span,
                void* stream) {
  if (B < 1 || L < 1 || D < 1 || span < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long elem = bf16 ? 2 : 4;
  const long long V = 16 / elem;
  Conv1dArgs a;
  a.x = x;
  a.w = w;
  a.out = out;
  a.L = L;
  a.D = D;
  a.stride_b = stride_b;
  a.stride_l = stride_l;
  a.span = span;
  a.runs = (L + span - 1) / span;
  a.dvecs = (D + V - 1) / V;
  a.threads = B * a.runs * a.dvecs;
  a.vec = aligned16(x) && (stride_b * elem) % 16 == 0 &&
          (stride_l * elem) % 16 == 0;
  a.ovec = aligned16(out) && (D * elem) % 16 == 0;
  a.wvec = aligned16(w) && (D * elem) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(a, K, s);
  return launch<float>(a, K, s);
}

}  // extern "C"
