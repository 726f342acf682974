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
//   and needs a zero-padded copy of x. Here each block loads its own window
//   of TL + K - 1 positions x Db channels into shared memory once, zero-filled
//   before position 0 and past L (no padded copy), with 16-byte loads along
//   D (4 fp32 or 8 bf16 channels) when every row is 16-byte aligned.
// - The K weights of a channel stay in registers for the whole window.
// - Each thread sweeps kRowsPerThread consecutive positions of one channel
//   with a register shift window of K inputs: every input is read from
//   shared memory once per thread, K times from registers (the triangular
//   reuse in 1-D). Each output is written once.
//
// Strides: x's rows (stride_l) and images (stride_b) may be strided, so a
// column slice of a wider tensor (Mamba's xBC inside in_proj's output) is
// read in place; only channels d < D of a row are ever read. The channel
// stride must be 1. The output is contiguous (B, L, D). Offsets are 64-bit.
//
// What bounds it: 2*K operations per output against 2 elements moved (one
// read, one write), far below the H100's ridge, so it is bound by bytes:
// (B*L*D*2 + K*D) * sizeof(T) over 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 64;                          // Db
constexpr int kGroups = kThreads / kChannels;          // position groups
constexpr int kRowsPerThread = 32;
constexpr int kTileL = kGroups * kRowsPerThread;       // TL = 128
constexpr int kMaxK = 8;

struct Conv1dArgs {
  const void* x;
  const void* w;
  void* out;
  long long L, D, stride_b, stride_l;
  int vec;  // 1: every row start is 16-byte aligned (16-byte loads)
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
trim_conv1d_kernel(const Conv1dArgs a) {
  constexpr int kRows = kTileL + K - 1;
  constexpr int V = 16 / sizeof(T);             // channels per 16-byte load
  constexpr int kChunks = kChannels / V;
  __shared__ __align__(16) float win[kRows * kChannels];

  const long long b = blockIdx.z;
  const long long l0 = static_cast<long long>(blockIdx.x) * kTileL;
  const long long d0 = static_cast<long long>(blockIdx.y) * kChannels;
  const T* __restrict__ xb = static_cast<const T*>(a.x) + b * a.stride_b;

  // 1. The window: positions l0-(K-1) .. l0+TL-1, channels d0 .. d0+Db-1,
  //    in fp32, zero outside [0, L) x [0, D).
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int j = (i % kChunks) * V;
    const long long l = l0 - (K - 1) + r;
    const long long d = d0 + j;
    float v[V];
    if (l < 0 || l >= a.L) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.0f;
    } else if (a.vec && d + V <= a.D) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(xb + l * a.stride_l + d);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = to_f32(t[e]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[e] = d + e < a.D ? to_f32(xb[l * a.stride_l + d + e]) : 0.0f;
    }
    float4* dst = reinterpret_cast<float4*>(&win[r * kChannels + j]);
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }

  // 2. This thread's channel and its K weights, in registers.
  const int c = threadIdx.x % kChannels;
  const int r0 = (threadIdx.x / kChannels) * kRowsPerThread;
  const long long d = d0 + c;
  const T* __restrict__ w = static_cast<const T*>(a.w);
  float wr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wr[k] = d < a.D ? to_f32(w[k * a.D + d]) : 0.0f;
  __syncthreads();
  if (d >= a.D) return;

  // 3. Sweep kRowsPerThread positions with a K-input shift window: the
  //    output at local row r0+i reads window rows r0+i .. r0+i+K-1.
  float xr[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) xr[k] = win[(r0 + k) * kChannels + c];
  T* __restrict__ out = static_cast<T*>(a.out) + b * a.L * a.D + d;
#pragma unroll 4
  for (int i = 0; i < kRowsPerThread; ++i) {
    const long long l = l0 + r0 + i;
    if (l >= a.L) break;
    xr[K - 1] = win[(r0 + i + K - 1) * kChannels + c];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(xr[k], wr[k]));
    out[l * a.D] = from_f32<T>(acc);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) xr[k] = xr[k + 1];
  }
}

template <typename T>
int launch(const Conv1dArgs& a, long long B, int K, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.L + kTileL - 1) / kTileL),
                  static_cast<unsigned>((a.D + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
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

}  // namespace

extern "C" {

// Limits the wrapper validates against.
int trim_conv1d_max_k() { return kMaxK; }
int trim_conv1d_tile_l() { return kTileL; }
int trim_conv1d_block_d() { return kChannels; }

const char* trim_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, L, D) with element strides (stride_b, stride_l, 1), w (K, D)
// contiguous in x's dtype, out (B, L, D) contiguous; bf16 != 0 selects
// bfloat16, else fp32. Returns the launch's cudaError_t.
int trim_conv1d(const void* x, const void* w, void* out, int bf16,
                long long B, long long L, long long D, int K,
                long long stride_b, long long stride_l, void* stream) {
  const size_t elem = bf16 ? 2 : 4;
  Conv1dArgs a;
  a.x = x;
  a.w = w;
  a.out = out;
  a.L = L;
  a.D = D;
  a.stride_b = stride_b;
  a.stride_l = stride_l;
  a.vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          (stride_b * elem) % 16 == 0 && (stride_l * elem) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(a, B, K, s);
  return launch<float>(a, B, K, s);
}

}  // extern "C"
