// TrIM-SSD for Hopper (sm_90a): the port of the Pallas kernel `_ssd_kernel`
// (src/repro/kernels/trim_ssd.py:39), the Mamba2 chunked SSD scan, forward
// only.
//
// What it computes: for x (B, L, H, P), dt (B, L, H), A (H,), Bm and Cm
// (B, L, H, S) and D (H,), with the state h (P, S) of each (b, h) starting
// at 0, the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = C_t h_t + D x_t
// evaluated in chunks of T positions:
//   cum = cumsum(dt A) within the chunk,
//   y = (C B^T o tril(exp(cum_i - cum_j)) o dt_j) x + exp(cum) (C h^T) + D x,
//   h' = exp(cum_last) h + (x o exp(cum_last - cum) dt)^T B.
// Only y is returned (in x's dtype), as the Pallas kernel does. x, Bm, Cm
// are fp32 or bf16; dt, A, D fp32; every product and sum is fp32 on the
// CUDA cores (no TF32).
//
// Chunking is math-neutral: the kernel's chunk is its own T = 64, whatever
// chunk the caller names (the plain version's); the two differ by rounding.
//
// What the TPU kernel keeps out of device memory, and how this one does it:
// - The Pallas kernel carries h in VMEM scratch across its sequential chunk
//   grid axis. Here one block owns one (b, h) and loops over the chunks
//   itself; h (P x S fp32, 32 KB at 64 x 128) stays in shared memory, stored
//   transposed (S rows of P) so that both of its products read it without
//   bank conflicts.
// - The (T, T) block of decays and scores exists only in shared memory: at
//   T = 64 it is 17 KB, where the caller's chunk of 256 would need 256 KB,
//   more than a block may hold. exp() is taken only on and below the
//   diagonal (above it cum_i - cum_j > 0 can overflow, and inf * 0 would be
//   NaN): the block holds exact zeros there.
// - The Pallas driver zero-pads L to whole chunks and takes B/C repeated per
//   head (copies). Here rows past L are zero-filled in shared memory (dt = 0
//   leaves the state unchanged), and x, dt, Bm, Cm are read in place through
//   their strides: a stride-0 view over H (B/C shared by all heads, one
//   group) is read without a copy.
//
// What bounds it: per chunk of T rows, T^2 S / 2 + T^2 P / 2 + 2 T P S
// multiply-adds against T (P + 2 S + 1) elements read and T P written: far
// above the ridge, so the CUDA cores' fp32 rate. The grid is B x H blocks
// (96 at mamba2-130m's 4 x 24) for 132 SMs, chunks in sequence within each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // the kernel's chunk
constexpr int kP = 64;          // largest head dim
constexpr int kS = 128;         // largest state dim
constexpr int kBLd = kS + 4;    // padded row of B and C in shared memory
constexpr int kGLd = kT + 4;    // padded row of the (T, T) block

// shared memory, in floats
constexpr int kXs = 0;                      // x       [kT][kP]
constexpr int kBs = kXs + kT * kP;          // B       [kT][kBLd]
constexpr int kCs = kBs + kT * kBLd;        // C       [kT][kBLd]
constexpr int kGs = kCs + kT * kBLd;        // scores  [kT][kGLd]
constexpr int kHt = kGs + kT * kGLd;        // h^T     [kS][kP]
constexpr int kDt = kHt + kS * kP;          // dt      [kT]
constexpr int kCum = kDt + kT;              // cum     [kT]
constexpr int kEcum = kCum + kT;            // exp(cum)            [kT]
constexpr int kW = kEcum + kT;              // exp(cum_last - cum) dt  [kT]
constexpr int kSmemFloats = kW + kT;
constexpr int kSmemBytes = kSmemFloats * 4;

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  void* y;
  long long L, H;
  int P, S;
  long long sxb, sxl, sxh;
  long long sdb, sdl, sdh;
  long long sbb, sbl, sbh;
  long long scb, scl, sch;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
trim_ssd_kernel(const SsdArgs a) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm + kXs;
  float* bs = sm + kBs;
  float* cs = sm + kCs;
  float* gs = sm + kGs;
  float* ht = sm + kHt;
  float* dts = sm + kDt;
  float* cum = sm + kCum;
  float* ecum = sm + kEcum;
  float* wts = sm + kW;

  const long long h = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ti = tid / 16;  // row group of this thread's tiles
  const int tj = tid % 16;  // column group
  const float A = a.A[h];
  const float Dh = a.D[h];
  const T* xb = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  const T* bb = static_cast<const T*>(a.B) + b * a.sbb + h * a.sbh;
  const T* cb = static_cast<const T*>(a.C) + b * a.scb + h * a.sch;
  const float* db = a.dt + b * a.sdb + h * a.sdh;
  T* yb = static_cast<T*>(a.y) + (b * a.L * a.H + h) * a.P;
  const long long y_row = a.H * a.P;

  for (int i = tid; i < kS * kP; i += kThreads) ht[i] = 0.0f;

  for (long long t0 = 0; t0 < a.L; t0 += kT) {
    const int n = static_cast<int>(a.L - t0 < kT ? a.L - t0 : kT);
    // 1. This chunk's x, B, C, dt in fp32; zero past L and past P, S.
    for (int i = tid; i < kT * kP; i += kThreads) {
      const int t = i / kP, p = i % kP;
      xs[i] = (t < n && p < a.P) ? to_f32(xb[(t0 + t) * a.sxl + p]) : 0.0f;
    }
    for (int i = tid; i < kT * kS; i += kThreads) {
      const int t = i / kS, k = i % kS;
      const bool ok = t < n && k < a.S;
      bs[t * kBLd + k] = ok ? to_f32(bb[(t0 + t) * a.sbl + k]) : 0.0f;
      cs[t * kBLd + k] = ok ? to_f32(cb[(t0 + t) * a.scl + k]) : 0.0f;
    }
    if (tid < kT) dts[tid] = tid < n ? db[(t0 + tid) * a.sdl] : 0.0f;
    __syncthreads();

    // 2. cum = cumsum(dt A), in order, each product and sum rounded on
    //    its own; then exp(cum) and the weights of the state update.
    if (tid == 0) {
      float c = 0.0f;
      for (int t = 0; t < kT; ++t) {
        c = __fadd_rn(c, __fmul_rn(dts[t], A));
        cum[t] = c;
      }
    }
    __syncthreads();
    const float cum_last = cum[kT - 1];
    if (tid < kT) {
      ecum[tid] = expf(cum[tid]);
      wts[tid] = expf(cum_last - cum[tid]) * dts[tid];
    }

    // 3. scores[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t,
    //    else exactly 0. This thread: rows ti + 16 r, columns tj + 16 c;
    //    pairs with c > r lie wholly above the diagonal and are skipped.
    {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      for (int k = 0; k < kS; k += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = *reinterpret_cast<const float4*>(
              &cs[(ti + 16 * r) * kBLd + k]);
          bv[r] = *reinterpret_cast<const float4*>(
              &bs[(tj + 16 * r) * kBLd + k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c) {
            acc[r][c] = fmaf(cv[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(cv[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(cv[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(cv[r].w, bv[c].w, acc[r][c]);
          }
      }
      __syncthreads();  // cum, dts complete; ecum, wts written
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int t = ti + 16 * r, s = tj + 16 * c;
          gs[t * kGLd + s] =
              s <= t ? acc[r][c] * expf(cum[t] - cum[s]) * dts[s] : 0.0f;
        }
    }
    __syncthreads();

    // 4. y[t][p] = scores . x + exp(cum_t) (C_t . h^T) + D x. This thread:
    //    rows ti + 16 r, columns 4 tj .. 4 tj + 3.
    {
      float yd[4][4], yh[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) yd[r][e] = yh[r][e] = 0.0f;
      for (int s = 0; s < kT; s += 4) {
        float4 g[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          g[r] = *reinterpret_cast<const float4*>(
              &gs[(ti + 16 * r) * kGLd + s]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[(s + q) * kP + 4 * tj]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float gv = q == 0 ? g[r].x : q == 1 ? g[r].y
                           : q == 2 ? g[r].z : g[r].w;
            yd[r][0] = fmaf(gv, xv.x, yd[r][0]);
            yd[r][1] = fmaf(gv, xv.y, yd[r][1]);
            yd[r][2] = fmaf(gv, xv.z, yd[r][2]);
            yd[r][3] = fmaf(gv, xv.w, yd[r][3]);
          }
        }
      }
      for (int k = 0; k < kS; k += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(
              &cs[(ti + 16 * r) * kBLd + k]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 hv =
              *reinterpret_cast<const float4*>(&ht[(k + q) * kP + 4 * tj]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float c = q == 0 ? cv[r].x : q == 1 ? cv[r].y
                          : q == 2 ? cv[r].z : cv[r].w;
            yh[r][0] = fmaf(c, hv.x, yh[r][0]);
            yh[r][1] = fmaf(c, hv.y, yh[r][1]);
            yh[r][2] = fmaf(c, hv.z, yh[r][2]);
            yh[r][3] = fmaf(c, hv.w, yh[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = ti + 16 * r;
        if (t >= n) continue;
        T* dst = yb + (t0 + t) * y_row;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 4 * tj + e;
          if (p >= a.P) continue;
          float v = yd[r][e] + ecum[t] * yh[r][e];
          v = v + xs[t * kP + p] * Dh;
          put(dst + p, v);
        }
      }
    }
    __syncthreads();  // every read of h^T is done

    // 5. h'^T[k][p] = exp(cum_last) h^T[k][p]
    //                 + sum_t B[t][k] (x[t][p] exp(cum_last - cum_t) dt_t).
    //    This thread: rows ti + 16 r (r < 8) of h^T, columns 4 tj .. + 3.
    {
      float acc[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
      for (int t = 0; t < kT; ++t) {
        const float w = wts[t];
        const float4 xv =
            *reinterpret_cast<const float4*>(&xs[t * kP + 4 * tj]);
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float bv = bs[t * kBLd + ti + 16 * r];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(bv, xw[e], acc[r][e]);
        }
      }
      const float decay = expf(cum_last);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float4* hp = reinterpret_cast<float4*>(&ht[(ti + 16 * r) * kP + 4 * tj]);
        float4 hv = *hp;
        hv.x = decay * hv.x + acc[r][0];
        hv.y = decay * hv.y + acc[r][1];
        hv.z = decay * hv.z + acc[r][2];
        hv.w = decay * hv.w + acc[r][3];
        *hp = hv;
      }
    }
    __syncthreads();  // h^T updated; x, B, C free for the next chunk
  }
}

template <typename T>
int launch(const SsdArgs& a, long long B, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      trim_ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  trim_ssd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Limits the wrapper validates against.
int trim_ssd_max_p() { return kP; }
int trim_ssd_max_s() { return kS; }
int trim_ssd_chunk() { return kT; }

const char* trim_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, L, H, P) with element strides (sxb, sxl, sxh, 1); dt (B, L, H)
// fp32 with strides (sdb, sdl, sdh); A, D (H,) fp32 contiguous; Bm, Cm
// (B, L, H, S) in x's dtype with strides (s*b, s*l, s*h, 1), s*h may be 0;
// y (B, L, H, P) contiguous in x's dtype. bf16 != 0 selects bfloat16 for
// x, Bm, Cm and y, else fp32. P <= 64, S <= 128. Returns the launch's
// cudaError_t.
int trim_ssd(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* D, void* y, int bf16, long long B,
             long long L, long long H, int P, int S, long long sxb,
             long long sxl, long long sxh, long long sdb, long long sdl,
             long long sdh, long long sbb, long long sbl, long long sbh,
             long long scb, long long scl, long long sch, void* stream) {
  if (P < 1 || P > kP || S < 1 || S > kS)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = Bm;
  a.C = Cm;
  a.D = static_cast<const float*>(D);
  a.y = y;
  a.L = L;
  a.H = H;
  a.P = P;
  a.S = S;
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
  if (bf16) return launch<__nv_bfloat16>(a, B, s);
  return launch<float>(a, B, s);
}

}  // extern "C"
