// Swin window attention, backward, read straight from the fused qkv layout
// (kernel K7 of the port).
//
// Replaces the TPU kernels diffusiondepth_tpu/ops/window_attention.py
// _qkv_bwd_kernel_masked / _qkv_bwd_kernel_nomask (core _qkv_bwd_core,
// reached through window_attention_qkv_bwd_pallas). For each (batch,
// window, head), with q, k, v read from qkv (B, nW, N, 3C) in the Dense's
// [q|k|v] x [head] x [d] order and dO from (B, nW, N, C):
//
//   P   = softmax(round(q * round(scale)) k^T + bias[h] [+ mask[w]])  (f32,
//         recomputed exactly as the forward kernel K4 does)
//   dV  = round(P)^T dO
//   dP  = dO V^T
//   dS  = P * (dP - rowsum(dP * P))                                   (f32)
//   dQ  = round(dS) K * scale,   dK = round(dS)^T Q * scale
//   dbias[h] = sum over batch and windows of dS                       (f32)
//
// with round() to the input type (bf16 or f32), f32 accumulation, and dqkv
// (B, nW, N, 3C) in the input type. The mask gets no gradient.
//
// What bounds it on the H100: bytes. A head of a window reads 4*N*d inputs
// and writes 3*N*d for 10*N*N*d FLOP: ~40 FLOP per byte in bf16, far below
// the ~295 FLOP/byte ridge.
//
// What the design does about it: each input byte is read once and nothing
// N x N reaches device memory except the dbias partials. One block per
// (head, window) stages q, k, v and dO of one batch element at a time in
// shared memory (rows padded to 33 floats), one warp per query row
// recomputes its 49 probabilities two per lane, reduces with shuffles,
// forms dS and writes its dQ row; after the rows, one warp per key row
// forms dK and dV from the block's rounded P and dS. The block loops over
// the batch, so dS is summed for dbias in shared memory; each block writes
// its (N, N) partial to (nW, H, N, N) and a second kernel sums the windows
// in a fixed order: no atomics, the same bits on every run. Requires d = 32
// (every Swin stage of this repo) and N <= 64. The arithmetic runs on the
// FMA units, as in K4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int D = 32;
constexpr int NMAX = 64;
constexpr int NWARPS = 4;
constexpr int DP = D + 1;      // padded row of a (N, d) tile
constexpr int NP = NMAX + 1;   // padded row of an (N, N) tile
constexpr size_t SMEM_BYTES = (5 * NMAX * DP + 2 * NMAX * NP + NMAX * NMAX) * sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round to the input type and back
template <typename T>
__device__ __forceinline__ float rt(float v) { return to_f(from_f<T>(v)); }

template <typename T, bool MASKED>
__global__ void __launch_bounds__(NWARPS * 32) window_attention_bwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias, const float* __restrict__ mask,
    const T* __restrict__ dout, T* __restrict__ dqkv, float* __restrict__ part, int B, int nW,
    int N, int C, float scale) {
  const int h = blockIdx.x;
  const int w = blockIdx.y;
  const int heads = gridDim.x;
  extern __shared__ float sm[];
  float* qs = sm;                  // raw q
  float* qc = qs + NMAX * DP;      // round(q * round(scale))
  float* ks = qc + NMAX * DP;
  float* vs = ks + NMAX * DP;
  float* ds = vs + NMAX * DP;      // dO
  float* pl = ds + NMAX * DP;      // round(P)
  float* sl = pl + NMAX * NP;      // round(dS)
  float* dsum = sl + NMAX * NP;    // sum over the batch of dS

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float sc = rt<T>(scale);
  const float* bh = bias + static_cast<size_t>(h) * N * N;
  const float* mw = MASKED ? mask + static_cast<size_t>(w) * N * N : nullptr;
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) dsum[idx] = 0.0f;

  for (int b = 0; b < B; ++b) {
    const size_t win = static_cast<size_t>(b) * nW + w;
    const T* base = qkv + win * N * 3 * C + h * D;
    const T* obase = dout + win * N * C + h * D;
    for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
      const int i = idx / D;
      const int d = idx % D;
      const T* row = base + static_cast<size_t>(i) * 3 * C + d;
      const float q = to_f(row[0]);
      qs[i * DP + d] = q;
      qc[i * DP + d] = rt<T>(q * sc);
      ks[i * DP + d] = to_f(row[C]);
      vs[i * DP + d] = to_f(row[2 * C]);
      ds[i * DP + d] = to_f(obase[static_cast<size_t>(i) * C + d]);
    }
    __syncthreads();

    for (int i = warp; i < N; i += NWARPS) {
      float s[2], dp[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j < N) {
          float acc = 0.0f, g = 0.0f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            acc = fmaf(qc[i * DP + d], ks[j * DP + d], acc);
            g = fmaf(ds[i * DP + d], vs[j * DP + d], g);
          }
          acc += bh[i * N + j];
          if (MASKED) acc += mw[i * N + j];
          s[t] = acc;
          dp[t] = g;
        } else {
          s[t] = -INFINITY;
          dp[t] = 0.0f;
        }
      }
      float m = fmaxf(s[0], s[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e0 = lane < N ? expf(s[0] - m) : 0.0f;
      const float e1 = lane + 32 < N ? expf(s[1] - m) : 0.0f;
      float sum = e0 + e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float p[2] = {e0 / sum, e1 / sum};
      float rs = dp[0] * p[0] + dp[1] * p[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        const float dsv = p[t] * (dp[t] - rs);
        pl[i * NP + j] = rt<T>(p[t]);
        sl[i * NP + j] = j < N ? rt<T>(dsv) : 0.0f;
        if (j < N) dsum[i * N + j] += dsv;
      }
      __syncwarp();
      float dq = 0.0f;
      for (int j = 0; j < N; ++j) dq = fmaf(sl[i * NP + j], ks[j * DP + lane], dq);
      dqkv[(win * N + i) * 3 * C + h * D + lane] = from_f<T>(dq * scale);
      __syncwarp();
    }
    __syncthreads();

    for (int j = warp; j < N; j += NWARPS) {
      float dk = 0.0f, dv = 0.0f;
      for (int i = 0; i < N; ++i) {
        dk = fmaf(sl[i * NP + j], qs[i * DP + lane], dk);
        dv = fmaf(pl[i * NP + j], ds[i * DP + lane], dv);
      }
      T* row = dqkv + (win * N + j) * 3 * C + h * D + lane;
      row[C] = from_f<T>(dk * scale);
      row[2 * C] = from_f<T>(dv);
    }
    __syncthreads();
  }
  float* dst = part + (static_cast<size_t>(w) * heads + h) * N * N;
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) dst[idx] = dsum[idx];
}

// dbias[e] = sum over windows of part[w][e], in order of w
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                    int nW, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int w = 0; w < nW; ++w) s += part[static_cast<size_t>(w) * n + e];
  dbias[e] = s;
}

template <typename T, bool MASKED>
int launch(const void* qkv, const void* bias, const void* mask, const void* dout, void* dqkv,
           float* part, float* dbias, int B, int nW, int N, int C, int heads, float scale,
           cudaStream_t s) {
  auto kernel = window_attention_bwd_kernel<T, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, nW);
  kernel<<<grid, NWARPS * 32, SMEM_BYTES, s>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const T*>(dout), static_cast<T*>(dqkv), part,
      B, nW, N, C, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = heads * N * N;
  dbias_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, dbias, nW, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* qkv, const void* bias, const void* mask, const void* dout, void* dqkv,
             float* part, float* dbias, int B, int nW, int N, int C, int heads, float scale,
             cudaStream_t s) {
  if (mask != nullptr)
    return launch<T, true>(qkv, bias, mask, dout, dqkv, part, dbias, B, nW, N, C, heads, scale, s);
  return launch<T, false>(qkv, bias, mask, dout, dqkv, part, dbias, B, nW, N, C, heads, scale, s);
}

}  // namespace

// qkv: (B, nW, N, 3C); bias: (heads, N, N) f32; mask: (nW, N, N) f32 or
// null; dout: (B, nW, N, C); dqkv: (B, nW, N, 3C); part: (nW, heads, N, N)
// f32 scratch; dbias: (heads, N, N) f32. dtype_code 0 = float32,
// 1 = bfloat16. Returns the first non-zero cudaError_t.
extern "C" int window_attention_bwd_launch(const void* qkv, const void* bias, const void* mask,
                                           const void* dout, void* dqkv, void* part,
                                           void* dbias, int B, int nW, int N, int C, int heads,
                                           float scale, int dtype_code, void* stream) {
  if (C != heads * D || N > NMAX || N <= 0 || nW > 65535 || heads > 65535 || B <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(part);
  auto* dp = static_cast<float*>(dbias);
  if (dtype_code == 1)
    return launch_t<__nv_bfloat16>(qkv, bias, mask, dout, dqkv, pp, dp, B, nW, N, C, heads,
                                   scale, s);
  if (dtype_code == 0)
    return launch_t<float>(qkv, bias, mask, dout, dqkv, pp, dp, B, nW, N, C, heads, scale, s);
  return cudaErrorInvalidValue;
}
