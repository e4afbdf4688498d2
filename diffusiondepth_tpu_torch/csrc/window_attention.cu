// Swin window attention, forward, fed straight from the qkv Dense output
// (kernel K4 of the port).
//
// Replaces the TPU kernels diffusiondepth_tpu/ops/window_attention.py
// _qkv_kernel_masked / _qkv_kernel_nomask (core _qkv_core, reached through
// window_attention_qkv_pallas). For each (batch, window, head):
//
//   out = softmax( round(q * round(scale)) k^T + bias[h] [+ mask[w]] ) v
//
// with q, k, v read from qkv (B, nW, N, 3C) in the Dense's channel order
// [q|k|v] x [head] x [d], f32 logits and softmax, probabilities rounded to
// the input type before P.v, f32 accumulation, and out (B, nW, N, C) in the
// input type. The (N, N) logits never reach device memory.
//
// What bounds it on the H100: bytes. A head of a window does
// 4*N*N*d = 307 kFLOP on 3*N*d inputs (9.4 KB in bf16): ~33 FLOP per byte,
// far below the ~295 FLOP/byte ridge. At the Swin-L stage-1 eval shape
// (bs8, 352x1216) one call reads ~258 MB of qkv and writes ~86 MB.
//
// bf16 (every model path): the tensor-core core of window_attention_sm90.cuh
// (mma.sync m16n8k16, P kept in registers as the A operand of P.v, tiles
// on a two-stage cp.async ring, each block walking a run of windows of one
// head).
//
// f32 (the O0 policy and the f32 card tests): the FMA kernel below, exact
// to f32 summation order (TF32 tensor cores would not meet 1e-5). One block
// per (head, window, batch) stages its 49x32 q, k and v in shared memory
// (rows padded to 33 floats), one warp per query row computes the 49
// logits two per lane, reduces max and sum with shuffles, and writes its
// output row with one coalesced 32-lane store. Requires d = 32 (every Swin
// stage of this repo) and N <= 64.

#include "window_attention_sm90.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int D = 32;
constexpr int NMAX = 64;
constexpr int NWARPS = 4;

// the FMA kernel is instantiated for float only (bf16 runs the tensor-core
// core), where these conversions are the identity
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// round to the input type and back
template <typename T>
__device__ __forceinline__ float rt(float v) { return to_f(from_f<T>(v)); }

template <typename T, bool MASKED>
__global__ void __launch_bounds__(NWARPS * 32) window_attention_kernel(
    const T* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, T* __restrict__ out, int nW, int N, int C,
    float scale) {
  const int h = blockIdx.x;
  const int w = blockIdx.y;
  const int b = blockIdx.z;
  __shared__ float qs[NMAX][D + 1];
  __shared__ float ks[NMAX][D + 1];
  __shared__ float vs[NMAX][D + 1];
  __shared__ float ps[NWARPS][NMAX];

  const size_t win = static_cast<size_t>(b) * nW + w;
  const T* base = qkv + win * N * 3 * C + h * D;
  const float sc = rt<T>(scale);
  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int i = idx / D;
    const int d = idx % D;
    const T* row = base + static_cast<size_t>(i) * 3 * C + d;
    qs[i][d] = rt<T>(to_f(row[0]) * sc);
    ks[i][d] = to_f(row[C]);
    vs[i][d] = to_f(row[2 * C]);
  }
  __syncthreads();

  const float* bh = bias + static_cast<size_t>(h) * N * N;
  const float* mw = MASKED ? mask + static_cast<size_t>(w) * N * N : nullptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = warp; i < N; i += NWARPS) {
    float s[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) acc = fmaf(qs[i][d], ks[j][d], acc);
        acc += bh[i * N + j];
        if (MASKED) acc += mw[i * N + j];
        s[t] = acc;
      } else {
        s[t] = -INFINITY;
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
    ps[warp][lane] = rt<T>(e0 / sum);
    ps[warp][lane + 32] = rt<T>(e1 / sum);
    __syncwarp();
    float o = 0.0f;
    for (int j = 0; j < N; ++j) o = fmaf(ps[warp][j], vs[j][lane], o);
    out[(win * N + i) * C + h * D + lane] = from_f<T>(o);
    __syncwarp();
  }
}

template <typename T>
int launch(const void* qkv, const void* bias, const void* mask, void* out,
           int B, int nW, int N, int C, int heads, float scale,
           cudaStream_t s) {
  dim3 grid(heads, nW, B);
  if (mask != nullptr) {
    window_attention_kernel<T, true><<<grid, NWARPS * 32, 0, s>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(bias),
        static_cast<const float*>(mask), static_cast<T*>(out), nW, N, C, scale);
  } else {
    window_attention_kernel<T, false><<<grid, NWARPS * 32, 0, s>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(bias), nullptr,
        static_cast<T*>(out), nW, N, C, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, nW, N, 3C); bias: (heads, N, N) f32; mask: (nW, N, N) f32 or
// null; out: (B, nW, N, C). dtype_code 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int window_attention_launch(const void* qkv, const void* bias,
                                       const void* mask, void* out, int B,
                                       int nW, int N, int C, int heads,
                                       float scale, int dtype_code,
                                       void* stream) {
  if (C != heads * D || N > NMAX || N <= 0 || nW > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1) {
    const wa90::FusedLayout L{static_cast<const wa90::bf16*>(qkv), static_cast<wa90::bf16*>(out),
                              nW, N, C};
    return wa90::launch_fwd(L, static_cast<const float*>(bias), static_cast<const float*>(mask),
                            B * nW, heads, scale, s);
  }
  if (dtype_code == 0)
    return launch<float>(qkv, bias, mask, out, B, nW, N, C, heads, scale, s);
  return cudaErrorInvalidValue;
}
