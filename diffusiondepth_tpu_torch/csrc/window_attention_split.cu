// Swin window attention, forward, on split q/k/v (kernel K8 of the port).
//
// Replaces the TPU kernels diffusiondepth_tpu/ops/window_attention.py
// _kernel_masked / _kernel_nomask (core _attn_core, reached through
// window_attention_pallas, the v2 attention that --use_pallas selects at
// eval). For each (batch, window, head):
//
//   out = softmax( round(q * round(scale)) k^T + bias[h] [+ mask[w]] ) v
//
// with q, k, v each read from a (B, nW, H, N, D) tensor with its own
// strides (unit stride along D), f32 logits and softmax, probabilities
// rounded to the input type before P.v, f32 accumulation, and out a
// contiguous (B, nW, H, N, D) tensor in the input type. This is what K4
// (csrc/window_attention.cu) computes from the fused qkv layout, summed in
// the same order, so on the same data the two give the same bits.
//
// The shift mask stays f32 here. The JAX kernel casts it to the input type
// first; its only values, 0 and -100, are exact in bf16, so the cast changes
// nothing. The TPU kernel's padding of N = 49 to 56 and its -1e30 key mask
// are layout for the TPU's (8, 128) tiles; the bf16 core pads to 64 rows
// and keys for the tensor cores' tiles, with -inf on the padded keys.
//
// What bounds it on the H100: bytes. A head of a window does
// 4*N*N*d = 307 kFLOP on 3*N*d inputs (9.4 KB in bf16): ~33 FLOP per byte,
// far below the ~295 FLOP/byte ridge. At the first Swin-L stage of the
// eval batch (bs8, 352x1216) one call reads ~258 MB of q, k, v and writes
// ~86 MB.
//
// bf16: K4's tensor-core core (window_attention_sm90.cuh) with a loader
// that reads each row of q, k and v through its own strides (multiples of
// 8 elements, for the 16-byte cp.async chunks). The core sums in one order
// whatever the layout, so K8 gives K4's bits on the same data.
//
// f32: the FMA kernel below, which sums in the order of K4's f32 kernel.
// One block per (head, window, batch) stages its 49x32 q, k and v in shared
// memory (rows padded to 33 floats: conflict-free per-key access). Each
// lane then keeps keys `lane` and `lane + 32` in registers, so a logit
// costs one broadcast shared-memory load per two FMAs; one warp per query
// row reduces max and sum with shuffles and writes its output row with one
// coalesced 32-lane store. Requires d = 32 (every Swin stage of this repo)
// and N <= 64.

#include "window_attention_sm90.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int D = 32;
constexpr int NMAX = 64;
constexpr int NWARPS = 4;

using wa90::Strides;

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
__global__ void __launch_bounds__(NWARPS * 32) window_attention_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, T* __restrict__ out,
    Strides sq, Strides sk, Strides sv, int nW, int H, int N, float scale) {
  const int h = blockIdx.x;
  const int w = blockIdx.y;
  const int b = blockIdx.z;
  __shared__ float qs[NMAX][D + 1];
  __shared__ float ks[NMAX][D + 1];
  __shared__ float vs[NMAX][D + 1];
  __shared__ float ps[NWARPS][NMAX];

  const T* qb = q + b * sq.b + w * sq.w + h * sq.h;
  const T* kb = k + b * sk.b + w * sk.w + h * sk.h;
  const T* vb = v + b * sv.b + w * sv.w + h * sv.h;
  const float sc = rt<T>(scale);
  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int i = idx / D;
    const int d = idx % D;
    qs[i][d] = rt<T>(to_f(qb[i * sq.n + d]) * sc);
    ks[i][d] = to_f(kb[i * sk.n + d]);
    vs[i][d] = to_f(vb[i * sv.n + d]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has0 = lane < N;
  const bool has1 = lane + 32 < N;
  float k0[D], k1[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    k0[d] = has0 ? ks[lane][d] : 0.0f;
    k1[d] = has1 ? ks[lane + 32][d] : 0.0f;
  }

  const float* bh = bias + static_cast<size_t>(h) * N * N;
  const float* mw = MASKED ? mask + static_cast<size_t>(w) * N * N : nullptr;
  T* ob = out + ((static_cast<size_t>(b) * nW + w) * H + h) * N * D;
  for (int i = warp; i < N; i += NWARPS) {
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float qv = qs[i][d];
      s0 = fmaf(qv, k0[d], s0);
      s1 = fmaf(qv, k1[d], s1);
    }
    if (has0) {
      s0 += bh[i * N + lane];
      if (MASKED) s0 += mw[i * N + lane];
    } else {
      s0 = -INFINITY;
    }
    if (has1) {
      s1 += bh[i * N + lane + 32];
      if (MASKED) s1 += mw[i * N + lane + 32];
    } else {
      s1 = -INFINITY;
    }
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = has0 ? expf(s0 - m) : 0.0f;
    const float e1 = has1 ? expf(s1 - m) : 0.0f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    ps[warp][lane] = rt<T>(e0 / sum);
    ps[warp][lane + 32] = rt<T>(e1 / sum);
    __syncwarp();
    float o = 0.0f;
    for (int j = 0; j < N; ++j) o = fmaf(ps[warp][j], vs[j][lane], o);
    ob[i * D + lane] = from_f<T>(o);
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, Strides sq, Strides sk, Strides sv, int B, int nW, int H, int N,
           float scale, cudaStream_t s) {
  dim3 grid(H, nW, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* bt = static_cast<const float*>(bias);
  if (mask != nullptr) {
    window_attention_split_kernel<T, true><<<grid, NWARPS * 32, 0, s>>>(
        qt, kt, vt, bt, static_cast<const float*>(mask), static_cast<T*>(out), sq, sk, sv,
        nW, H, N, scale);
  } else {
    window_attention_split_kernel<T, false><<<grid, NWARPS * 32, 0, s>>>(
        qt, kt, vt, bt, nullptr, static_cast<T*>(out), sq, sk, sv, nW, H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, nW, H, N, D) with element strides (b, w, h, n) each and unit
// stride along D; bias: (H, N, N) f32; mask: (nW, N, N) f32 or null; out:
// contiguous (B, nW, H, N, D). dtype_code 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int window_attention_split_launch(
    const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out,
    long long qsb, long long qsw, long long qsh, long long qsn,
    long long ksb, long long ksw, long long ksh, long long ksn,
    long long vsb, long long vsw, long long vsh, long long vsn,
    int B, int nW, int H, int N, float scale, int dtype_code, void* stream) {
  if (N > NMAX || N <= 0 || H > 65535 || nW > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  // the bf16 loader's 16-byte chunks
  if (dtype_code == 1 && ((qsb | qsw | qsh | qsn | ksb | ksw | ksh | ksn | vsb | vsw | vsh | vsn) & 7))
    return cudaErrorInvalidValue;
  const Strides sq{qsb, qsw, qsh, qsn}, sk{ksb, ksw, ksh, ksn}, sv{vsb, vsw, vsh, vsn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1) {
    const wa90::SplitLayout L{{static_cast<const wa90::bf16*>(q), static_cast<const wa90::bf16*>(k),
                               static_cast<const wa90::bf16*>(v)},
                              {sq, sk, sv}, static_cast<wa90::bf16*>(out), nW, N, H};
    return wa90::launch_fwd(L, static_cast<const float*>(bias), static_cast<const float*>(mask),
                            B * nW, H, scale, s);
  }
  if (dtype_code == 0)
    return launch<float>(q, k, v, bias, mask, out, sq, sk, sv, B, nW, H, N, scale, s);
  return cudaErrorInvalidValue;
}
