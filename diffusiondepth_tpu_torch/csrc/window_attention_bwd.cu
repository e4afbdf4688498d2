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
// bf16 (every model path), window_attention_bwd_sm90 below, on the
// tensor-core core of window_attention_sm90.cuh. The whole 49-key row fits
// one tile, so one pass per (window, head) tile, no online softmax:
//
// - S and P recomputed by attn_probs, the forward's code, so P has K4's
//   bits; dP = dO V^T on mma.sync; dS in f32 on the fragments;
// - dQ = round(dS) K from the dS fragments (the A operand in registers);
// - round(P) and round(dS) staged as (64, 64) bf16 tiles, then each warp
//   takes 16 keys: dV = round(P)^T dO and dK = round(dS)^T q, both
//   operands through ldmatrix.trans;
// - dqkv staged over the tile's q, k, v slots and written with 16-byte
//   stores; the next window's q, k, v, dO are in flight on cp.async
//   meanwhile (two-stage ring, 48 KB per 128-thread block: 4 blocks, 16
//   warps per SM).
//
// dbias: the grid is (splits, heads); block s of head h walks windows
// [s n / S, (s + 1) n / S) of the n = B nW windows in order, sums dS in its
// fragment registers and writes one (N, N) partial to part (S, H, N, N).
// dbias_reduce_kernel then sums the S partials in order: no atomics, the
// same bits on every run. S = window_attention_bwd_splits (ops/
// window_attention.py), which also sizes part.
//
// f32 (the O0 policy and the f32 card tests): the FMA kernel below, exact
// to f32 summation order. One block per (head, window) stages q, k, v and
// dO of one batch element at a time in shared memory (rows padded to 33
// floats), one warp per query row recomputes its probabilities two per
// lane, forms dS and writes its dQ row; one warp per key row then forms dK
// and dV. The block loops over the batch and sums dS for dbias in shared
// memory, writing one partial per window (S = nW). Requires d = 32 (every
// Swin stage of this repo) and N <= 64.

#include "window_attention_sm90.cuh"

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

// bf16: one (window, head) tile per iteration, as described at the top
template <bool MASKED>
__global__ void __launch_bounds__(wa90::NTHREADS, 4) window_attention_bwd_sm90(
    const wa90::bf16* __restrict__ qkv, const float* __restrict__ bias,
    const float* __restrict__ mask, const wa90::bf16* __restrict__ dout,
    wa90::bf16* __restrict__ dqkv, float* __restrict__ part, int nW, int N, int C, int n_win,
    int splits, float scale) {
  using namespace wa90;
  extern __shared__ __align__(128) unsigned char smem[];  // BWD_SMEM bytes
  const int h = blockIdx.y, heads = gridDim.y;
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * n_win / splits);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_win / splits);
  const uint32_t base = smem_u32(smem), pss = base + BWD_STAGES * 4 * TILE, dss = pss + PTILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = warp * 16, g = lane >> 2, t = lane & 3;
  const float sc = __bfloat162float(__float2bfloat16(scale));
  const float* bh = bias + static_cast<long long>(h) * N * N;
  const long long C3 = 3LL * C;
  zero_pad_rows(base, BWD_STAGES * 4, N);
  // one cp.async group per window, committed even when empty
  auto prefetch = [&](int win) {
    if (win < hi) {
      const int stage = (win - lo) % BWD_STAGES;
      const bf16* row = qkv + static_cast<long long>(win) * N * C3 + h * D;
#pragma unroll
      for (int x = 0; x < 3; ++x) load_tile(base + (stage * 4 + x) * TILE, row + x * C, C3, N);
      load_tile(base + (stage * 4 + 3) * TILE, dout + static_cast<long long>(win) * N * C + h * D,
                C, N);
    }
    cp_async_commit();
  };
  float db[8][4] = {};
#pragma unroll
  for (int i = 0; i < BWD_STAGES - 1; ++i) prefetch(lo + i);
  for (int win = lo; win < hi; ++win) {
    const int stage = (win - lo) % BWD_STAGES;
    const uint32_t qs = base + stage * 4 * TILE, ks = qs + TILE, vs = ks + TILE, dos = vs + TILE;
    cp_async_wait<BWD_STAGES - 2>();
    __syncthreads();  // this window's rows have landed; the previous window's stage is free
    prefetch(win + BWD_STAGES - 1);
    const float* mw = MASKED ? mask + static_cast<long long>(win % nW) * N * N : nullptr;
    float p[8][4];
    attn_probs<MASKED>(qs, ks, bh, mw, N, sc, p);
    // round(P), its padded query rows zero: they must not reach dV
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      st_shared_u32(pss + off128(m0 + g, nt) + 4 * t,
                    m0 + g < N ? pack2(p[nt][0], p[nt][1]) : 0u);
      st_shared_u32(pss + off128(m0 + g + 8, nt) + 4 * t,
                    m0 + g + 8 < N ? pack2(p[nt][2], p[nt][3]) : 0u);
    }
    // dP = dO V^T, then dS = P (dP - rowsum(dP P)); padded rows have dO = 0, so dS = 0
    uint32_t oa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) ldsm_x4(dos + off64(m0 + (lane & 15), 2 * kk + (lane >> 4)), oa[kk]);
    float ds[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      ds[nt][0] = ds[nt][1] = ds[nt][2] = ds[nt][3] = 0.0f;
      if (8 * nt < N) {
        uint32_t vb[4];
        ldsm_x4(vs + off64(8 * nt + (lane & 7), lane >> 3), vb);
        mma16816(ds[nt], oa[0], vb[0], vb[1]);
        mma16816(ds[nt], oa[1], vb[2], vb[3]);
      }
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e >> 1] += ds[nt][e] * p[nt][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[nt][e] = p[nt][e] * (ds[nt][e] - rs[e >> 1]);
        db[nt][e] += ds[nt][e];
      }
      st_shared_u32(dss + off128(m0 + g, nt) + 4 * t, pack2(ds[nt][0], ds[nt][1]));
      st_shared_u32(dss + off128(m0 + g + 8, nt) + 4 * t, pack2(ds[nt][2], ds[nt][3]));
    }
    // dQ = round(dS) K (times scale when staged)
    float dq[4][4] = {};
    mma_xy(ds, ks, N, dq);
    __syncthreads();  // round(P) and round(dS) complete
    // the warp's 16 keys: dK = round(dS)^T q, dV = round(P)^T dO
    float dk[4][4] = {}, dv[4][4] = {};
    if (m0 < N) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk < N) {
          const uint32_t at = off128(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                     2 * warp + ((lane >> 3) & 1));
          uint32_t sa[4], pa[4];
          ldsm_x4_t(dss + at, sa);
          ldsm_x4_t(pss + at, pa);
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const uint32_t bt = off64(16 * kk + (lane & 15), 2 * c2 + (lane >> 4));
            uint32_t b[4];
            ldsm_x4_t(qs + bt, b);
            mma16816(dk[2 * c2], sa, b[0], b[1]);
            mma16816(dk[2 * c2 + 1], sa, b[2], b[3]);
            ldsm_x4_t(dos + bt, b);
            mma16816(dv[2 * c2], pa, b[0], b[1]);
            mma16816(dv[2 * c2 + 1], pa, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every tile of this stage is read: stage dq, dk, dv over q, k, v
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) {
      stage_frag(qs, dq[nd], m0, nd, N, scale);
      stage_frag(ks, dk[nd], m0, nd, N, scale);
      stage_frag(vs, dv[nd], m0, nd, N, 1.0f);
    }
    __syncthreads();
    bf16* out = dqkv + static_cast<long long>(win) * N * C3 + h * D;
#pragma unroll
    for (int x = 0; x < 3; ++x) store_tile(qs + x * TILE, out + x * C, C3, N);
  }
  float* dst = part + (static_cast<long long>(blockIdx.x) * heads + h) * N * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e >> 1), col = 8 * nt + 2 * t + (e & 1);
      if (r < N && col < N) dst[r * N + col] = db[nt][e];
    }
  }
}

// dbias[e] = sum over the partials s of part[s][e], in order of s
__global__ void dbias_reduce_kernel(const float* __restrict__ part, float* __restrict__ dbias,
                                    int parts, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int w = 0; w < parts; ++w) s += part[static_cast<size_t>(w) * n + e];
  dbias[e] = s;
}

int reduce(const float* part, float* dbias, int parts, int n, cudaStream_t s) {
  dbias_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, dbias, parts, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool MASKED>
int launch_f32(const void* qkv, const void* bias, const void* mask, const void* dout, void* dqkv,
               float* part, float* dbias, int B, int nW, int N, int C, int heads, float scale,
               cudaStream_t s) {
  auto kernel = window_attention_bwd_kernel<float, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, nW);
  kernel<<<grid, NWARPS * 32, SMEM_BYTES, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const float*>(dout),
      static_cast<float*>(dqkv), part, B, nW, N, C, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(part, dbias, nW, heads * N * N, s);
}

template <bool MASKED>
int launch_bf16(const void* qkv, const void* bias, const void* mask, const void* dout,
                void* dqkv, float* part, float* dbias, int B, int nW, int N, int C, int heads,
                int splits, float scale, cudaStream_t s) {
  auto kernel = window_attention_bwd_sm90<MASKED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wa90::BWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(splits, heads), wa90::NTHREADS, wa90::BWD_SMEM, s>>>(
      static_cast<const wa90::bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const wa90::bf16*>(dout),
      static_cast<wa90::bf16*>(dqkv), part, nW, N, C, B * nW, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(part, dbias, splits, heads * N * N, s);
}

}  // namespace

// qkv: (B, nW, N, 3C); bias: (heads, N, N) f32; mask: (nW, N, N) f32 or
// null; dout: (B, nW, N, C); dqkv: (B, nW, N, 3C); part: (splits, heads,
// N, N) f32 scratch; dbias: (heads, N, N) f32. dtype_code 0 = float32
// (splits must be nW), 1 = bfloat16 (1 <= splits <= B nW). Returns the
// first non-zero cudaError_t.
extern "C" int window_attention_bwd_launch(const void* qkv, const void* bias, const void* mask,
                                           const void* dout, void* dqkv, void* part,
                                           void* dbias, int B, int nW, int N, int C, int heads,
                                           int splits, float scale, int dtype_code,
                                           void* stream) {
  if (C != heads * D || N > NMAX || N <= 0 || nW > 65535 || heads > 65535 || B <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<float*>(part);
  auto* dp = static_cast<float*>(dbias);
  if (dtype_code == 1) {
    if (splits < 1 || splits > B * nW) return cudaErrorInvalidValue;
    if (mask != nullptr)
      return launch_bf16<true>(qkv, bias, mask, dout, dqkv, pp, dp, B, nW, N, C, heads, splits,
                               scale, s);
    return launch_bf16<false>(qkv, bias, mask, dout, dqkv, pp, dp, B, nW, N, C, heads, splits,
                              scale, s);
  }
  if (dtype_code == 0) {
    if (splits != nW) return cudaErrorInvalidValue;
    if (mask != nullptr)
      return launch_f32<true>(qkv, bias, mask, dout, dqkv, pp, dp, B, nW, N, C, heads, scale, s);
    return launch_f32<false>(qkv, bias, mask, dout, dqkv, pp, dp, B, nW, N, C, heads, scale, s);
  }
  return cudaErrorInvalidValue;
}
