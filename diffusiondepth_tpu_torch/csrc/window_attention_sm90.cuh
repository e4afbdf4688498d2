// Tensor-core core of the port's bf16 window attention: K4
// (csrc/window_attention.cu) and K8 (csrc/window_attention_split.cu) run
// window_attention_fwd_sm90 below; K7 (csrc/window_attention_bwd.cu)
// recomputes the probabilities with the same attn_probs, so its P has the
// forward's bits.
//
// One tile is one (window, head): N <= 64 tokens of d = 32, padded to 64
// query rows and 64 keys. A block of four warps works on one tile at a time,
// warp w on query rows 16w..16w+15; every product is mma.sync.m16n8k16
// (bf16 operands, f32 accumulators):
//
//   S = round(q * round(scale)) K^T   A = q from ldmatrix, scaled and
//                                     rounded in registers; B = K, ldmatrix
//   S += bias[h] (+ mask[w])          f32, on the fragments, from L1/L2:
//                                     every batch element and window shares
//                                     them; keys past N get -inf (the JAX
//                                     colmask)
//   P = softmax(S)                    f32 on the fragments, quad shuffles
//   O = round(P) V                    A = P packed to bf16 from the S
//                                     fragments (FlashAttention-2 layout),
//                                     B = V through ldmatrix.trans
//
// No (N, N) tensor reaches device memory. Tiles live in shared memory as
// 64 rows of 64 bytes with the 16-byte chunk index XORed by (row >> 1) & 3,
// so ldmatrix reads 8 rows without bank conflicts; the (64, 64) bf16 tiles
// of K7 use 128-byte rows, chunk ^ (row & 7). Rows N..63 are zeroed once per
// block and never written again, so padded keys meet zero values and padded
// query rows stay finite; they are never stored.
//
// The block walks a contiguous range of windows of one head (grid: splits x
// heads, block s taking windows [s n / S, (s + 1) n / S) of the B nW
// windows), with a ring of stages: the next windows' rows are in flight on
// cp.async (16-byte chunks) while the current one computes. The output
// tile is staged in the current stage's q slot (each warp writes only the
// rows it read) and written with 16-byte stores.
//
// The numbers are window_attention_plain's (ops/window_attention.py): only
// the summation order differs, and 1 / sum is taken once per row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wa90 {

constexpr int D = 32;
constexpr int NPAD = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TILE = NPAD * D * 2;  // bytes of one (64, 32) bf16 tile
constexpr int PTILE = NPAD * NPAD * 2;  // bytes of one (64, 64) bf16 tile
constexpr int FWD_STAGES = 2;  // windows in the forward's cp.async ring
constexpr int BWD_STAGES = 2;  // windows in the backward's cp.async ring
constexpr int FWD_SMEM = FWD_STAGES * 3 * TILE;  // q, k, v per stage
constexpr int BWD_SMEM = BWD_STAGES * 4 * TILE + 2 * PTILE;  // q, k, v, dO; round(P), round(dS)

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, w, h, n;
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a (64, 32) bf16 tile
__device__ __forceinline__ uint32_t off64(int r, int c) {
  return static_cast<uint32_t>(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// byte offset of 16-byte chunk c of row r in a (64, 64) bf16 tile
__device__ __forceinline__ uint32_t off128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b on one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr), "r"(0) : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// start the cp.async of rows 0..N-1 of a (N, 32) bf16 tile whose row i
// begins at base + i * stride (elements; 16-byte aligned rows)
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* base, long long stride,
                                          int N) {
  for (int idx = threadIdx.x; idx < N * 4; idx += NTHREADS) {
    const int r = idx >> 2, c = idx & 3;
    cp_async16(dst + off64(r, c), base + r * stride + c * 8);
  }
}

// zero rows N..63 of `count` consecutive (64, 32) tiles
__device__ __forceinline__ void zero_pad_rows(uint32_t dst, int count, int N) {
  const int per = (NPAD - N) * 4;
  for (int idx = threadIdx.x; idx < count * per; idx += NTHREADS) {
    const int t = idx / per, r = N + (idx % per) / 4, c = idx & 3;
    st_shared_zero16(dst + t * TILE + off64(r, c));
  }
}

// write an m16n8 f32 accumulator block (times `mul`) as bf16 into rows
// m0 + g, m0 + g + 8 (those below N) at 16-byte chunk c of a (64, 32) tile
__device__ __forceinline__ void stage_frag(uint32_t tile, const float (&acc)[4], int m0, int c,
                                           int N, float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (m0 + g < N) st_shared_u32(tile + off64(m0 + g, c) + 4 * t, pack2(acc[0] * mul, acc[1] * mul));
  if (m0 + g + 8 < N)
    st_shared_u32(tile + off64(m0 + g + 8, c) + 4 * t, pack2(acc[2] * mul, acc[3] * mul));
}

// write rows 0..N-1 of a staged (64, 32) tile to row i at dst + i * stride
__device__ __forceinline__ void store_tile(uint32_t src, bf16* dst, long long stride, int N) {
  for (int idx = threadIdx.x; idx < N * 4; idx += NTHREADS) {
    const int r = idx >> 2, c = idx & 3;
    *reinterpret_cast<uint4*>(dst + r * stride + c * 8) = ld_shared16(src + off64(r, c));
  }
}

// ---------------------------------------------------------------------------
// the probabilities
// ---------------------------------------------------------------------------

// P (f32) of the calling warp's 16 query rows m0 = 16 warp, in the m16n8
// accumulator layout: p[nt] holds (m0 + g, 8 nt + 2t + {0, 1}) and
// (m0 + g + 8, 8 nt + 2t + {0, 1}), g = lane / 4, t = lane % 4. Keys past N
// have P = 0. qs, ks: the tile's raw q and k. sc: scale rounded to bf16.
template <bool MASKED>
__device__ __forceinline__ void attn_probs(uint32_t qs, uint32_t ks, const float* __restrict__ bh,
                                           const float* __restrict__ mw, int N, float sc,
                                           float (&p)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = warp * 16, g = lane >> 2, t = lane & 3;
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    ldsm_x4(qs + off64(m0 + (lane & 15), 2 * kk + (lane >> 4)), qa[kk]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // round(q * round(scale)), as the plain version
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][e]);
      qa[kk][e] = pack2(__low2float(v) * sc, __high2float(v) * sc);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
    if (8 * nt < N) {
      uint32_t kb[4];
      ldsm_x4(ks + off64(8 * nt + (lane & 7), lane >> 3), kb);
      mma16816(p[nt], qa[0], kb[0], kb[1]);
      mma16816(p[nt], qa[1], kb[2], kb[3]);
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + 8 * (e >> 1), col = 8 * nt + 2 * t + (e & 1);
      float v = p[nt][e];
      if (col < N) {
        if (r < N) {
          v += __ldg(bh + r * N + col);
          if (MASKED) v += __ldg(mw + r * N + col);
        }
      } else {
        v = -INFINITY;
      }
      p[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(p[nt][e] - mx[e >> 1]);
      p[nt][e] = x;
      sum[e >> 1] += x;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    sum[h] = 1.0f / sum[h];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[nt][e] *= sum[e >> 1];
  }
}

// the A operand (16 rows x keys 16 kk..16 kk + 15) of a product with the
// accumulators x as its left factor, rounded to bf16
__device__ __forceinline__ void frag_a(const float (&x)[8][4], int kk, uint32_t (&a)[4]) {
  a[0] = pack2(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack2(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// acc (16 rows x 32) += X Y with X from frag_a of x and Y the (64, 32)
// tile y (rows = the contraction), over the first N rows of y
__device__ __forceinline__ void mma_xy(const float (&x)[8][4], uint32_t y, int N,
                                       float (&acc)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk < N) {
      uint32_t a[4];
      frag_a(x, kk, a);
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        uint32_t b[4];
        ldsm_x4_t(y + off64(16 * kk + (lane & 15), 2 * c2 + (lane >> 4)), b);
        mma16816(acc[2 * c2], a, b[0], b[1]);
        mma16816(acc[2 * c2 + 1], a, b[2], b[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the forward kernel
// ---------------------------------------------------------------------------

// Where the tiles of (window win = b nW + w, head h) lie. Fused: qkv
// (B, nW, N, 3C) and out (B, nW, N, C) (K4). Split: q, k, v (B, nW, H, N, D)
// with their own strides and out contiguous (B, nW, H, N, D) (K8).
struct FusedLayout {
  const bf16* qkv;
  bf16* out;
  int nW, N, C;
  __device__ const bf16* in(int which, int win, int h) const {
    return qkv + static_cast<long long>(win) * N * 3 * C + which * C + h * D;
  }
  __device__ long long in_stride(int) const { return 3LL * C; }
  __device__ bf16* out_base(int win, int h) const {
    return out + static_cast<long long>(win) * N * C + h * D;
  }
  __device__ long long out_stride() const { return C; }
};

struct SplitLayout {
  const bf16* qkv[3];
  Strides st[3];
  bf16* out;
  int nW, N, H;
  __device__ const bf16* in(int which, int win, int h) const {
    const int b = win / nW, w = win % nW;
    const Strides& s = st[which];
    return qkv[which] + b * s.b + w * s.w + h * s.h;
  }
  __device__ long long in_stride(int which) const { return st[which].n; }
  __device__ bf16* out_base(int win, int h) const {
    return out + (static_cast<long long>(win) * H + h) * N * D;
  }
  __device__ long long out_stride() const { return D; }
};

template <class Layout, bool MASKED>
__global__ void __launch_bounds__(NTHREADS, 4)
    window_attention_fwd_sm90(Layout L, const float* __restrict__ bias,
                              const float* __restrict__ mask, int n_win, int splits,
                              float scale) {
  extern __shared__ __align__(128) unsigned char sm[];  // FWD_SMEM bytes
  const int h = blockIdx.y, N = L.N;
  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * n_win / splits);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_win / splits);
  const uint32_t base = smem_u32(sm);
  const int warp = threadIdx.x >> 5;
  const float sc = __bfloat162float(__float2bfloat16(scale));
  const float* bh = bias + static_cast<long long>(h) * N * N;
  zero_pad_rows(base, FWD_STAGES * 3, N);
  // one cp.async group per window, committed even when empty, so that
  // group i is window lo + i
  auto prefetch = [&](int win) {
    if (win < hi) {
      const int stage = (win - lo) % FWD_STAGES;
#pragma unroll
      for (int x = 0; x < 3; ++x)
        load_tile(base + (stage * 3 + x) * TILE, L.in(x, win, h), L.in_stride(x), N);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < FWD_STAGES - 1; ++i) prefetch(lo + i);
  for (int win = lo; win < hi; ++win) {
    const int stage = (win - lo) % FWD_STAGES;
    const uint32_t qs = base + stage * 3 * TILE, ks = qs + TILE, vs = ks + TILE;
    cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();  // this window's rows have landed; the previous window's stage is free
    prefetch(win + FWD_STAGES - 1);
    const float* mw = MASKED ? mask + static_cast<long long>(win % L.nW) * N * N : nullptr;
    float p[8][4];
    attn_probs<MASKED>(qs, ks, bh, mw, N, sc, p);
    float o[4][4] = {};
    mma_xy(p, vs, N, o);
    __syncwarp();  // the warp's q rows are read: stage the output over them
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) stage_frag(qs, o[nd], warp * 16, nd, N, 1.0f);
    __syncthreads();
    store_tile(qs, L.out_base(win, h), L.out_stride(), N);
  }
}

// windows per block: fill the card's resident blocks once, across the heads
template <class Kernel>
inline int fwd_splits(Kernel kernel, int n_win, int heads, int& err) {
  int dev = 0, sms = 0, per_sm = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!err)
    err = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM));
  if (!err)
    err = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, FWD_SMEM));
  const int want = (sms * (per_sm > 0 ? per_sm : 1) + heads - 1) / heads;
  return want < n_win ? want : n_win;
}

template <class Layout>
int launch_fwd(const Layout& L, const float* bias, const float* mask, int n_win, int heads,
               float scale, cudaStream_t s) {
  int err = 0;
  if (mask != nullptr) {
    auto kernel = window_attention_fwd_sm90<Layout, true>;
    const int splits = fwd_splits(kernel, n_win, heads, err);
    if (err) return err;
    kernel<<<dim3(splits, heads), NTHREADS, FWD_SMEM, s>>>(L, bias, mask, n_win, splits, scale);
  } else {
    auto kernel = window_attention_fwd_sm90<Layout, false>;
    const int splits = fwd_splits(kernel, n_win, heads, err);
    if (err) return err;
    kernel<<<dim3(splits, heads), NTHREADS, FWD_SMEM, s>>>(L, bias, nullptr, n_win, splits,
                                                            scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wa90
