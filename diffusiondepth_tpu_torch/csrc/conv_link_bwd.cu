// The backward of one link of the denoiser conv chain on Hopper (kernel K5
// of the port).
//
// Replaces the TPU kernel diffusiondepth_tpu/ops/fused_denoiser.py
// _bwd_link_kernel (reached through _bwd_link, chained by
// _chain_bwd_links). The link is u_out = conv3x3(T(u_in)) + bias with
// T(u) = [relu(u * aeff + beff)] [+ add [+ te]], zero outside the image.
// Given r, the raw cotangent of u_out, it computes
//
//   du  = (r - m1 - xhat * m2) * inv,  xhat = (u_out - mean) * inv
//         when a GroupNorm consumes u_out (flag GN_NEXT), else du = r;
//   dv  = conv3x3(du, flipped and transposed weights)            (f32)
//   t   = relu'(pre) * bf16(dv) * scale  with (sum t, sum t * xhat_in)
//         per block and channel (flag GN_IN), else t = bf16(dv);
//   da  = bf16(dv)                                         (flag ADD)
//   dW[dr][dc] = sum over pixels of T(u_in)[h+dr-1, w+dc-1] (x) du[h, w]
//   dbias = sum over pixels of du
//
// with the TPU kernel's rounding points: xhat, du, pre and t in bf16
// arithmetic (rounded after every operation), bf16 x bf16 products
// accumulated in f32, dv in f32 and then rounded. T(u_in) is recomputed
// in the backward kernel's order, (relu(pre) + add) + te.
//
// What bounds it on the H100: tensor-core operations. The two products,
// dv and dW, are each 2*B*H*W*9*Cin*Cout: at the training latent
// (4, 176, 453) the 256->256 links do 0.75 TFLOP for ~0.3 GB of traffic.
//
// What the design does about it: three launches.
//  1. The data-gradient kernel is the forward kernel's implicit GEMM
//     (csrc/conv_link.cu: WMMA bf16 16x16x16 fragments, f32 accumulators,
//     a two-stage cp.async pipeline over 16-channel chunks of the staged
//     3-row halo) run on du with the flipped, transposed weights. Its
//     prologue assembles du in place from r and u_out, and writes du out
//     once (the first channel block of each row segment) for pass 2. Its
//     epilogue reads u_in, applies the ReLU / GroupNorm-input masking,
//     writes t, d(add) and T(u_in) (for pass 2), and reduces the GroupNorm
//     partials inside the block.
//  2. The weight-gradient kernel is a GEMM dW_tap = T(u_in)_shifted^T du
//     with K = B*H*W pixels: a block owns one tap, a 64x64 (or 16-wide)
//     tile of (Cin, Cout) and a range of image rows, stages 32-pixel
//     chunks of both maps in shared memory with cp.async (zero-filled
//     outside the image) and writes its own partial dW; the centre tap's
//     first channel tile also sums du for dbias.
//  3. A reduce kernel sums the partials over the row ranges in a fixed
//     order. No float atomics anywhere: two launches on the same inputs
//     give the same bits.
// The TPU devices (the zero-bordered Wp layout, pltpu.roll taps, a
// resident dW block accumulated across the sequential grid) are not
// carried over. Not yet done: wgmma, TMA, fusing pass 2 into pass 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;     // output pixels per data-gradient block, along one row
constexpr int BK = 16;      // channels of du per k-chunk
constexpr int KV = BK / 8;  // 16-byte vectors per pixel and chunk
constexpr int NTHREADS = 256;

constexpr int F_GN_NEXT = 1, F_GN_IN = 2, F_ADD = 4, F_TE = 8;

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* v) {
  const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(p[k]);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 raw;
  __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = __float2bfloat16(v[k]);
  return raw;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BN>
__host__ __device__ constexpr int stage_elems() {
  return 3 * (BM + 2) * BK + 9 * BK * BN;
}

template <int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * static_cast<size_t>(stage_elems<BN>()) * sizeof(__nv_bfloat16);
}

// ---------------------------------------------------------------------------
// 1. data gradient: dv = conv3x3(du, wt), with du assembled in the prologue
// ---------------------------------------------------------------------------

// r, un: (B, H, W, Cr) bf16; wt: (3, 3, Cr, Ci) bf16; cnext: (B, 8, Cr) f32
// [inv, mean, m1, m2, ...]; u: (B, H, W, Ci) bf16; cin: (B, 8, Ci) f32
// [aeff, beff, inv, mean, scale, ...]; add: (B, H, W, Ci); te: (B, Ci).
template <int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(NTHREADS, 2) data_grad_kernel(
    const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ wt,
    const __nv_bfloat16* __restrict__ un, const float* __restrict__ cnext,
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ cin,
    const __nv_bfloat16* __restrict__ add, const __nv_bfloat16* __restrict__ te,
    __nv_bfloat16* __restrict__ t_out, __nv_bfloat16* __restrict__ da,
    __nv_bfloat16* __restrict__ v_out, __nv_bfloat16* __restrict__ du_out,
    float* __restrict__ partials, int H, int W, int Cr, int Ci, int n_wtiles, int flags) {
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  static_assert(WARPS_M * WARPS_N * 32 == NTHREADS, "warp layout");
  static_assert(FM >= 1 && FN >= 1, "warp tile");
  static_assert(BM * BN * 4 <= smem_bytes<BN>(), "epilogue tile fits the stages");
  constexpr int A_ELEMS = 3 * (BM + 2) * BK;
  constexpr int RED_ROWS = NTHREADS / BN;

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][RED_ROWS][BN];
  constexpr int st_elems = stage_elems<BN>();
  __nv_bfloat16* const base = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int nz = Ci / BN;
  const int n0 = (blockIdx.x % nz) * BN;
  const int seg = blockIdx.x / nz;
  const int h = seg / n_wtiles;
  const int w0 = (seg % n_wtiles) * BM;
  const int b = blockIdx.y;

  auto issue = [&](int c0, int s) {
    __nv_bfloat16* A = base + s * st_elems;
    __nv_bfloat16* Bs = A + A_ELEMS;
    for (int it = tid; it < 3 * (BM + 2) * KV; it += NTHREADS) {
      const int kv = it % KV;
      const int p = (it / KV) % (BM + 2);
      const int rr = (it / KV) / (BM + 2);
      const int hh = h + rr - 1;
      const int ww = w0 + p - 1;
      const bool valid = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const size_t off =
          valid ? ((static_cast<size_t>(b) * H + hh) * W + ww) * Cr + c0 + kv * 8 : 0;
      cp_async16(A + (rr * (BM + 2) + p) * BK + kv * 8, r + off, valid);
    }
    for (int it = tid; it < 9 * BK * (BN / 8); it += NTHREADS) {
      const int col8 = it % (BN / 8);
      const int row = it / (BN / 8);
      const int tap = row / BK;
      const int k = row % BK;
      cp_async16(Bs + (tap * BK + k) * BN + col8 * 8,
                 wt + (static_cast<size_t>(tap) * Cr + c0 + k) * Ci + n0 + col8 * 8, true);
    }
    cp_async_commit();
  };

  // du from r in place on the in-image taps of stage s (out-of-image taps
  // stay zero: the transposed conv pads du with zeros); the first channel
  // block of a segment also writes its centre row out for pass 2
  static_assert(NTHREADS % KV == 0, "fixed channels per thread");
  auto assemble_du = [&](int c0, int s) {
    __nv_bfloat16* A = base + s * st_elems;
    const int kv = tid % KV;
    const int c = c0 + kv * 8;
    float inv[8], mean[8], m1[8], m2[8];
    const float* cb = cnext + static_cast<size_t>(b) * 8 * Cr + c;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      inv[k] = rbf(cb[k]);
      mean[k] = rbf(cb[Cr + k]);
      m1[k] = rbf(cb[2 * Cr + k]);
      m2[k] = rbf(cb[3 * Cr + k]);
    }
    for (int it = tid; it < 3 * (BM + 2) * KV; it += NTHREADS) {
      const int p = (it / KV) % (BM + 2);
      const int rr = (it / KV) / (BM + 2);
      const int hh = h + rr - 1;
      const int ww = w0 + p - 1;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
      const int dst = (rr * (BM + 2) + p) * BK + kv * 8;
      const size_t g = ((static_cast<size_t>(b) * H + hh) * W + ww) * Cr + c;
      float v[8], x[8];
      unpack8(*reinterpret_cast<const uint4*>(A + dst), v);
      unpack8(*reinterpret_cast<const uint4*>(un + g), x);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = rbf(rbf(x[k] - mean[k]) * inv[k]);
        v[k] = rbf(rbf(rbf(v[k] - m1[k]) - rbf(xh * m2[k])) * inv[k]);
      }
      const uint4 packed = pack8(v);
      *reinterpret_cast<uint4*>(A + dst) = packed;
      if (rr == 1 && p >= 1 && p <= BM && n0 == 0)
        *reinterpret_cast<uint4*>(du_out + g) = packed;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_chunks = Cr / BK;
  issue(0, 0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s = ci & 1;
    if (ci + 1 < n_chunks) {
      issue((ci + 1) * BK, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (flags & F_GN_NEXT) {
      assemble_du(ci * BK, s);
      __syncthreads();
    }
    const __nv_bfloat16* A = base + s * st_elems;
    const __nv_bfloat16* Bs = A + A_ELEMS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3;
      const int dc = tap % 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + tap * BK * BN + wn * WN + j * 16, BN);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afr;
        wmma::load_matrix_sync(afr, A + (dr * (BM + 2) + dc + wm * WM + i * 16) * BK, BK);
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], afr, bfr[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * BN + wn * WN + j * 16, acc[i][j], BN,
                              wmma::mem_row_major);
  __syncthreads();

  const int n = tid % BN;
  const int c = n0 + n;
  const int r0 = tid / BN;
  const bool gn_in = flags & F_GN_IN;
  float ain = 0.f, bin = 0.f, inv_i = 0.f, mean_i = 0.f, scale = 0.f;
  if (gn_in) {
    const float* cb = cin + static_cast<size_t>(b) * 8 * Ci + c;
    ain = rbf(cb[0]);
    bin = rbf(cb[Ci]);
    inv_i = rbf(cb[2 * Ci]);
    mean_i = rbf(cb[3 * Ci]);
    scale = rbf(cb[4 * Ci]);
  }
  const float tv = (flags & F_TE) ? __bfloat162float(te[b * Ci + c]) : 0.0f;
  float s = 0.0f, q = 0.0f;
  for (int m = r0; m < BM; m += RED_ROWS) {
    const int ww = w0 + m;
    if (ww >= W) continue;
    const size_t g = ((static_cast<size_t>(b) * H + h) * W + ww) * Ci + c;
    const float dv = Cs[m * BN + n];
    float v = __bfloat162float(u[g]);
    if (gn_in) {
      const float pre = rbf(rbf(v * ain) + bin);
      const float t = pre > 0.0f ? rbf(rbf(dv) * scale) : 0.0f;
      t_out[g] = __float2bfloat16(t);
      s += t;
      q += rbf(t * rbf(rbf(v - mean_i) * inv_i));
      v = fmaxf(pre, 0.0f);
    } else {
      t_out[g] = __float2bfloat16(dv);
    }
    if (flags & F_ADD) {
      da[g] = __float2bfloat16(dv);
      v = rbf(v + __bfloat162float(add[g]));
      if (flags & F_TE) v = rbf(v + tv);
    }
    if (flags & (F_GN_IN | F_ADD)) v_out[g] = __float2bfloat16(v);
  }
  if (gn_in) {
    red[0][r0][n] = s;
    red[1][r0][n] = q;
    __syncthreads();
    if (tid < BN) {
      float ss = 0.0f, qq = 0.0f;
      for (int rr = 0; rr < RED_ROWS; ++rr) {
        ss += red[0][rr][tid];
        qq += red[1][rr][tid];
      }
      const size_t blk = static_cast<size_t>(b) * H * n_wtiles + static_cast<size_t>(seg);
      float* dst = partials + blk * 2 * Ci + n0 + tid;
      dst[0] = ss;
      dst[Ci] = qq;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. weight gradient: partial dW per range of image rows
// ---------------------------------------------------------------------------

constexpr int KC = 32;  // pixels per chunk
constexpr int WG_THREADS = 128;

// v: (B, H, W, Ci) bf16, T(u_in); du: (B, H, W, Co) bf16.
// dwp: (n_split, 9, Ci, Co) f32; dbp: (n_split, Co) f32.
template <int BCI, int BCO>
__global__ void __launch_bounds__(WG_THREADS) weight_grad_kernel(
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ du,
    float* __restrict__ dwp, float* __restrict__ dbp, int B, int H, int W, int Ci, int Co,
    int rows_per_split) {
  constexpr int FM = BCI / 16;
  constexpr int FN = BCO / 16;
  constexpr int FRAGS = FM * FN;
  constexpr int NW = WG_THREADS / 32;
  static_assert(FRAGS % NW == 0, "fragments per warp");
  constexpr int PER_WARP = FRAGS / NW;
  __shared__ __align__(128) __nv_bfloat16 Vs[KC * BCI];
  __shared__ __align__(128) __nv_bfloat16 Ds[KC * BCO];

  const int nco = Co / BCO;
  const int nci = Ci / BCI;
  const int co0 = (blockIdx.x % nco) * BCO;
  const int ci_t = (blockIdx.x / nco) % nci;
  const int ci0 = ci_t * BCI;
  const int tap = blockIdx.x / (nco * nci);
  const int dr = tap / 3 - 1;
  const int dc = tap % 3 - 1;
  const int split = blockIdx.y;
  const int row0 = split * rows_per_split;
  const int row1 = min(B * H, row0 + rows_per_split);
  const bool do_db = tap == 4 && ci_t == 0;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PER_WARP];
#pragma unroll
  for (int f = 0; f < PER_WARP; ++f) wmma::fill_fragment(acc[f], 0.0f);
  float dbs = 0.0f;

  for (int row = row0; row < row1; ++row) {
    const int b = row / H;
    const int h = row % H;
    const int hv = h + dr;
    const bool row_ok = hv >= 0 && hv < H;
    for (int w0 = 0; w0 < W; w0 += KC) {
      for (int it = tid; it < KC * (BCI / 8); it += WG_THREADS) {
        const int k = it / (BCI / 8);
        const int c8 = it % (BCI / 8);
        const int wv = w0 + k + dc;
        const bool ok = row_ok && w0 + k < W && wv >= 0 && wv < W;
        const size_t off = ok ? ((static_cast<size_t>(b) * H + hv) * W + wv) * Ci + ci0 + c8 * 8 : 0;
        cp_async16(Vs + k * BCI + c8 * 8, v + off, ok);
      }
      for (int it = tid; it < KC * (BCO / 8); it += WG_THREADS) {
        const int k = it / (BCO / 8);
        const int c8 = it % (BCO / 8);
        const bool ok = w0 + k < W;
        const size_t off = ok ? ((static_cast<size_t>(b) * H + h) * W + w0 + k) * Co + co0 + c8 * 8 : 0;
        cp_async16(Ds + k * BCO + c8 * 8, du + off, ok);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (do_db && tid < BCO) {
        for (int k = 0; k < KC; ++k) dbs += __bfloat162float(Ds[k * BCO + tid]);
      }
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
        for (int f = 0; f < PER_WARP; ++f) {
          const int idx = warp + f * NW;
          const int i = idx / FN;
          const int j = idx % FN;
          // A = T(u_in)^T: element (ci, k) at Vs[k * BCI + ci], column-major
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> afr;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr;
          wmma::load_matrix_sync(afr, Vs + kk * BCI + i * 16, BCI);
          wmma::load_matrix_sync(bfr, Ds + kk * BCO + j * 16, BCO);
          wmma::mma_sync(acc[f], afr, bfr, acc[f]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int f = 0; f < PER_WARP; ++f) {
    const int idx = warp + f * NW;
    const int i = idx / FN;
    const int j = idx % FN;
    float* dst = dwp + ((static_cast<size_t>(split) * 9 + tap) * Ci + ci0 + i * 16) * Co + co0 + j * 16;
    wmma::store_matrix_sync(dst, acc[f], Co, wmma::mem_row_major);
  }
  if (do_db && tid < BCO) dbp[static_cast<size_t>(split) * Co + co0 + tid] = dbs;
}

// 3. dw[i] = sum_s dwp[s][i], db[c] = sum_s dbp[s][c], in order of s
__global__ void reduce_kernel(const float* __restrict__ dwp, const float* __restrict__ dbp,
                              float* __restrict__ dw, float* __restrict__ db, int n_dw,
                              int n_db, int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_dw) {
    float s = 0.0f;
    for (int k = 0; k < n_split; ++k) s += dwp[static_cast<size_t>(k) * n_dw + i];
    dw[i] = s;
  } else if (i < n_dw + n_db) {
    const int c = i - n_dw;
    float s = 0.0f;
    for (int k = 0; k < n_split; ++k) s += dbp[static_cast<size_t>(k) * n_db + c];
    db[c] = s;
  }
}

template <int BN, int WARPS_M, int WARPS_N>
int launch_data(const __nv_bfloat16* r, const __nv_bfloat16* wt, const __nv_bfloat16* un,
                const float* cnext, const __nv_bfloat16* u, const float* cin,
                const __nv_bfloat16* add, const __nv_bfloat16* te, __nv_bfloat16* t_out,
                __nv_bfloat16* da, __nv_bfloat16* v_out, __nv_bfloat16* du_out, float* ps,
                int B, int H, int W, int Cr, int Ci, int flags, cudaStream_t s) {
  auto kernel = data_grad_kernel<BN, WARPS_M, WARPS_N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<BN>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_wtiles = (W + BM - 1) / BM;
  dim3 grid(n_wtiles * H * (Ci / BN), B);
  kernel<<<grid, NTHREADS, smem_bytes<BN>(), s>>>(r, wt, un, cnext, u, cin, add, te, t_out, da,
                                                  v_out, du_out, ps, H, W, Cr, Ci, n_wtiles,
                                                  flags);
  return static_cast<int>(cudaGetLastError());
}

template <int BCI, int BCO>
int launch_weight(const __nv_bfloat16* v, const __nv_bfloat16* du, float* dwp, float* dbp, int B,
                  int H, int W, int Ci, int Co, int n_split, cudaStream_t s) {
  const int rows_per_split = (B * H + n_split - 1) / n_split;
  dim3 grid(9 * (Ci / BCI) * (Co / BCO), n_split);
  weight_grad_kernel<BCI, BCO><<<grid, WG_THREADS, 0, s>>>(v, du, dwp, dbp, B, H, W, Ci, Co,
                                                         rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_link_bwd_block_pixels() { return BM; }

// r: (B, H, W, Cout) bf16, raw cotangent of the link output; wt: (3, 3,
// Cout, Cin) bf16, the link's weights flipped and transposed; u_in: (B, H,
// W, Cin) bf16; u_next: (B, H, W, Cout) bf16 and coef_next (B, 8, Cout) f32
// with GN_NEXT; coef_in: (B, 8, Cin) f32 with GN_IN; add: (B, H, W, Cin)
// and te (B, Cin) bf16 with ADD / TE. Outputs: t_in (B, H, W, Cin) bf16;
// da (B, H, W, Cin) bf16 with ADD; partials (B, H * ceil(W / BM), 2, Cin)
// f32 with GN_IN; dw (3, 3, Cin, Cout) and db (Cout) f32. Scratch: v
// (B, H, W, Cin) bf16 with GN_IN or ADD; du (B, H, W, Cout) bf16 with
// GN_NEXT; dwp (n_split, 9, Cin, Cout) and dbp (n_split, Cout) f32.
// Unused pointers may be null. Returns the first non-zero cudaError_t.
extern "C" int conv_link_bwd_launch(const void* r, const void* wt, const void* u_in,
                                    const void* u_next, const void* coef_next,
                                    const void* coef_in, const void* add, const void* te,
                                    void* t_in, void* da, void* v, void* du, void* partials,
                                    void* dwp, void* dbp, void* dw, void* db, int B, int H,
                                    int W, int Cin, int Cout, int n_split, int flags,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 || n_split <= 0 || n_split > 65535 ||
      n_split > B * H)
    return cudaErrorInvalidValue;
  if (!(Cin == 16 || Cin % 64 == 0) || !(Cout == 16 || Cout % 64 == 0))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const bf*>(r);
  const auto* wtp = static_cast<const bf*>(wt);
  const auto* up = static_cast<const bf*>(u_in);
  const auto* unp = static_cast<const bf*>(u_next);
  const auto* cnp = static_cast<const float*>(coef_next);
  const auto* cip = static_cast<const float*>(coef_in);
  const auto* ap = static_cast<const bf*>(add);
  const auto* tp = static_cast<const bf*>(te);
  auto* top = static_cast<bf*>(t_in);
  auto* dap = static_cast<bf*>(da);
  auto* vp = static_cast<bf*>(v);
  auto* dup = static_cast<bf*>(du);
  auto* pp = static_cast<float*>(partials);
  int err;
  if (Cin % 128 == 0)
    err = launch_data<128, 2, 4>(rp, wtp, unp, cnp, up, cip, ap, tp, top, dap, vp, dup, pp, B, H,
                                 W, Cout, Cin, flags, s);
  else if (Cin % 64 == 0)
    err = launch_data<64, 4, 2>(rp, wtp, unp, cnp, up, cip, ap, tp, top, dap, vp, dup, pp, B, H,
                                W, Cout, Cin, flags, s);
  else
    err = launch_data<16, 8, 1>(rp, wtp, unp, cnp, up, cip, ap, tp, top, dap, vp, dup, pp, B, H,
                                W, Cout, Cin, flags, s);
  if (err != 0) return err;

  const bf* vsrc = (flags & (F_GN_IN | F_ADD)) ? vp : up;
  const bf* dsrc = (flags & F_GN_NEXT) ? dup : rp;
  auto* dwpp = static_cast<float*>(dwp);
  auto* dbpp = static_cast<float*>(dbp);
  if (Cin % 64 == 0 && Cout % 64 == 0)
    err = launch_weight<64, 64>(vsrc, dsrc, dwpp, dbpp, B, H, W, Cin, Cout, n_split, s);
  else if (Cin % 64 == 0)
    err = launch_weight<64, 16>(vsrc, dsrc, dwpp, dbpp, B, H, W, Cin, Cout, n_split, s);
  else if (Cout % 64 == 0)
    err = launch_weight<16, 64>(vsrc, dsrc, dwpp, dbpp, B, H, W, Cin, Cout, n_split, s);
  else
    err = cudaErrorInvalidValue;  // a 16 -> 16 link is not in the chain
  if (err != 0) return err;

  const int n_dw = 9 * Cin * Cout;
  const int total = n_dw + Cout;
  reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(dwpp, dbpp, static_cast<float*>(dw),
                                                   static_cast<float*>(db), n_dw, Cout, n_split);
  return static_cast<int>(cudaGetLastError());
}
