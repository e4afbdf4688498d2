// One link of the denoiser conv chain on Hopper (kernel K1 of the port).
//
// Replaces the TPU kernel diffusiondepth_tpu/ops/fused_denoiser.py
// _link_kernel (reached through _fused_link). It computes
//
//   y = conv3x3( zero_outside_image( T(x) ) ) + bias
//   T(x) = [relu]( [x * aeff + beff] ) [+ (add [+ te])]
//
// on the unpadded NHWC layout, with bf16 operands, f32 accumulation, bf16
// y, and per-(batch, block) f32 sums (sum y, sum y^2) of the accumulator
// for the GroupNorm that follows. The prologue rounds to bf16 after every
// operation, as the TPU kernel's bf16 arithmetic does, and zeroes the
// out-of-image taps after the transform: the conv pads the transformed map
// with zeros, so padding x with zeros would be wrong (T(0) != 0).
//
// What bounds it on the H100: at the bs8 eval latent (8, 176, 608) the
// 256->256 links do 2*B*H*W*9*Cin*Cout = 1.01 TFLOP for ~0.5 GB of traffic,
// ~2000 FLOP per byte, far above the card's ~295 FLOP/byte ridge: the link
// is bound by tensor-core operations.
//
// What the design does about it: an implicit GEMM (M = output pixels,
// N = Cout, K = 9 taps x Cin) on the tensor cores through WMMA bf16 16x16x16
// fragments with f32 accumulators. A block owns 128 output pixels of one
// image row and 128 output channels (64 when Cout is not a multiple of
// 128, 16 for the last link). For each 16-channel chunk of Cin it stages
// the 3-row halo once in shared memory and transforms it in place, so the
// nine taps are nine shifted views of the same tile and the prologue runs
// once per input element per block, not nine times; the chunk's weights
// for all nine taps sit beside it. Two stages: cp.async copies the next
// chunk while the current one is transformed and multiplied. The
// output-channel blocks of a row segment are launched next to each other,
// so they find its input in L2. Registers are capped for two blocks per
// SM. The statistics are reduced inside the block and written per block,
// with no atomics and no order between blocks: the caller sums the
// (B, n_blocks, 2, Cout) buffer. The TPU devices that have no use here
// (the zero-bordered Wp layout, pltpu.roll taps, dr-chunking for the
// 128-wide MXU) are not carried over. Not yet done: wgmma and TMA; that
// is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;  // output pixels per block, along one image row
constexpr int BK = 16;   // input channels per k-chunk
constexpr int KV = BK / 8;  // 16-byte vectors per pixel and chunk
constexpr int NTHREADS = 256;

constexpr int F_GN = 1, F_RELU = 2, F_ADD = 4, F_TE = 8, F_STATS = 16;

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

template <int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(NTHREADS, 2) conv_link_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ aeff,
    const float* __restrict__ beff, const __nv_bfloat16* __restrict__ add,
    const __nv_bfloat16* __restrict__ te, __nv_bfloat16* __restrict__ y,
    float* __restrict__ partials, int H, int W, int Cin, int Cout,
    int n_wtiles, int flags) {
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  static_assert(WARPS_M * WARPS_N * 32 == NTHREADS, "warp layout");
  static_assert(FM >= 1 && FN >= 1, "warp tile");
  static_assert(BM * BN * 4 <= smem_bytes<BN>(), "epilogue tile fits the stages");
  constexpr int A_ELEMS = 3 * (BM + 2) * BK;
  constexpr int RED_ROWS = NTHREADS / BN;

  // two stages of [halo of x | weights]; the epilogue reuses the space for
  // the f32 output tile
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][RED_ROWS][BN];
  const bool has_add = flags & F_ADD;
  const bool transform = flags & (F_GN | F_RELU | F_ADD);
  constexpr int st_elems = stage_elems<BN>();
  __nv_bfloat16* const base = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  // output-channel blocks of one row segment are neighbours in launch
  // order, so the segment's input is read from L2 by all of them
  const int nz = Cout / BN;
  const int n0 = (blockIdx.x % nz) * BN;
  const int seg = blockIdx.x / nz;
  const int h = seg / n_wtiles;
  const int wt = seg % n_wtiles;
  const int w0 = wt * BM;
  const int b = blockIdx.y;

  // asynchronous copy of chunk c0 (16 input channels) into stage s: the
  // raw 3-row halo (zeros outside the image) and the weights
  auto issue = [&](int c0, int s) {
    __nv_bfloat16* A = base + s * st_elems;
    __nv_bfloat16* Bs = A + A_ELEMS;
    for (int it = tid; it < 3 * (BM + 2) * KV; it += NTHREADS) {
      const int kv = it % KV;
      const int p = (it / KV) % (BM + 2);
      const int r = (it / KV) / (BM + 2);
      const int hh = h + r - 1;
      const int ww = w0 + p - 1;
      const bool valid = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const size_t off =
          valid ? ((static_cast<size_t>(b) * H + hh) * W + ww) * Cin + c0 + kv * 8 : 0;
      const int dst = (r * (BM + 2) + p) * BK + kv * 8;
      cp_async16(A + dst, x + off, valid);
    }
    for (int it = tid; it < 9 * BK * (BN / 8); it += NTHREADS) {
      const int col8 = it % (BN / 8);
      const int row = it / (BN / 8);
      const int tap = row / BK;
      const int k = row % BK;
      cp_async16(Bs + (tap * BK + k) * BN + col8 * 8,
                 w + (static_cast<size_t>(tap) * Cin + c0 + k) * Cout + n0 + col8 * 8, true);
    }
    cp_async_commit();
  };

  // the prologue T(x), in place, on the in-image taps of stage s (the
  // out-of-image taps stay zero: the conv pads the transformed map). A
  // thread always handles the same 8 channels of a chunk (NTHREADS is a
  // multiple of KV), so it reads their affine and te once per chunk. The
  // add map is read here from global memory rather than staged, which keeps
  // the add link's shared memory, and so its occupancy, that of the others.
  static_assert(NTHREADS % KV == 0, "fixed channels per thread");
  auto apply_transform = [&](int c0, int s) {
    __nv_bfloat16* A = base + s * st_elems;
    const int kv = tid % KV;
    const int c = c0 + kv * 8;
    float ga[8], gb[8], tv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ga[k] = (flags & F_GN) ? rbf(aeff[b * Cin + c + k]) : 1.0f;
      gb[k] = (flags & F_GN) ? rbf(beff[b * Cin + c + k]) : 0.0f;
      tv[k] = (flags & F_TE) ? __bfloat162float(te[b * Cin + c + k]) : 0.0f;
    }
    for (int it = tid; it < 3 * (BM + 2) * KV; it += NTHREADS) {
      const int p = (it / KV) % (BM + 2);
      const int r = (it / KV) / (BM + 2);
      const int hh = h + r - 1;
      const int ww = w0 + p - 1;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
      const int dst = (r * (BM + 2) + p) * BK + kv * 8;
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(A + dst), v);
      if (flags & F_GN) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = rbf(rbf(v[k] * ga[k]) + gb[k]);
      }
      if (flags & F_RELU) {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k], 0.0f);
      }
      if (has_add) {
        float av[8];
        unpack8(*reinterpret_cast<const uint4*>(
                    add + ((static_cast<size_t>(b) * H + hh) * W + ww) * Cin + c), av);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float t = (flags & F_TE) ? rbf(av[k] + tv[k]) : av[k];
          v[k] = rbf(v[k] + t);
        }
      }
      *reinterpret_cast<uint4*>(A + dst) = pack8(v);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_chunks = Cin / BK;
  issue(0, 0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s = ci & 1;
    // the next chunk's copy runs while this chunk is transformed and multiplied
    if (ci + 1 < n_chunks) {
      issue((ci + 1) * BK, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (transform) {
      apply_transform(ci * BK, s);
      __syncthreads();
    }
    const __nv_bfloat16* A = base + s * st_elems;
    const __nv_bfloat16* Bs = A + A_ELEMS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3;
      const int dc = tap % 3;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bfr[FN];
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(bfr[j], Bs + (tap * BK + kk) * BN + wn * WN + j * 16, BN);
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> afr;
          // output pixel m reads halo column m + dc of halo row dr
          wmma::load_matrix_sync(afr, A + (dr * (BM + 2) + dc + wm * WM + i * 16) * BK + kk,
                                 BK);
#pragma unroll
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], afr, bfr[j], acc[i][j]);
        }
      }
    }
    // the stage is refilled by the copy issued at the next iteration
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * BN + wn * WN + j * 16,
                              acc[i][j], BN, wmma::mem_row_major);
  __syncthreads();

  const int n = tid % BN;
  const int r0 = tid / BN;
  const float bv = bias[n0 + n];
  float s = 0.0f, q = 0.0f;
  for (int m = r0; m < BM; m += RED_ROWS) {
    const int ww = w0 + m;
    if (ww < W) {
      const float v = Cs[m * BN + n] + bv;
      y[((static_cast<size_t>(b) * H + h) * W + ww) * Cout + n0 + n] = __float2bfloat16(v);
      s += v;
      q += v * v;
    }
  }
  if (flags & F_STATS) {
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
      float* dst = partials + blk * 2 * Cout + n0 + tid;
      dst[0] = ss;
      dst[Cout] = qq;
    }
  }
}

template <int BN, int WARPS_M, int WARPS_N>
int launch(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
           const float* aeff, const float* beff, const __nv_bfloat16* add,
           const __nv_bfloat16* te, __nv_bfloat16* y, float* partials, int B, int H,
           int W, int Cin, int Cout, int flags, cudaStream_t s) {
  auto kernel = conv_link_kernel<BN, WARPS_M, WARPS_N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<BN>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_wtiles = (W + BM - 1) / BM;
  dim3 grid(n_wtiles * H * (Cout / BN), B);
  kernel<<<grid, NTHREADS, smem_bytes<BN>(), s>>>(
      x, w, bias, aeff, beff, add, te, y, partials, H, W, Cin, Cout, n_wtiles, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_link_block_pixels() { return BM; }

// x, add: (B, H, W, Cin) bf16; w: (3, 3, Cin, Cout) bf16; bias: (Cout,) f32;
// aeff, beff: (B, Cin) f32; te: (B, Cin) bf16; y: (B, H, W, Cout) bf16;
// partials: (B, H * ceil(W / BM), 2, Cout) f32. Unused pointers may be null
// when their flag is off. Returns cudaGetLastError() after the launch.
extern "C" int conv_link_launch(const void* x, const void* w, const void* bias,
                                const void* aeff, const void* beff,
                                const void* add, const void* te, void* y,
                                void* partials, int B, int H, int W, int Cin,
                                int Cout, int flags, void* stream) {
  if (Cin % BK != 0 || B <= 0 || H <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const float*>(bias);
  const auto* ap = static_cast<const float*>(aeff);
  const auto* op = static_cast<const float*>(beff);
  const auto* dp = static_cast<const __nv_bfloat16*>(add);
  const auto* tp = static_cast<const __nv_bfloat16*>(te);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout % 128 == 0)
    return launch<128, 2, 4>(xp, wp, bp, ap, op, dp, tp, yp, pp, B, H, W, Cin, Cout, flags, s);
  if (Cout % 64 == 0)
    return launch<64, 4, 2>(xp, wp, bp, ap, op, dp, tp, yp, pp, B, H, W, Cin, Cout, flags, s);
  if (Cout == 16)
    return launch<16, 8, 1>(xp, wp, bp, ap, op, dp, tp, yp, pp, B, H, W, Cin, Cout, flags, s);
  return cudaErrorInvalidValue;
}
