// One link of the denoiser conv chain on Hopper (kernel K1 of the port).
//
// Replaces the TPU kernel diffusiondepth_tpu/ops/fused_denoiser.py
// _link_kernel (:63, reached through _fused_link). It computes
//
//   y = conv3x3( zero_outside_image( T(x) ) ) + bias
//   T(x) = [relu]( [x * aeff + beff] ) [+ (add [+ te])]
//
// on the unpadded NHWC layout, with bf16 operands, f32 accumulation, bf16
// y, and per-(batch, block) f32 sums (sum y, sum y^2) of the accumulator
// plus bias for the GroupNorm that follows. The prologue rounds to bf16
// after every operation, as the TPU kernel's bf16 arithmetic does, and
// leaves the out-of-image taps at zero after the transform: the conv pads
// the transformed map with zeros, so padding x with zeros would be wrong
// (T(0) != 0).
//
// What bounds it on the H100: at the bs8 eval latent (8, 176, 608) the
// 256->256 links do 2*B*H*W*9*Cin*Cout = 1.01 TFLOP for ~0.5 GB of traffic,
// ~2000 FLOP per byte, far above the card's ~295 FLOP/byte ridge: the link
// is bound by tensor-core operations (1.02 ms at 989 TFLOP/s).
//
// What the design does about it: the implicit GEMM of csrc/conv3x3_sm90.cuh
// (M = 128 output pixels of one row segment, N = the whole Cout up to 256,
// K = 9 taps x Cin in 64-channel chunks) on wgmma, fed by a TMA/mbarrier
// ring: two halo stages, each transformed in place once and used by all
// nine taps, and three (N = 256) or six weight stages. With N = 256 the
// halo of a row segment is staged and transformed once for all output
// channels. One producer warpgroup (one thread issues TMA) and two
// consumer warpgroups, registers moved to the consumers with setmaxnreg.
// The prologue runs in the consumers between the chunk's arrival and its
// first tap, four units' loads in flight at a time: its f32 arithmetic
// with a rounding after every operation, and the add map's loads, are what
// make the transformed links slower than the plain ones (fa against fb).
// Neither interleaving it with the previous chunk's wgmma nor packed bf16
// operations (which broke the statistics' 1e-4) made it cheaper. The
// epilogue adds the bias, writes y as bf16 pairs, and reduces the
// statistics from the wgmma fragments: warp shuffles over each warp's 16
// rows, then the eight warps in a fixed order through shared memory. No
// atomics: two launches give the same bits. The caller sums the
// (B, n_blocks, 2, Cout) partials. The weights arrive as (3, 3, Cout, Cin)
// (K contiguous); the wrapper transposes them.
//
// The 16-wide links use the same loop: ne0 (Cin = 16) with 16-channel
// chunks in 32-byte swizzled rows, pr1 (Cout = 16) with m64n16 wgmma, two
// blocks per SM. Together ~1.2% of the chain's operations, they are bound
// by moving their maps (pr1 reads a 64-channel x and writes 16 channels)
// and by the pipeline's fill and the epilogue per block, not by the tensor
// cores.

#include "conv3x3_sm90.cuh"

namespace {

using namespace sm90;

constexpr int F_GN = 1, F_RELU = 2, F_ADD = 4, F_TE = 8, F_STATS = 16;

// T(x) in place on a halo stage: per 16-byte unit of 8 channels, the
// in-image units only (the TMA zero fill stays for the others). A thread
// always handles the same 8 channels of a chunk, so it reads their affine
// and te once per chunk. The add map is read from global memory.
template <class Cfg>
struct LinkTransform {
  bool active;
  const float* aeff;
  const float* beff;
  const __nv_bfloat16* add;
  const __nv_bfloat16* te;
  int b, h, w0, H, W, Cin, flags;

  __device__ void operator()(uint8_t* A, int chunk) const {
    constexpr int KV = Cfg::KC / 8;  // units per halo pixel
    static_assert(256 % KV == 0, "fixed channels per thread");
    const int kv = threadIdx.x % KV;
    const int c = chunk * Cfg::KC + kv * 8;
    float ga[8], gb[8], tv[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      ga[k] = (flags & F_GN) ? rbf(aeff[b * Cin + c + k]) : 1.0f;
      gb[k] = (flags & F_GN) ? rbf(beff[b * Cin + c + k]) : 0.0f;
      tv[k] = (flags & F_TE) ? __bfloat162float(te[b * Cin + c + k]) : 0.0f;
    }
    // U units per round: their loads (the add map's from global memory)
    // are all issued before the first is used; the narrow tiles, at the
    // registers of two blocks per SM, take one
    constexpr int U = Cfg::MIN_BLOCKS == 1 ? 4 : 1;
    constexpr int TOTAL = 3 * Cfg::HALO * KV;
    for (int u0 = threadIdx.x; u0 < TOTAL; u0 += 256 * U) {
      uint4 raw[U], araw[U];
      uint32_t off[U];
      bool ok[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int u = u0 + 256 * k;
        const int row = u / KV;
        const int hh = h + row / Cfg::HALO - 1;
        const int ww = w0 + row % Cfg::HALO - 1;
        ok[k] = u < TOTAL && hh >= 0 && hh < H && ww >= 0 && ww < W;
        off[k] = swz<Cfg::RB>(row * Cfg::RB + kv * 16);
        if (ok[k]) {
          raw[k] = *reinterpret_cast<const uint4*>(A + off[k]);
          if (flags & F_ADD)
            araw[k] = *reinterpret_cast<const uint4*>(
                add + ((static_cast<size_t>(b) * H + hh) * W + ww) * Cin + c);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (!ok[k]) continue;
        float v[8];
        unpack8(raw[k], v);
        if (flags & F_GN) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = rbf(rbf(v[e] * ga[e]) + gb[e]);
        }
        if (flags & F_RELU) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.0f);
        }
        if (flags & F_ADD) {
          float av[8];
          unpack8(araw[k], av);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float t = (flags & F_TE) ? rbf(av[e] + tv[e]) : av[e];
            v[e] = rbf(v[e] + t);
          }
        }
        *reinterpret_cast<uint4*>(A + off[k]) = pack8(v);
      }
    }
  }
};

struct NoFlip {
  __device__ int operator()(int tap) const { return tap; }
};

template <int BN, int KC>
__global__ void __launch_bounds__(384, (Conv3x3<BN, KC>::MIN_BLOCKS)) conv_link_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ bias, const float* __restrict__ aeff,
    const float* __restrict__ beff, const __nv_bfloat16* __restrict__ add,
    const __nv_bfloat16* __restrict__ te, __nv_bfloat16* __restrict__ y,
    float* __restrict__ partials, int H, int W, int Cin, int Cout, int n_wtiles, int flags) {
  using Cfg = Conv3x3<BN, KC>;
  extern __shared__ uint8_t smem_raw[];
  const Cfg pipe(smem_raw);
  // the output-channel blocks of one row segment are neighbours in launch
  // order, so they find its input in L2
  const int nz = Cout / BN;
  const int n0 = (blockIdx.x % nz) * BN;
  const int seg = blockIdx.x / nz;
  const int h = seg / n_wtiles;
  const int w0 = (seg % n_wtiles) * Cfg::BM;
  const int b = blockIdx.y;
  const int n_chunks = Cin / KC;
  const bool transform = flags & (F_GN | F_RELU | F_ADD);
  LinkTransform<Cfg> tr{transform, aeff, beff, add, te, b, h, w0, H, W, Cin, flags};

  if (threadIdx.x == 0) pipe.init();
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warpgroup
    Cfg::producer_regs();
    if (threadIdx.x == 256)
      pipe.produce(&xmap, &wmap, b, h, w0, n0, n_chunks, NoFlip{});
    return;
  }
  Cfg::consumer_regs();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  pipe.consume(acc, n_chunks, tr);

  // epilogue: bias, bf16 y, and the statistics of the f32 values
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const bool stats = flags & F_STATS;
  float* red = pipe.red();  // (2, 8 warps, BN) f32 over the halo stages
  consumer_sync();          // every warp is done reading the stages
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane & 3);
    const float b0 = bias[n0 + n];
    const float b1 = bias[n0 + n + 1];
    float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ww = w0 + m0 + 8 * half;
      if (ww < W) {
        const float v0 = acc[4 * j + 2 * half] + b0;
        const float v1 = acc[4 * j + 2 * half + 1] + b1;
        *reinterpret_cast<__nv_bfloat162*>(
            y + ((static_cast<size_t>(b) * H + h) * W + ww) * Cout + n0 + n) =
            __floats2bfloat162_rn(v0, v1);
        s0 += v0;
        s1 += v1;
        q0 += v0 * v0;
        q1 += v1 * v1;
      }
    }
    if (stats) {
      warp_column_pair(red + warp * BN, n, s0, s1);
      warp_column_pair(red + (8 + warp) * BN, n, q0, q1);
    }
  }
  if (stats) {
    consumer_sync();
    for (int n = threadIdx.x; n < BN; n += 256) {
      float s = 0.0f, q = 0.0f;
      for (int wp = 0; wp < 8; ++wp) {
        s += red[wp * BN + n];
        q += red[(8 + wp) * BN + n];
      }
      const size_t blk = static_cast<size_t>(b) * H * n_wtiles + static_cast<size_t>(seg);
      float* dst = partials + blk * 2 * Cout + n0 + n;
      dst[0] = s;
      dst[Cout] = q;
    }
  }
}

template <int BN, int KC>
int launch(const void* x, const void* wk, const float* bias, const float* aeff,
           const float* beff, const __nv_bfloat16* add, const __nv_bfloat16* te,
           __nv_bfloat16* y, float* partials, int B, int H, int W, int Cin, int Cout, int flags,
           cudaStream_t s) {
  using Cfg = Conv3x3<BN, KC>;
  CUtensorMap xmap, wmap;
  int err = encode_nhwc(&xmap, x, B, H, W, Cin, KC, Cfg::HALO, 3);
  if (err != 0) return err;
  err = encode_taps(&wmap, wk, Cout, Cin, KC, BN);
  if (err != 0) return err;
  auto kernel = conv_link_kernel<BN, KC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Cfg::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_wtiles = (W + Cfg::BM - 1) / Cfg::BM;
  dim3 grid(n_wtiles * H * (Cout / BN), B);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(xmap, wmap, bias, aeff, beff, add, te, y,
                                                partials, H, W, Cin, Cout, n_wtiles, flags);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int launch_n(const void* x, const void* wk, const float* bias, const float* aeff,
             const float* beff, const __nv_bfloat16* add, const __nv_bfloat16* te,
             __nv_bfloat16* y, float* partials, int B, int H, int W, int Cin, int Cout,
             int flags, cudaStream_t s) {
  if (Cout % 256 == 0)
    return launch<256, KC>(x, wk, bias, aeff, beff, add, te, y, partials, B, H, W, Cin, Cout,
                           flags, s);
  if (Cout % 64 == 0)
    return launch<64, KC>(x, wk, bias, aeff, beff, add, te, y, partials, B, H, W, Cin, Cout,
                          flags, s);
  if (Cout == 16)
    return launch<16, KC>(x, wk, bias, aeff, beff, add, te, y, partials, B, H, W, Cin, Cout,
                          flags, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int conv_link_block_pixels() { return Conv3x3<64, 64>::BM; }

// x, add: (B, H, W, Cin) bf16; wk: (3, 3, Cout, Cin) bf16, the link's
// weights with K (Cin) contiguous; bias: (Cout,) f32; aeff, beff: (B, Cin)
// f32; te: (B, Cin) bf16; y: (B, H, W, Cout) bf16; partials: (B, H *
// ceil(W / 128), 2, Cout) f32. x and wk 16-byte aligned. Unused pointers
// may be null when their flag is off. Returns cudaGetLastError() after the
// launch, or an error of csrc/conv3x3_sm90.cuh's encode_map.
extern "C" int conv_link_launch(const void* x, const void* wk, const void* bias,
                                const void* aeff, const void* beff, const void* add,
                                const void* te, void* y, void* partials, int B, int H, int W,
                                int Cin, int Cout, int flags, void* stream) {
  if (Cin % 16 != 0 || B <= 0 || H <= 0 || W <= 0 || B > 65535) return cudaErrorInvalidValue;
  const auto* bp = static_cast<const float*>(bias);
  const auto* ap = static_cast<const float*>(aeff);
  const auto* op = static_cast<const float*>(beff);
  const auto* dp = static_cast<const __nv_bfloat16*>(add);
  const auto* tp = static_cast<const __nv_bfloat16*>(te);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partials);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin % 64 == 0)
    return launch_n<64>(x, wk, bp, ap, op, dp, tp, yp, pp, B, H, W, Cin, Cout, flags, s);
  return launch_n<16>(x, wk, bp, ap, op, dp, tp, yp, pp, B, H, W, Cin, Cout, flags, s);
}
