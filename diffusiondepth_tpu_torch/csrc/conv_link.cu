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
// 256->256 links do 2*B*H*W*9*Cin*Cout = 1.01 TFLOP for ~0.5 GB of device
// memory traffic, ~2000 FLOP per byte, far above the card's ~295 FLOP/byte
// ridge: 1.02 ms of tensor-core operations at 989 TFLOP/s. Inside the card
// each of the 7040 blocks pulls every weight tile from L2 (fb: 8.30 GB of
// weights and 1.41 GB of halo a launch, 5.9 TB/s at 1.65 ms), yet L2 does
// not hold the links back (measured, H100 SXM at 700 W): without the
// products fb's loads and waits take 1.13-1.15 ms (8.4-8.6 TB/s from L2),
// and clock64() stamps gave a block 39.5K cycles of main loop for 36.9K of
// tensor-core work, 2.9K of them waiting for weight tiles. Sharing each
// weight tile over a cluster of two or four blocks (TMA multicast) was
// bit-equal and slower: each pair advances at its slower block's pace. The
// stamps found the time outside the tensor cores instead: each tap's
// products waited out before the next tap's operands were loaded (a
// 64-wide tile's main loop took 19.7K cycles for 9.2K of products), and an
// epilogue that overlaps nothing (one block an SM; 7.8K cycles of a 256-wide
// block without statistics, 18.4K with them).
//
// What the design does about it: the implicit GEMM of csrc/conv3x3_sm90.cuh
// (M = 128 output pixels of one row segment, N = the whole Cout up to 256,
// K = 9 taps x Cin in 64-channel chunks) on wgmma, fed by a TMA/mbarrier
// ring: two halo stages, each transformed in place once and used by all
// nine taps, and three (N = 256) or six weight stages. With N = 256 the
// halo of a row segment is staged and transformed once for all output
// channels. One producer warpgroup (one thread issues TMA) and two
// consumer warpgroups; where a block has the SM to itself one tap's
// products stay in flight while the next tap's weight tile is awaited and
// its operands are loaded. The epilogue adds the bias, stages y in shared
// memory and writes it in 16-byte stores along the rows, and reduces the
// statistics through shared memory: each thread stores its column sums
// over its two rows, then the 64 row groups are summed in a fixed order.
// Measured at the bs8 latent, from the warp-shuffle statistics, the 4-byte
// y stores and each tap waited out: ne1 1.02 -> 0.73 ms, fa 2.12 -> 1.98,
// fb 1.78 -> 1.65, pr0 0.75 -> 0.61. No atomics: two launches give the
// same bits. The caller sums the (B, n_blocks, 2, Cout) partials. The
// weights arrive as (3, 3, Cout, Cin) (K contiguous); the wrapper
// transposes them. T is computed on bf16 pairs (bf2_mul / bf2_add below:
// the same bits as the TPU kernel's f32 operations each rounded to bf16).
//
// Two kernels share that loop:
//
// - conv_link_kernel: untransformed links, transformed ones of one
//   64-channel chunk (ne1, pr1), and any flag set but the chains'. The
//   consumers transform each halo stage between its arrival and its first
//   tap (LinkTransform), the add map from global memory; registers moved
//   to the consumers with setmaxnreg.
// - conv_link_xf_kernel: links with the chains' transform (GroupNorm,
//   ReLU, the add map and te) over two or more 64-channel chunks into 64k
//   output channels (fa; the 'add' chain's pr0), chosen by xf_path from the
//   flags and the channels alone. The transform, compiled for those flags,
//   runs in warps of its own beside the tensor cores. Roles: the consumers (warps
//   0-7) only wait and multiply; warp 8's first thread issues the weight
//   tiles and, polling between them, each chunk's raw halo as soon as its
//   stage is free; warps 9-11 wait for the halo ("full"), apply T in place
//   piece by piece (half a halo row each), fence.proxy.async and arrive on
//   a "stage ready" mbarrier (96 arrivals) that the consumers wait on, so
//   chunk c + 1 is transformed while chunk c's nine taps run. The
//   consumers release a stage ("empty") as before. The products run in the
//   same (chunk, tap, k16) order and the epilogue is shared: y and the
//   partials equal the untransformed link's on the plainly transformed
//   input, bit for bit. Registers: consumers 192, the producer warpgroup
//   120 (2 x 128 x 192 + 128 x 120 = 384 x 168). Shared memory, measured
//   both ways on the H100 at the bs8 latent (8, 176, 608): at N = 256 the
//   ring takes 198,656 bytes and six add pieces (55,296) do not fit, so
//   the transform warps read the add map by 16-byte loads into registers,
//   a piece ahead (fa 1.94 ms; 2.06 with three TMA-fed add buffers in the
//   32 KB left); at N = 64 the ring takes 149,504 bytes and the add map
//   comes by TMA, six pieces in buffers of their own beside it (206,848
//   bytes in all; pr0 1.11 ms, against 1.22-1.28 with register loads).
//   What bounds a transformed link now: at N = 256 the taps (tensor cores
//   and the shared-memory reads of their operands), plus the first chunk's
//   transform, which nothing overlaps (fa 1.13-1.25x fb); at N = 64 the
//   transform warps themselves, whose taps take a fraction of a chunk's
//   transform (pr0 1.04-1.12 ms, the same link untransformed 0.74 ms).
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

// bf16 pair arithmetic, each operation rounded once (rn, never fused: a
// fused multiply-add rounds once for two operations and gives other bits).
// T's operands are all bf16 (x, the add map, te, and the affine rounded
// to bf16), so each f32 operation of the TPU kernel is exact or rounds
// only far below a bf16 step before its own rounding to bf16: one bf16
// operation gives the same bits (the product of two bf16 values is exact
// in f32 above 2^-126; a sum is exact when the exponents differ by at most
// 16, and otherwise rounds to the larger operand both ways).
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf2_relu(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// 16-byte shared-memory load and store at a shared-state-space address;
// the store only where p holds, predicated rather than branched around
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts128_if(bool p, uint32_t addr, const uint4& v) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " @q st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n}\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(static_cast<int>(p))
      : "memory");
}

// The per-(batch, channel) terms of T for the 8 channels [c, c + 8), as
// bf16 pairs: the affine is rounded to bf16 and te is bf16, so the pairs
// hold them exactly in half the registers.
struct UnitTerms {
  uint32_t ga[4], gb[4], tv[4];

  __device__ UnitTerms(const float* aeff, const float* beff, const __nv_bfloat16* te, int i,
                       int flags) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ga[k] = (flags & F_GN) ? pair(aeff[i + 2 * k], aeff[i + 2 * k + 1]) : 0x3F803F80u;
      gb[k] = (flags & F_GN) ? pair(beff[i + 2 * k], beff[i + 2 * k + 1]) : 0u;
      tv[k] = (flags & F_TE) ? *reinterpret_cast<const uint32_t*>(te + i + 2 * k) : 0u;
    }
  }

  __device__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
  }

  // T on one 16-byte unit of x (and of the add map), four bf16 pairs
  __device__ __forceinline__ uint4 operator()(const uint4& raw, const uint4& araw,
                                              int flags) const {
    uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
    const uint32_t t[4] = {araw.x, araw.y, araw.z, araw.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (flags & F_GN) v[k] = bf2_add(bf2_mul(v[k], ga[k]), gb[k]);
      if (flags & F_RELU) v[k] = bf2_relu(v[k]);
      if (flags & F_ADD) v[k] = bf2_add(v[k], (flags & F_TE) ? bf2_add(t[k], tv[k]) : t[k]);
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// T(x) in place on a halo stage, run by the consumers before the chunk's
// taps (the one-chunk links): per 16-byte unit of 8 channels, the
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
    const UnitTerms terms(aeff, beff, te, b * Cin + c, flags);
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
      for (int k = 0; k < U; ++k)
        if (ok[k]) *reinterpret_cast<uint4*>(A + off[k]) = terms(raw[k], araw[k], flags);
    }
  }
};

struct NoFlip {
  __device__ int operator()(int tap) const { return tap; }
};

// The epilogue of both kernels, in the 256 consumer threads: bias, bf16 y,
// and the statistics of the f32 values. y is staged in shared memory as
// rows of BN bf16 (each row's 16-byte units permuted by the row's low
// three bits, so that the eight rows a warp writes at once fall on
// distinct banks) and leaves in 16-byte stores along the rows: a row
// segment's BN channels are contiguous in y, the whole tile when BN =
// Cout. Straight from the fragments, each 4-byte store of a warp would
// touch eight pixels' rows, 16 bytes of each.
template <class Cfg>
__device__ __forceinline__ void link_epilogue(const Cfg& pipe, const float (&acc)[Cfg::BN / 2],
                                              const float* __restrict__ bias,
                                              __nv_bfloat16* __restrict__ y,
                                              float* __restrict__ partials, int b, int h,
                                              int w0, int n0, int seg, int H, int W, int Cout,
                                              int n_wtiles, int flags) {
  constexpr int BN = Cfg::BN;
  constexpr int UPR = BN / 8;  // 16-byte units of a staged row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
  const bool stats = flags & F_STATS;
  // a staged row's unit u sits at unit place(u, r) of row r
  auto place = [](int u, int r) { return UPR >= 8 ? u ^ (r & 7) : u; };
  const uint32_t ys = smem_u32(pipe.out_red());
  // each thread's column sums over its rows m0 and m0 + 8: row group
  // warp * 8 + lane / 4 of 64, then the 64 groups of the sums of squares,
  // Cfg::OUT_LD floats a group, over the ring
  constexpr int LD = Cfg::OUT_LD;
  float* const sums = pipe.out_tile();
  float* const mine = sums + (warp * 8 + (lane >> 2)) * LD;
  consumer_sync();  // every warp is done reading the stages
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane & 3);
    const float b0 = bias[n0 + n];
    const float b1 = bias[n0 + n + 1];
    float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + 8 * half;
      const float v0 = acc[4 * j + 2 * half] + b0;
      const float v1 = acc[4 * j + 2 * half + 1] + b1;
      const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
      sts32(ys + r * (BN * 2) + place(j, r) * 16 + 4 * (lane & 3),
            *reinterpret_cast<const uint32_t*>(&p));
      if (w0 + r < W) {
        s0 += v0;
        s1 += v1;
        q0 += v0 * v0;
        q1 += v1 * v1;
      }
    }
    if (stats) {
      *reinterpret_cast<float2*>(mine + n) = make_float2(s0, s1);
      *reinterpret_cast<float2*>(mine + 64 * LD + n) = make_float2(q0, q1);
    }
  }
  consumer_sync();
  {
    const int units = min(Cfg::BM, W - w0) * UPR;
    __nv_bfloat16* const yt = y + ((static_cast<size_t>(b) * H + h) * W + w0) * Cout + n0;
#pragma unroll 4
    for (int i = threadIdx.x; i < units; i += 256) {
      const int r = i / UPR, u = i % UPR;
      *reinterpret_cast<uint4*>(yt + static_cast<size_t>(r) * Cout + u * 8) =
          lds128(ys + r * (BN * 2) + place(u, r) * 16);
    }
  }
  if (!stats) return;
  // the 64 groups in order: P threads a column each sum 64 / P of them,
  // then the first BN threads sum the P parts in order
  constexpr int P = 256 / BN;
  const int n = threadIdx.x % BN;
  const int part = threadIdx.x / BN;
  float s = 0.0f, q = 0.0f;
#pragma unroll 8
  for (int g = part * (64 / P); g < (part + 1) * (64 / P); ++g) {
    s += sums[g * LD + n];
    q += sums[(64 + g) * LD + n];
  }
  if constexpr (P > 1) {
    consumer_sync();  // every thread has read its groups
    sums[part * BN + n] = s;
    sums[(P + part) * BN + n] = q;
    consumer_sync();
    if (part != 0) return;
    s = q = 0.0f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      s += sums[k * BN + n];
      q += sums[(P + k) * BN + n];
    }
  }
  const size_t blk = static_cast<size_t>(b) * H * n_wtiles + static_cast<size_t>(seg);
  float* dst = partials + blk * 2 * Cout + n0 + n;
  dst[0] = s;
  dst[Cout] = q;
}

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
  link_epilogue(pipe, acc, bias, y, partials, b, h, w0, n0, seg, H, W, Cout, n_wtiles, flags);
}

// ---------------------------------------------------------------------------
// the transformed links' path: T in warps of its own
// ---------------------------------------------------------------------------

// The flags of the links that take this path in the chains (fa, the 'add'
// chain's pr0): the only transform it is compiled for
constexpr int XF_CHAIN = F_GN | F_RELU | F_ADD | F_TE;

// Conv3x3<BN, 64>'s ring and barriers, then a "stage ready" barrier per
// halo stage. The transform warps take a halo stage in pieces of one halo
// row's half (65 pixels); each thread always handles the same 8 channels
// of a chunk. The add map comes one of two ways (measured; see the head
// of this file): where a chunk's six pieces of it fit beside the ring
// (BN = 64), by TMA into buffers of their own, each with a "full"
// barrier; else (BN = 256) by 16-byte loads into registers, a piece ahead.
template <int BN_>
struct XfPipe : Conv3x3<BN_, 64> {
  using Base = Conv3x3<BN_, 64>;
  using Base::BAR_OFF;
  using Base::HALO;
  using Base::NB;
  using Base::RB;
  static constexpr int PIECE_PX = HALO / 2;
  static constexpr int PIECES = 6;  // a chunk's halo: 3 rows x 2 halves
  static constexpr int KV = 64 / 8;  // 16-byte units per halo pixel
  static constexpr int UNITS = PIECE_PX * KV;  // units per piece
  static constexpr uint32_t PIECE_BYTES = PIECE_PX * RB;
  static constexpr uint32_t PIECE_STRIDE = (PIECE_BYTES + 1023) / 1024 * 1024;
  static constexpr uint32_t XBAR_OFF = BAR_OFF + 8 * (4 + 2 * NB);
  static constexpr uint32_t ADD_OFF = (XBAR_OFF + 8 * (2 + PIECES) + 1023) / 1024 * 1024;
  static constexpr bool ADD_TMA = ADD_OFF + PIECES * PIECE_STRIDE + 1024 <= 232448;
  static constexpr uint32_t SMEM =
      ADD_TMA ? ADD_OFF + PIECES * PIECE_STRIDE + 1024 : XBAR_OFF + 8 * 2 + 1024;
  // warps 8-11: warp 8's first thread issues the TMA loads, warps 9-11
  // transform. The registers of the consumers and of that warpgroup
  // (setmaxnreg) sum to the 384 x 168 the launch bound gives.
  static constexpr int XF_THREADS = 96;
  static constexpr int PER = (UNITS + XF_THREADS - 1) / XF_THREADS;  // units a thread, a piece
  static constexpr int CONSUMER_REGS = 192, PRODUCER_REGS = 120;
  static_assert(256 * CONSUMER_REGS + 128 * PRODUCER_REGS == 384 * 168, "register split");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(PIECE_PX * 2 == HALO && XF_THREADS % KV == 0, "pieces");

  __device__ explicit XfPipe(uint8_t* raw) : Base(raw) {}

  __device__ uint64_t* a_ready(int i) const {
    return reinterpret_cast<uint64_t*>(this->base + XBAR_OFF) + i;
  }

  __device__ uint64_t* add_full(int i) const {
    return reinterpret_cast<uint64_t*>(this->base + XBAR_OFF) + 2 + i;
  }
  __device__ uint32_t add_buf(int i) const {
    return smem_u32(this->base + ADD_OFF + i * PIECE_STRIDE);
  }

  __device__ void init() const {
    Base::init();
    for (int i = 0; i < 2; ++i) mbar_init(a_ready(i), XF_THREADS);
    if (ADD_TMA)
      for (int i = 0; i < PIECES; ++i) mbar_init(add_full(i), 1);
    mbar_init_fence();
  }

  // The producer thread: the weight tiles in (chunk, tap) order as
  // Conv3x3::produce loads them, and each chunk's raw halo as soon as its
  // stage is free: it polls for that while it waits for a weight stage,
  // so the transform of chunk c + 1 need not wait for chunk c's last
  // weight tiles.
  __device__ void produce(const CUtensorMap* xmap, const CUtensorMap* wmap, int b, int h,
                          int w0, int n0, int n_chunks) const {
    int cx = 0;  // the next chunk whose halo is to be loaded
    auto load_x = [&]() {
      const int a = cx & 1;
      mbar_expect_tx(this->a_full(a), Base::A_BYTES);
      tma_load_4d(this->a_stage(a), xmap, this->a_full(a), cx * 64, w0 - 1, h - 1, b);
      ++cx;
    };
    auto x_free = [&]() {
      return cx < n_chunks && mbar_test(this->a_empty(cx & 1), ((cx >> 1) & 1) ^ 1);
    };
    for (int i = 0; i < n_chunks * 9; ++i) {
      const int s = i % NB;
      const uint32_t parity = ((i / NB) & 1) ^ 1;
      while (!mbar_test(this->b_empty(s), parity))
        if (x_free()) load_x();
      if (x_free()) load_x();
      mbar_expect_tx(this->b_full(s), Base::B_BYTES);
      tma_load_3d(this->b_stage(s), wmap, this->b_full(s), (i / 9) * 64, n0, i % 9);
    }
    while (cx < n_chunks) {
      mbar_wait(this->a_empty(cx & 1), ((cx >> 1) & 1) ^ 1);
      load_x();
    }
  }

  // The consumers: each chunk's taps once the transform warps have
  // published its stage.
  __device__ void consume(float (&acc)[BN_ / 2], int n_chunks) const {
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(a_ready(c & 1), (c >> 1) & 1);
      this->taps(acc, c);
    }
  }

  // This thread's add-map units of piece j of chunk c into registers
  // (16-byte loads, all issued before any is used); the units outside the
  // image are never read.
  __device__ __forceinline__ void load_add(uint4 (&d)[PER], const __nv_bfloat16* add, int c,
                                           int j, int t, int b, int h, int w0, int H, int W,
                                           int Cin) const {
    const int hh = h + (j >> 1) - 1;
    const int wl = w0 - 1 + (j & 1) * PIECE_PX;
    if (hh < 0 || hh >= H) return;
    const __nv_bfloat16* row = add + (static_cast<size_t>(b) * H + hh) * W * Cin + c * 64 +
                               (t % KV) * 8;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = t + XF_THREADS * i;
      const int ww = wl + u / KV;
      if ((i + 1 < PER || u < UNITS) && ww >= 0 && ww < W)
        d[i] = __ldg(reinterpret_cast<const uint4*>(row + static_cast<size_t>(ww) * Cin));
    }
  }

  // T in place on this thread's units of a piece, the add map from the
  // piece's buffer D (ADD_TMA) or from registers. Straight-line code: all
  // of the thread's loads (a unit left as it is reads unit 0's place), then
  // T and predicated stores of the units to transform. A piece on the
  // image's left or right edge also checks each unit's column (the TMA zero
  // fill stays outside). Measured (H100, bs8 latent): the 'add' pr0 link
  // took 4-6% longer when the units' loads and stores were branched around.
  template <bool INSIDE>
  __device__ __forceinline__ void piece(uint32_t A, uint32_t D, const uint4 (&ad)[PER],
                                        const UnitTerms& terms, int t, int r, int p0, int wl,
                                        int W) const {
    constexpr int HALF = (PER + 1) / 2;  // units loaded together: half the registers
    // unit i's pixel in the piece, whether it is to be transformed, and
    // its halo-stage offset (recomputed rather than held in registers)
    auto px = [&](int i) { return (t + XF_THREADS * i) / KV; };
    auto ok = [&](int i) {
      return i < PER && (i + 1 < PER || t + XF_THREADS * i < UNITS) &&
             (INSIDE || (wl + px(i) >= 0 && wl + px(i) < W));
    };
    auto off = [&](int i) { return swz<RB>((r * HALO + p0 + px(i)) * RB + (t % KV) * 16); };
#pragma unroll
    for (int i0 = 0; i0 < PER; i0 += HALF) {
      uint4 raw[HALF], araw[HALF];
#pragma unroll
      for (int q = 0; q < HALF; ++q) {
        const int i = ok(i0 + q) ? i0 + q : 0;
        raw[q] = lds128(A + off(i));
        if (ADD_TMA) araw[q] = lds128(D + swz<RB>(px(i) * RB + (t % KV) * 16));
      }
#pragma unroll
      for (int q = 0; q < HALF; ++q)
        sts128_if(ok(i0 + q), A + off(i0 + q),
                  terms(raw[q], ADD_TMA ? araw[q] : ad[i0 + q < PER ? i0 + q : 0], XF_CHAIN));
    }
  }

  // The transform warps: per chunk, wait for the raw halo, then T on it
  // in place piece by piece; then fence.proxy.async and arrive on "stage
  // ready". The add map: with ADD_TMA the first of these threads keeps six
  // pieces of it in flight, refilling a buffer once all have read it;
  // else the next piece's loads are issued before this piece's T.
  __device__ void transform(const CUtensorMap* amap, const __nv_bfloat16* add,
                            const float* aeff, const float* beff, const __nv_bfloat16* te,
                            int b, int h, int w0, int H, int W, int Cin, int n_chunks) const {
    const int t = threadIdx.x - (384 - XF_THREADS);
    const int ch = b * Cin + (t % KV) * 8;  // this thread's first channel of chunk 0
    const int total = n_chunks * PIECES;
    auto issue = [&](int k) {  // piece k of the add map into buffer k % PIECES by TMA
      const int j = k % PIECES;
      mbar_expect_tx(add_full(j), PIECE_BYTES);
      tma_load_4d(this->base + ADD_OFF + j * PIECE_STRIDE, amap, add_full(j), (k / PIECES) * 64,
                  w0 - 1 + (j & 1) * PIECE_PX, h + (j >> 1) - 1, b);
    };
    uint4 next[PER];
    if (ADD_TMA) {
      if (t == 0)
        for (int k = 0; k < PIECES && k < total; ++k) issue(k);
    } else {
      load_add(next, add, 0, 0, t, b, h, w0, H, W, Cin);
    }
    for (int c = 0; c < n_chunks; ++c) {
      const UnitTerms terms(aeff, beff, te, ch + c * 64, XF_CHAIN);
      const int a = c & 1;
      const uint32_t A = smem_u32(this->a_stage(a));
      mbar_wait(this->a_full(a), (c >> 1) & 1);
      for (int j = 0; j < PIECES; ++j) {
        const int k = c * PIECES + j;
        uint4 cur[PER];
        if (ADD_TMA) {
          mbar_wait(add_full(j), (k / PIECES) & 1);
        } else {
#pragma unroll
          for (int i = 0; i < PER; ++i) cur[i] = next[i];
          if (k + 1 < total)
            load_add(next, add, (k + 1) / PIECES, (k + 1) % PIECES, t, b, h, w0, H, W, Cin);
        }
        const int hh = h + (j >> 1) - 1;
        const int wl = w0 - 1 + (j & 1) * PIECE_PX;  // the piece's first image column
        if (hh >= 0 && hh < H) {
          if (wl >= 0 && wl + PIECE_PX <= W)
            piece<true>(A, add_buf(j), cur, terms, t, j >> 1, (j & 1) * PIECE_PX, wl, W);
          else
            piece<false>(A, add_buf(j), cur, terms, t, j >> 1, (j & 1) * PIECE_PX, wl, W);
        }
        if (ADD_TMA) {
          named_sync<2, XF_THREADS>();  // every transform thread is done with buffer j
          if (t == 0 && k + PIECES < total) issue(k + PIECES);
        }
      }
      fence_proxy_async();
      mbar_arrive(a_ready(a));
    }
  }
};

template <int BN, int KC>
__global__ void __launch_bounds__(384, 1) conv_link_xf_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap amap, const float* __restrict__ bias,
    const float* __restrict__ aeff, const float* __restrict__ beff,
    const __nv_bfloat16* __restrict__ add, const __nv_bfloat16* __restrict__ te,
    __nv_bfloat16* __restrict__ y, float* __restrict__ partials, int H, int W, int Cin,
    int Cout, int n_wtiles, int flags) {
  static_assert(KC == 64, "64-channel chunks");
  using Pipe = XfPipe<BN>;
  extern __shared__ uint8_t smem_raw[];
  const Pipe pipe(smem_raw);
  const int nz = Cout / BN;
  const int n0 = (blockIdx.x % nz) * BN;
  const int seg = blockIdx.x / nz;
  const int h = seg / n_wtiles;
  const int w0 = (seg % n_wtiles) * Pipe::BM;
  const int b = blockIdx.y;
  const int n_chunks = Cin / KC;

  if (threadIdx.x == 0) pipe.init();
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warpgroup: loads and the transform
    setmaxnreg_dec<Pipe::PRODUCER_REGS>();
    if (threadIdx.x == 256)
      pipe.produce(&xmap, &wmap, b, h, w0, n0, n_chunks);
    else if (threadIdx.x >= 384 - Pipe::XF_THREADS)
      pipe.transform(&amap, add, aeff, beff, te, b, h, w0, H, W, Cin, n_chunks);
    return;
  }
  setmaxnreg_inc<Pipe::CONSUMER_REGS>();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  pipe.consume(acc, n_chunks);
  link_epilogue(pipe, acc, bias, y, partials, b, h, w0, n0, seg, H, W, Cout, n_wtiles, flags);
}

// Whether a link takes conv_link_xf_kernel: its input takes the chains'
// transform (XF_CHAIN), it has at least two 64-channel chunks (so one
// chunk's transform can run beside another's taps) and 64k output channels.
bool xf_path(int Cin, int Cout, int flags) {
  return (flags & XF_CHAIN) == XF_CHAIN && Cin % 64 == 0 && Cin >= 128 && Cout % 64 == 0;
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
  const int n_wtiles = (W + Cfg::BM - 1) / Cfg::BM;
  dim3 grid(n_wtiles * H * (Cout / BN), B);
  cudaError_t e;
  if constexpr (KC == 64 && BN >= 64) {
    if (xf_path(Cin, Cout, flags)) {
      using Pipe = XfPipe<BN>;
      CUtensorMap amap = xmap;  // unused unless the add map comes by TMA
      if (Pipe::ADD_TMA) {
        err = encode_nhwc(&amap, add, B, H, W, Cin, KC, Pipe::PIECE_PX, 1);
        if (err != 0) return err;
      }
      auto kernel = conv_link_xf_kernel<BN, KC>;
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Pipe::SMEM));
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<grid, Cfg::THREADS, Pipe::SMEM, s>>>(xmap, wmap, amap, bias, aeff, beff, add, te,
                                                     y, partials, H, W, Cin, Cout, n_wtiles,
                                                     flags);
      return static_cast<int>(cudaGetLastError());
    }
  }
  auto kernel = conv_link_kernel<BN, KC>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Cfg::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
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

// 1 when a launch with these channels and flags takes conv_link_xf_kernel
extern "C" int conv_link_xf_path(int Cin, int Cout, int flags) {
  return xf_path(Cin, Cout, flags) ? 1 : 0;
}

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
