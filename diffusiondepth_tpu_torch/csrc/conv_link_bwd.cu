// The backward of one link of the denoiser conv chain on Hopper (kernel K5
// of the port).
//
// Replaces the TPU kernel diffusiondepth_tpu/ops/fused_denoiser.py
// _bwd_link_kernel (:732, reached through _bwd_link, chained by
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
// What the design does about it: three launches, no float atomics (two
// launches on the same inputs give the same bits).
//  1. data_grad_kernel: K1's wgmma implicit GEMM (csrc/conv3x3_sm90.cuh)
//     on du, N = Cin (the whole 256 where it is 256), K = 9 taps x Cout.
//     The weights are read as they are, (3, 3, Cin, Cout) with K
//     contiguous: the flip is the tap order of the TMA loads. Its
//     prologue hook assembles du in place in the halo stage from r and
//     u_out, and writes du out once (centre row, first channel block) for
//     pass 2. Its epilogue stages
//     the f32 tile in shared memory and walks it in 16-byte units of 8
//     channels: reads u_in (and add), applies the ReLU / GroupNorm-in
//     masking, writes t, d(add) and T(u_in) (for pass 2) as whole
//     vectors, and sums the GroupNorm partials per thread, then over the
//     threads of a channel group in a fixed order.
//  2. weight_grad_kernel: dW_tap = T(u_in)_shifted^T du, M = a 64-channel
//     tile of Cin, N = a 64-channel tile of Cout, K = pixels. A block
//     stages each 64-pixel chunk of du and the matching 3-row halo of
//     T(u_in) once, through a five-stage TMA/mbarrier ring, and uses it for
//     all nine taps: three consumer warpgroups, one per tap row, each
//     holding three accumulators (the column taps). T(u_in)^T reaches
//     wgmma from registers (ldmatrix.trans through the swizzle, at any
//     column shift); du is wgmma's N-major B in shared memory. The pixels
//     are split over a fixed number of ranges (about one block per SM in
//     all); each range writes its partial dW, and its dbias (the du column
//     sums, by the tap row 1 warpgroup of the first Cin tile).
//  3. reduce_kernel sums the partials over the ranges in a fixed order.
// Each map is read once per channel tile of the other operand, where the
// previous design read it once per tap and tile.
//
// The 16-wide links run the same kernels: in pass 1, ne0 (Cin = 16) with
// m64n16 wgmma and pr1 (Cout = 16) with 16-channel chunks, two blocks per
// SM; in pass 2, a 16-wide Cout tile with m64n16 wgmma on 32-byte swizzled
// rows, and a 16-wide Cin tile (ne0) with zero A fragments in three of the
// four warps of each warpgroup (4x the work of a 16-row tile, on ~0.6% of
// the chain's operations). They are bound by moving their maps and by the
// pipeline's fill per block.

#include "conv3x3_sm90.cuh"

namespace {

using namespace sm90;

constexpr int F_GN_NEXT = 1, F_GN_IN = 2, F_ADD = 4, F_TE = 8;

// ---------------------------------------------------------------------------
// 1. data gradient: dv = conv3x3(du, flipped weights), du assembled in place
// ---------------------------------------------------------------------------

// du from r in place on the in-image units of a halo stage (the TMA zero
// fill stays for the others: the transposed conv pads du with zeros); the
// first channel block of a segment also writes its centre row out.
template <class Cfg>
struct DuTransform {
  bool active;
  const __nv_bfloat16* un;
  const float* cnext;
  __nv_bfloat16* du_out;
  int b, h, w0, n0, H, W, Cr;

  __device__ void operator()(uint8_t* A, int chunk) const {
    constexpr int KV = Cfg::KC / 8;
    static_assert(256 % KV == 0, "fixed channels per thread");
    const int kv = threadIdx.x % KV;
    const int c = chunk * Cfg::KC + kv * 8;
    float inv[8], mean[8], m1[8], m2[8];
    const float* cb = cnext + static_cast<size_t>(b) * 8 * Cr + c;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      inv[k] = rbf(cb[k]);
      mean[k] = rbf(cb[Cr + k]);
      m1[k] = rbf(cb[2 * Cr + k]);
      m2[k] = rbf(cb[3 * Cr + k]);
    }
    // U units per round: their loads (u_out's from global memory) are all
    // issued before the first is used; the narrow tiles, at the registers
    // of two blocks per SM, take one
    constexpr int U = Cfg::MIN_BLOCKS == 1 ? 4 : 1;
    constexpr int TOTAL = 3 * Cfg::HALO * KV;
    for (int u0 = threadIdx.x; u0 < TOTAL; u0 += 256 * U) {
      uint4 raw[U], xraw[U];
      uint32_t off[U];
      size_t g[U];
      bool ok[U], centre[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int u = u0 + 256 * k;
        const int row = u / KV;
        const int r = row / Cfg::HALO;
        const int p = row % Cfg::HALO;
        const int hh = h + r - 1;
        const int ww = w0 + p - 1;
        ok[k] = u < TOTAL && hh >= 0 && hh < H && ww >= 0 && ww < W;
        centre[k] = r == 1 && p >= 1 && p <= Cfg::BM && n0 == 0;
        off[k] = swz<Cfg::RB>(row * Cfg::RB + kv * 16);
        g[k] = ((static_cast<size_t>(b) * H + hh) * W + ww) * Cr + c;
        if (ok[k]) {
          raw[k] = *reinterpret_cast<const uint4*>(A + off[k]);
          xraw[k] = *reinterpret_cast<const uint4*>(un + g[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (!ok[k]) continue;
        float v[8], x[8];
        unpack8(raw[k], v);
        unpack8(xraw[k], x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = rbf(rbf(x[e] - mean[e]) * inv[e]);
          v[e] = rbf(rbf(rbf(v[e] - m1[e]) - rbf(xh * m2[e])) * inv[e]);
        }
        const uint4 packed = pack8(v);
        *reinterpret_cast<uint4*>(A + off[k]) = packed;
        if (centre[k]) *reinterpret_cast<uint4*>(du_out + g[k]) = packed;
      }
    }
  }
};

// the transposed conv reads weight tap 8 - tap: the flip
struct Flip {
  __device__ int operator()(int tap) const { return 8 - tap; }
};

// r, un: (B, H, W, Cr) bf16 through rmap and un; w: (3, 3, Ci, Cr) bf16
// through wmap; cnext: (B, 8, Cr) f32 [inv, mean, m1, m2, ...]; u: (B, H,
// W, Ci) bf16; cin: (B, 8, Ci) f32 [aeff, beff, inv, mean, scale, ...];
// add: (B, H, W, Ci); te: (B, Ci).
template <int BN, int KC>
__global__ void __launch_bounds__(384, (Conv3x3<BN, KC>::MIN_BLOCKS)) data_grad_kernel(
    const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap wmap,
    const __nv_bfloat16* __restrict__ un, const float* __restrict__ cnext,
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ cin,
    const __nv_bfloat16* __restrict__ add, const __nv_bfloat16* __restrict__ te,
    __nv_bfloat16* __restrict__ t_out, __nv_bfloat16* __restrict__ da,
    __nv_bfloat16* __restrict__ v_out, __nv_bfloat16* __restrict__ du_out,
    float* __restrict__ partials, int H, int W, int Cr, int Ci, int n_wtiles, int flags) {
  using Cfg = Conv3x3<BN, KC>;
  extern __shared__ uint8_t smem_raw[];
  const Cfg pipe(smem_raw);
  const int nz = Ci / BN;
  const int n0 = (blockIdx.x % nz) * BN;
  const int seg = blockIdx.x / nz;
  const int h = seg / n_wtiles;
  const int w0 = (seg % n_wtiles) * Cfg::BM;
  const int b = blockIdx.y;
  const int n_chunks = Cr / KC;
  const bool transform = flags & F_GN_NEXT;
  DuTransform<Cfg> tr{transform, un, cnext, du_out, b, h, w0, n0, H, W, Cr};

  if (threadIdx.x == 0) pipe.init();
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warpgroup
    Cfg::producer_regs();
    if (threadIdx.x == 256)
      pipe.produce(&rmap, &wmap, b, h, w0, n0, n_chunks, Flip{});
    return;
  }
  Cfg::consumer_regs();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  pipe.consume(acc, n_chunks, tr);

  // epilogue: the f32 tile goes through shared memory, then each thread
  // takes 16-byte units of 8 channels (fixed per thread) down the rows
  const bool gn_in = flags & F_GN_IN;
  constexpr int LD = Cfg::OUT_LD;
  constexpr int UPR = BN / 8;     // units per row
  constexpr int G = 256 / UPR;    // rows taken at once
  float* tile = pipe.out_tile();
  float* red = pipe.out_red();  // (2, G, BN)
  consumer_sync();  // every warp is done reading the stages
  {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int m0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(tile + (m0 + 8 * half) * LD + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  }
  consumer_sync();
  const int kv = threadIdx.x % UPR;
  const int r0 = threadIdx.x / UPR;
  const int c = n0 + kv * 8;
  float ain[8], bin[8], inv_i[8], mean_i[8], scale[8], tv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float* cb = cin + static_cast<size_t>(b) * 8 * Ci + c + e;
    ain[e] = gn_in ? rbf(cb[0]) : 0.f;
    bin[e] = gn_in ? rbf(cb[Ci]) : 0.f;
    inv_i[e] = gn_in ? rbf(cb[2 * Ci]) : 0.f;
    mean_i[e] = gn_in ? rbf(cb[3 * Ci]) : 0.f;
    scale[e] = gn_in ? rbf(cb[4 * Ci]) : 0.f;
    tv[e] = (flags & F_TE) ? __bfloat162float(te[b * Ci + c + e]) : 0.f;
  }
  float s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
  for (int m = r0; m < Cfg::BM && w0 + m < W; m += G) {
    const size_t g = ((static_cast<size_t>(b) * H + h) * W + w0 + m) * Ci + c;
    const float4 d0 = *reinterpret_cast<const float4*>(tile + m * LD + kv * 8);
    const float4 d1 = *reinterpret_cast<const float4*>(tile + m * LD + kv * 8 + 4);
    const float dv[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    float v[8], t[8], av[8];
    unpack8(*reinterpret_cast<const uint4*>(u + g), v);
    if (flags & F_ADD) unpack8(*reinterpret_cast<const uint4*>(add + g), av);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (gn_in) {
        const float pre = rbf(rbf(v[e] * ain[e]) + bin[e]);
        t[e] = pre > 0.0f ? rbf(rbf(dv[e]) * scale[e]) : 0.0f;
        s[e] += t[e];
        q[e] += rbf(t[e] * rbf(rbf(v[e] - mean_i[e]) * inv_i[e]));
        v[e] = fmaxf(pre, 0.0f);
      } else {
        t[e] = dv[e];
      }
      if (flags & F_ADD) {
        v[e] = rbf(v[e] + av[e]);
        if (flags & F_TE) v[e] = rbf(v[e] + tv[e]);
      }
    }
    *reinterpret_cast<uint4*>(t_out + g) = pack8(t);
    if (flags & F_ADD) *reinterpret_cast<uint4*>(da + g) = pack8(dv);
    if (flags & (F_GN_IN | F_ADD)) *reinterpret_cast<uint4*>(v_out + g) = pack8(v);
  }
  if (gn_in) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[r0 * BN + kv * 8 + e] = s[e];
      red[(G + r0) * BN + kv * 8 + e] = q[e];
    }
    consumer_sync();
    for (int n = threadIdx.x; n < BN; n += 256) {
      float ss = 0.0f, qq = 0.0f;
      for (int gr = 0; gr < G; ++gr) {
        ss += red[gr * BN + n];
        qq += red[(G + gr) * BN + n];
      }
      const size_t blk = static_cast<size_t>(b) * H * n_wtiles + static_cast<size_t>(seg);
      float* dst = partials + blk * 2 * Ci + n0 + n;
      dst[0] = ss;
      dst[Ci] = qq;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. weight gradient: partial dW per range of pixel chunks
// ---------------------------------------------------------------------------

template <int CI_T, int CO_T>
struct WGrad {
  static constexpr int KP = 64;        // pixels per chunk, along one image row
  static constexpr int HALO = KP + 2;  // T(u_in) pixels per halo row
  static constexpr int RV = CI_T * 2;  // bytes per staged T(u_in) pixel
  static constexpr int RD = CO_T * 2;  // bytes per staged du pixel
  static constexpr int NS = 5;         // stages
  static constexpr int THREADS = 512;  // three consumer warpgroups, one producer
  static constexpr uint32_t V_BYTES = 3 * HALO * RV;
  static constexpr uint32_t D_BYTES = KP * RD;
  static constexpr uint32_t V_STRIDE = (V_BYTES + 1023) / 1024 * 1024;
  static constexpr uint32_t STAGE = V_STRIDE + (D_BYTES + 1023) / 1024 * 1024;
  static constexpr uint32_t BAR_OFF = NS * STAGE;
  static constexpr uint32_t DB_OFF = BAR_OFF + 16 * NS;  // 128 f32 of dbias sums
  static constexpr uint32_t SMEM = DB_OFF + 512 + 1024;
  static constexpr int DB_GROUPS = 128 / CO_T;  // row groups of the dbias sums
  static_assert(SMEM <= 232448, "shared memory");
};

// vmap: T(u_in) (B, H, W, Ci) bf16, boxes (1, 3, 66, CI_T); dmap: du (B, H,
// W, Co) bf16, boxes (1, 1, 64, CO_T). dwp: (n_split, 9, Ci, Co) f32;
// dbp: (n_split, Co) f32.
template <int CI_T, int CO_T>
__global__ void __launch_bounds__(512, 1) weight_grad_kernel(
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
    float* __restrict__ dwp, float* __restrict__ dbp, int H, int Ci, int Co, int n_wt,
    int n_chunks, int per_split) {
  using Cfg = WGrad<CI_T, CO_T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Cfg::BAR_OFF);
  uint64_t* empty = full + Cfg::NS;
  const int nco = Co / CO_T;
  const int ci0 = (blockIdx.x / nco) * CI_T;
  const int co0 = (blockIdx.x % nco) * CO_T;
  const int split = blockIdx.y;
  const int k0 = split * per_split;
  const int k1 = min(n_chunks, k0 + per_split);

  if (threadIdx.x == 0) {
    for (int i = 0; i < Cfg::NS; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 12);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= 384) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 384) {
      for (int k = k0; k < k1; ++k) {
        const int it = k - k0;
        const int s = it % Cfg::NS;
        const int b = k / (H * n_wt);
        const int h = (k / n_wt) % H;
        const int w0 = (k % n_wt) * Cfg::KP;
        uint8_t* st = base + s * Cfg::STAGE;
        mbar_wait(empty + s, ((it / Cfg::NS) & 1) ^ 1);
        mbar_expect_tx(full + s, Cfg::V_BYTES + Cfg::D_BYTES);
        tma_load_4d(st, &vmap, full + s, ci0, w0 - 1, h - 1, b);
        tma_load_4d(st + Cfg::V_STRIDE, &dmap, full + s, co0, w0, h, b);
      }
    }
    return;
  }
  setmaxnreg_inc<152>();

  const int dr = threadIdx.x >> 7;  // this warpgroup's tap row
  const int wq = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // ldmatrix.trans: lane addresses row k_off of matrix lane / 8, whose
  // 8 channels are the 16-byte unit ci_unit of the pixel
  const int k_off = ((lane >> 4) << 3) + (lane & 7);
  const int ci_unit = 2 * wq + ((lane >> 3) & 1);
  const bool a_live = CI_T == 64 || wq == 0;  // a 16-wide tile: warp 0's rows only
  const bool do_db = dr == 1 && ci0 == 0;
  const int db_col = (threadIdx.x & 127) % CO_T;
  const int db_grp = (threadIdx.x & 127) / CO_T;
  constexpr int DB_ROWS = Cfg::KP / Cfg::DB_GROUPS;
  float dbs = 0.0f;

  float acc[3][CO_T / 2];
#pragma unroll
  for (int dc = 0; dc < 3; ++dc)
#pragma unroll
    for (int i = 0; i < CO_T / 2; ++i) acc[dc][i] = 0.0f;

  for (int k = k0; k < k1; ++k) {
    const int it = k - k0;
    const int s = it % Cfg::NS;
    mbar_wait(full + s, (it / Cfg::NS) & 1);
    const uint8_t* st = base + s * Cfg::STAGE;
    const uint32_t v_addr = smem_u32(st);
    const uint32_t d_addr = smem_u32(st + Cfg::V_STRIDE);
#pragma unroll
    for (int ks = 0; ks < Cfg::KP / 16; ++ks) {
      uint32_t af[3][4];
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        if (a_live) {
          const uint32_t row = dr * Cfg::HALO + ks * 16 + dc + k_off;
          ldmatrix_x4_trans(af[dc], v_addr + swz<Cfg::RV>(row * Cfg::RV + ci_unit * 16));
        } else {
          af[dc][0] = af[dc][1] = af[dc][2] = af[dc][3] = 0u;
        }
      }
      const uint64_t desc =
          make_desc<Cfg::RD>(d_addr + ks * 16 * Cfg::RD, Cfg::KP * Cfg::RD, 8 * Cfg::RD);
      wgmma_fence();
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) wgmma_m64k16<CO_T, 1>(acc[dc], af[dc], desc);
      wgmma_commit();
      wgmma_wait_all();
    }
    if (do_db) {
      for (int rr = 0; rr < DB_ROWS; ++rr) {
        const int kr = db_grp * DB_ROWS + rr;
        dbs += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
            st + Cfg::V_STRIDE + swz<Cfg::RD>(kr * Cfg::RD + (db_col >> 3) * 16) +
            (db_col & 7) * 2));
      }
    }
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int dc = 0; dc < 3; ++dc) {
    const int tap = dr * 3 + dc;
#pragma unroll
    for (int i = 0; i < CO_T / 2; i += 2) {
      const int ci = wq * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int co = 8 * (i >> 2) + 2 * (lane & 3);
      if (ci < CI_T)
        *reinterpret_cast<float2*>(
            dwp + ((static_cast<size_t>(split) * 9 + tap) * Ci + ci0 + ci) * Co + co0 + co) =
            make_float2(acc[dc][i], acc[dc][i + 1]);
    }
  }
  if (do_db) {
    float* dbsum = reinterpret_cast<float*>(base + Cfg::DB_OFF);
    dbsum[db_grp * CO_T + db_col] = dbs;
    asm volatile("bar.sync 2, 128;\n" ::: "memory");  // warpgroup 1 only
    if ((threadIdx.x & 127) < CO_T) {
      float t = 0.0f;
      for (int g = 0; g < Cfg::DB_GROUPS; ++g) t += dbsum[g * CO_T + db_col];
      dbp[static_cast<size_t>(split) * Co + co0 + db_col] = t;
    }
  }
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

constexpr int SMS = 132;  // the H100 SXM's SMs: the weight pass fills them once

int tile(int c) { return c % 64 == 0 ? 64 : 16; }

int pixel_chunks(int B, int H, int W) {
  return B * H * ((W + WGrad<64, 64>::KP - 1) / WGrad<64, 64>::KP);
}

template <int BN, int KC>
int launch_data(const void* r, const void* w, const __nv_bfloat16* un, const float* cnext,
                const __nv_bfloat16* u, const float* cin, const __nv_bfloat16* add,
                const __nv_bfloat16* te, __nv_bfloat16* t_out, __nv_bfloat16* da,
                __nv_bfloat16* v_out, __nv_bfloat16* du_out, float* ps, int B, int H, int W,
                int Cr, int Ci, int flags, cudaStream_t s) {
  using Cfg = Conv3x3<BN, KC>;
  CUtensorMap rmap, wmap;
  int err = encode_nhwc(&rmap, r, B, H, W, Cr, KC, Cfg::HALO, 3);
  if (err != 0) return err;
  err = encode_taps(&wmap, w, Ci, Cr, KC, BN);
  if (err != 0) return err;
  auto kernel = data_grad_kernel<BN, KC>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Cfg::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_wtiles = (W + Cfg::BM - 1) / Cfg::BM;
  dim3 grid(n_wtiles * H * (Ci / BN), B);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(rmap, wmap, un, cnext, u, cin, add, te, t_out,
                                                da, v_out, du_out, ps, H, W, Cr, Ci, n_wtiles,
                                                flags);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
int launch_data_n(const void* r, const void* w, const __nv_bfloat16* un, const float* cnext,
                  const __nv_bfloat16* u, const float* cin, const __nv_bfloat16* add,
                  const __nv_bfloat16* te, __nv_bfloat16* t_out, __nv_bfloat16* da,
                  __nv_bfloat16* v_out, __nv_bfloat16* du_out, float* ps, int B, int H, int W,
                  int Cr, int Ci, int flags, cudaStream_t s) {
  if (Ci % 256 == 0)
    return launch_data<256, KC>(r, w, un, cnext, u, cin, add, te, t_out, da, v_out, du_out, ps,
                                B, H, W, Cr, Ci, flags, s);
  if (Ci % 64 == 0)
    return launch_data<64, KC>(r, w, un, cnext, u, cin, add, te, t_out, da, v_out, du_out, ps,
                               B, H, W, Cr, Ci, flags, s);
  return launch_data<16, KC>(r, w, un, cnext, u, cin, add, te, t_out, da, v_out, du_out, ps, B,
                             H, W, Cr, Ci, flags, s);
}

template <int CI_T, int CO_T>
int launch_weight(const void* v, const void* du, float* dwp, float* dbp, int B, int H, int W,
                  int Ci, int Co, int n_split, cudaStream_t s) {
  using Cfg = WGrad<CI_T, CO_T>;
  CUtensorMap vmap, dmap;
  int err = encode_nhwc(&vmap, v, B, H, W, Ci, CI_T, Cfg::HALO, 3);
  if (err != 0) return err;
  err = encode_nhwc(&dmap, du, B, H, W, Co, CO_T, Cfg::KP, 1);
  if (err != 0) return err;
  auto kernel = weight_grad_kernel<CI_T, CO_T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Cfg::SMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_wt = (W + Cfg::KP - 1) / Cfg::KP;
  const int n_chunks = pixel_chunks(B, H, W);
  const int per_split = (n_chunks + n_split - 1) / n_split;
  dim3 grid((Ci / CI_T) * (Co / CO_T), n_split);
  kernel<<<grid, Cfg::THREADS, Cfg::SMEM, s>>>(vmap, dmap, dwp, dbp, H, Ci, Co, n_wt, n_chunks,
                                                per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv_link_bwd_block_pixels() { return Conv3x3<64, 64>::BM; }

// How many pixel ranges the weight-gradient pass splits the map into: about
// one block per SM over the (Cin, Cout) tiles, at most one range per chunk
// of 64 pixels. The dwp and dbp scratch of conv_link_bwd_launch has this
// many rows.
extern "C" int conv_link_bwd_splits(int B, int H, int W, int Cin, int Cout) {
  const int tiles = (Cin / tile(Cin)) * (Cout / tile(Cout));
  const int n = SMS / tiles > 1 ? SMS / tiles : 1;
  const int chunks = pixel_chunks(B, H, W);
  return n < chunks ? n : chunks;
}

// r: (B, H, W, Cout) bf16, raw cotangent of the link output; w: (3, 3, Cin,
// Cout) bf16, the link's weights; u_in: (B, H, W, Cin) bf16; u_next: (B, H,
// W, Cout) bf16 and coef_next (B, 8, Cout) f32 with GN_NEXT; coef_in: (B,
// 8, Cin) f32 with GN_IN; add: (B, H, W, Cin) and te (B, Cin) bf16 with ADD
// / TE. Outputs: t_in (B, H, W, Cin) bf16; da (B, H, W, Cin) bf16 with ADD;
// partials (B, H * ceil(W / 128), 2, Cin) f32 with GN_IN; dw (3, 3, Cin,
// Cout) and db (Cout) f32. Scratch: v (B, H, W, Cin) bf16 with GN_IN or
// ADD; du (B, H, W, Cout) bf16 with GN_NEXT; dwp (n_split, 9, Cin, Cout)
// and dbp (n_split, Cout) f32, n_split = conv_link_bwd_splits(...). The
// maps read by TMA (r, w, u_in, v, du) 16-byte aligned. Unused pointers may
// be null. Returns the first non-zero cudaError_t, or an error of
// csrc/conv3x3_sm90.cuh's encode_map.
extern "C" int conv_link_bwd_launch(const void* r, const void* w, const void* u_in,
                                    const void* u_next, const void* coef_next,
                                    const void* coef_in, const void* add, const void* te,
                                    void* t_in, void* da, void* v, void* du, void* partials,
                                    void* dwp, void* dbp, void* dw, void* db, int B, int H,
                                    int W, int Cin, int Cout, int n_split, int flags,
                                    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      n_split != conv_link_bwd_splits(B, H, W, Cin, Cout))
    return cudaErrorInvalidValue;
  if (!(Cin == 16 || Cin % 64 == 0) || !(Cout == 16 || Cout % 64 == 0))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* unp = static_cast<const bf*>(u_next);
  const auto* cnp = static_cast<const float*>(coef_next);
  const auto* up = static_cast<const bf*>(u_in);
  const auto* cip = static_cast<const float*>(coef_in);
  const auto* ap = static_cast<const bf*>(add);
  const auto* tp = static_cast<const bf*>(te);
  auto* top = static_cast<bf*>(t_in);
  auto* dap = static_cast<bf*>(da);
  auto* vp = static_cast<bf*>(v);
  auto* dup = static_cast<bf*>(du);
  auto* pp = static_cast<float*>(partials);
  int err;
  if (Cout % 64 == 0)
    err = launch_data_n<64>(r, w, unp, cnp, up, cip, ap, tp, top, dap, vp, dup, pp, B, H, W,
                            Cout, Cin, flags, s);
  else
    err = launch_data_n<16>(r, w, unp, cnp, up, cip, ap, tp, top, dap, vp, dup, pp, B, H, W,
                            Cout, Cin, flags, s);
  if (err != 0) return err;

  const void* vsrc = (flags & (F_GN_IN | F_ADD)) ? v : u_in;
  const void* dsrc = (flags & F_GN_NEXT) ? du : r;
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
