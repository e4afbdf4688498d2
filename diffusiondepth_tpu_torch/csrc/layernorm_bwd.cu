// Last-dim LayerNorm backward with bf16 traffic and f32 statistics (kernel
// K10 of the port).
//
// Replaces the TPU kernel diffusiondepth_tpu/ops/layernorm.py
// _ln_bwd_kernel (reached through layernorm_bwd_pallas). Per row of
// x, dy (M, C) bf16 with the forward's mean, inv (M,) f32 and scale (C,)
// f32, in f32:
//
//   xhat = (x - mean) * inv,  t = dy * scale
//   dx   = (t - mean(t) - xhat * mean(t * xhat)) * inv      (stored as bf16)
//
// and over all rows dscale = sum(dy * xhat), dbias = sum(dy), f32. Nothing
// is rounded to bf16 before the store of dx.
//
// What bounds it on the H100: bytes. It reads 4 B and writes 2 B per
// element (plus 8 B per row): ~23 MB, ~7 us at 3.35 TB/s, at the Swin-L
// norm of 37 in a 352x906 batch of 4, (5016, 768). At such sizes the
// latency of each round trip to memory and the launch count the most.
//
// Rows of x, dy and dx lie P bf16 apart, P a multiple of 8 with C <= P <
// C + 8, so that every row starts on 16 bytes; the wrapper
// (ops/layernorm.py::layernorm_bwd) gives P = C when C % 8 == 0 and stages
// x and dy into zero-padded rows of P = ceil8(C) otherwise. A padded column
// has dy = 0 and a scale read as 0: it adds nothing to mean(t), mean(t *
// xhat), dscale or dbias, and its dx is not read back. The means divide
// by C. At every width but those K10 took before the pitch existed (C %
// 8 == 0, C <= 3072, whose instruction sequence and bits are kept), t =
// dy * scale is rounded on its own before it is summed or subtracted, as
// in the plain version (t_of).
//
// Two variants, chosen by the plan:
//
// ln_bwd_kernel, the ring (P <= 4096: a row in at most 4 vectors of 8 on
// each of at most 128 threads; every Swin-L width):
//
// - A persistent grid of at most one block per SM. Block b owns the
//   contiguous rows [b q + min(b, r), ...) of q = M / blocks, r = M %
//   blocks, so its x and dy are two contiguous runs of bytes.
// - One producer warp feeds an S-stage shared-memory ring of R rows of x
//   and R rows of dy: lane 0 issues two 1-D bulk copies per stage
//   (cp.async.bulk, completion counted in bytes on the stage's full
//   mbarrier; a row is P * 2 bytes, a multiple of 16), each lane copies
//   its share of the stage's mean and inv with 4-byte cp.async, tracked by
//   the same mbarrier. Nothing in the producer waits on memory, so the ring
//   (about 75 KB) stays full; eight consumer warps release a stage through
//   its empty mbarrier.
// - Exact columns: a row is P / 8 vectors of 8 bf16 (16 bytes). TPR
//   threads per row (a power of two, 8 to 128 at the Swin widths) each own
//   VPT = ceil(P / 8 / TPR) <= 4 vectors, j, j + TPR, ...: 3 vectors at
//   every Swin C (192 ... 3072), no lane idle. A vector is one 16-byte
//   shared-memory load into registers, unpacked with bit operations.
//   mean(t) and mean(t * xhat) are summed by xor shuffles within TPR <= 32
//   lanes, and across the TPR / 32 warps of a row through shared memory
//   (one named barrier per row), then scaled by 1 / C. dx is written with
//   16-byte stores.
// - dscale and dbias without float atomics: each thread keeps its
//   columns' sums in registers across its rows; at the end the block folds
//   them in a fixed order (shuffles, then slots in shared memory) into its
//   (2, P) row of the workspace with 16-byte stores.
//
// ln_bwd_wide_kernel (P > 4096, no width limit but memory): the same rows
// per block, 512 threads on one row at a time, two passes over the row's
// 16-byte vectors straight from global memory (the second from L2):
// pass 1 sums t and t * xhat, reduced across the block in warp order
// through shared memory; pass 2 writes dx and adds each thread's fixed
// vectors of dy * xhat and dy into the block's (2, P) row of the
// workspace (stored at the block's first row, then read, added and
// stored: every column has one owner thread, so no atomics).
//
// ln_bwd_reduce, a second launch on the same stream, sums the blocks'
// rows in block order, column slices in parallel. Two calls on the same
// inputs give the same bits; both launches are captured by a CUDA graph.
// (Chaining it by programmatic dependent launch measured slower on the
// H100.)
//
// The plan (variant, pitch, blocks, R, S, TPR, shared-memory bytes) comes
// from ops/layernorm.py::layernorm_bwd_plan; the launch function recomputes
// the shared-memory layout and refuses a plan that does not match it.

#include "conv3x3_sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCW = 8;                   // consumer warps
constexpr int CONSUMERS = NCW * 32;      // consumer threads
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int BAR_BYTES = 256;           // full and empty mbarriers of up to 16 stages
constexpr int MSUM_BYTES = 128;          // cross-warp row sums, 2 buffers x 8 warps x 2
constexpr int MAX_STAGES = 16;
constexpr int MAX_VPT = 4;
constexpr int RING_MAX_PITCH = MAX_VPT * 128 * 8;  // widest row of the ring variant
constexpr int SMEM_LIMIT = 232448;
constexpr int WIDE_THREADS = 512;        // threads of ln_bwd_wide_kernel, all on one row
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int REDUCE_COLS = 8;           // float4 columns per block of ln_bwd_reduce
constexpr int REDUCE_SPLIT = 32;         // partial sums per column there

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_init_fence;
using sm90::mbar_wait;
using sm90::smem_u32;

__host__ __device__ inline int stats_floats(int r) { return (r + 3) & ~3; }

__host__ __device__ inline size_t stage_bytes(int r, int c) {
  return (size_t)4 * r * c + (size_t)8 * stats_floats(r);
}

__host__ __device__ inline int red_slots(int tpr) { return tpr >= 32 ? CONSUMERS / tpr : NCW; }

__host__ inline size_t smem_bytes(int r, int s, int c, int tpr) {
  return BAR_BYTES + (size_t)s * stage_bytes(r, c) + (size_t)red_slots(tpr) * 8 * c + MSUM_BYTES;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// the barrier arrives once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 8 bf16 of a 16-byte vector (element 2i in the low half of word i) as f32
__device__ __forceinline__ void unpack8(const uint4 w, float* v) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// t = dy * scale, rounded to f32 on its own (ROUND_T) as the plain version
// and JAX compute it, so that t - mean(t) is exactly 0 where it is in exact
// arithmetic (C = 1); or left to the compiler, which fuses the product into
// the next add or subtract (the instruction sequence K10 had before the
// pitch existed, kept at the widths it took then: C % 8 == 0, C <= 3072)
template <bool ROUND_T>
__device__ __forceinline__ float t_of(float dy, float scale) {
  return ROUND_T ? __fmul_rn(dy, scale) : dy * scale;
}

template <int VPT, bool ROUND_T>  // 16-byte vectors a thread
__global__ void __launch_bounds__(THREADS, 1)
ln_bwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const float* __restrict__ scale, __nv_bfloat16* __restrict__ dx,
              float* __restrict__ part, int M, int C, int P, int R, int S, int tpr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nv = P >> 3;
  const int base = M / (int)gridDim.x, rem = M % (int)gridDim.x;
  const int b = blockIdx.x;
  const long long row0 = (long long)b * base + min(b, rem);
  const int rows = base + (b < rem ? 1 : 0);
  const int nst = (rows + R - 1) / R;
  const size_t xbytes = (size_t)R * P * 2;
  const size_t sbytes = stage_bytes(R, P);
  const int rp = stats_floats(R);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = smem + BAR_BYTES;
  float* red = reinterpret_cast<float*>(ring + (size_t)S * sbytes);
  const int groups = CONSUMERS / tpr;
  float* msum = red + (size_t)red_slots(tpr) * 2 * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);  // 32 cp.async arrivals + lane 0's expect_tx
      mbar_init(&empty[s], NCW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {  // ---- producer
    for (int st = 0; st < nst; ++st) {
      const int slot = st % S;
      if (st >= S) mbar_wait(&empty[slot], ((st / S) - 1) & 1);
      unsigned char* sb = ring + (size_t)slot * sbytes;
      const int n = min(R, rows - st * R);
      const long long r0 = row0 + (long long)st * R;
      if (lane == 0) {
        const uint32_t nb = (uint32_t)n * P * 2;
        mbar_expect_tx(&full[slot], 2 * nb);
        bulk_load(sb, x + r0 * P, nb, &full[slot]);
        bulk_load(sb + xbytes, dy + r0 * P, nb, &full[slot]);
      }
      float* sm = reinterpret_cast<float*>(sb + 2 * xbytes);
      for (int i = lane; i < n; i += 32) {
        cp_async4(sm + i, mean + r0 + i);
        cp_async4(sm + rp + i, inv + r0 + i);
      }
      cp_async_arrive(&full[slot]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: group grp of tpr threads takes rows grp, grp + groups,
  // ... of each stage; thread j of a group owns vectors j, j + tpr, ... of a
  // row. A vector past P reads as zeros and a column past C has a zero
  // scale: either adds nothing. A vector past P is not stored.
  const int tid = threadIdx.x;
  const int grp = tid / tpr, j = tid % tpr;
  const int wpr = tpr > 32 ? tpr / 32 : 1;  // warps per row
  const int width = tpr < 32 ? tpr : 32;    // lanes of a row within a warp
  bool has[VPT];
  float sc[VPT * 8], ads[VPT * 8], adb[VPT * 8];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    has[v] = j + v * tpr < nv;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = (j + v * tpr) * 8 + k;
      sc[v * 8 + k] = has[v] && col < C ? scale[col] : 0.f;
      ads[v * 8 + k] = 0.f;
      adb[v * 8 + k] = 0.f;
    }
  }
  const float rc = 1.f / (float)C;
  int it = 0;  // row iterations, for the cross-warp buffers
  for (int st = 0; st < nst; ++st) {
    const int slot = st % S;
    mbar_wait(&full[slot], (st / S) & 1);
    const unsigned char* sb = ring + (size_t)slot * sbytes;
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(sb);
    const __nv_bfloat16* sdy = reinterpret_cast<const __nv_bfloat16*>(sb + xbytes);
    const float* sm = reinterpret_cast<const float*>(sb + 2 * xbytes);
    const int n = min(R, rows - st * R);
    for (int rb = 0; rb < n; rb += groups, ++it) {
      const int r = rb + grp;
      const int rr = r < n ? r : 0;  // an idle group reads a loaded row, stores nothing
      const float mu = sm[rr], iv = sm[rp + rr];
      float xh[VPT * 8];
      uint4 dr[VPT];  // dy stays packed until dx
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const size_t off = (size_t)rr * P + (size_t)(j + v * tpr) * 8;
        uint4 xr = make_uint4(0u, 0u, 0u, 0u);
        dr[v] = xr;
        if (has[v]) {
          xr = *reinterpret_cast<const uint4*>(sx + off);
          dr[v] = *reinterpret_cast<const uint4*>(sdy + off);
        }
        float xv[8], dv[8];
        unpack8(xr, xv);
        unpack8(dr[v], dv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = v * 8 + k;
          xh[e] = (xv[k] - mu) * iv;
          const float t = t_of<ROUND_T>(dv[k], sc[e]);
          s1 += t;
          s2 += t * xh[e];
        }
      }
      for (int o = width >> 1; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (wpr > 1) {  // the row's warps add their sums in warp order
        float* ms = msum + (it & 1) * (NCW * 2);
        if (lane == 0) {
          ms[warp * 2] = s1;
          ms[warp * 2 + 1] = s2;
        }
        named_sync(2 + grp, tpr);
        const int w0 = warp - warp % wpr;
        s1 = 0.f;
        s2 = 0.f;
        for (int w = 0; w < wpr; ++w) {
          s1 += ms[(w0 + w) * 2];
          s2 += ms[(w0 + w) * 2 + 1];
        }
      }
      if (r >= n) continue;
      const float m1 = s1 * rc, m2 = s2 * rc;
      __nv_bfloat16* out = dx + (row0 + (long long)st * R + r) * P;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        if (!has[v]) continue;
        float dv[8], o8[8];
        unpack8(dr[v], dv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = v * 8 + k;
          o8[k] = (t_of<ROUND_T>(dv[k], sc[e]) - m1 - xh[e] * m2) * iv;
          ads[e] += dv[k] * xh[e];
          adb[e] += dv[k];
        }
        *reinterpret_cast<uint4*>(out + (j + v * tpr) * 8) = sm90::pack8(o8);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  // ---- the block's (2, P) partial, in a fixed order: the row groups of a
  // warp by xor shuffles, then the warps' slots in shared memory
  for (int o = tpr; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VPT * 8; ++e) {
      ads[e] += __shfl_xor_sync(0xffffffffu, ads[e], o);
      adb[e] += __shfl_xor_sync(0xffffffffu, adb[e], o);
    }
  }
  if (tpr >= 32 || lane < tpr) {
    float* slot = red + (size_t)(tpr >= 32 ? grp : warp) * 2 * P;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      if (!has[v]) continue;
      const int col = (j + v * tpr) * 8;
#pragma unroll
      for (int k = 0; k < 8; k += 4) {
        *reinterpret_cast<float4*>(slot + col + k) =
            make_float4(ads[v * 8 + k], ads[v * 8 + k + 1], ads[v * 8 + k + 2], ads[v * 8 + k + 3]);
        *reinterpret_cast<float4*>(slot + P + col + k) =
            make_float4(adb[v * 8 + k], adb[v * 8 + k + 1], adb[v * 8 + k + 2], adb[v * 8 + k + 3]);
      }
    }
  }
  named_sync(1, CONSUMERS);
  const int slots = red_slots(tpr);
  const int n4 = P / 2;  // float4s of a (2, P) row
  const float4* red4 = reinterpret_cast<const float4*>(red);
  float4* dst = reinterpret_cast<float4*>(part + (size_t)b * 2 * P);
  for (int k = tid; k < n4; k += CONSUMERS) {
    float4 acc = red4[k];
    for (int s = 1; s < slots; ++s) {
      const float4 v = red4[(size_t)s * n4 + k];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    dst[k] = acc;
  }
}

// The wide variant: block b takes the same contiguous rows as in the
// ring, one at a time, all WIDE_THREADS threads on a row; thread t owns
// the row's 16-byte vectors t, t + WIDE_THREADS, ... in both passes and
// the same columns of the block's (2, P) partial.
__global__ void __launch_bounds__(WIDE_THREADS)
ln_bwd_wide_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ mean, const float* __restrict__ inv,
                   const float* __restrict__ scale, __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ part, int M, int C, int P) {
  __shared__ float sums[2][WIDE_WARPS][2];  // by row parity: a row's sums while
                                            // the next row's are written
  const int nv = P >> 3;
  const int base = M / (int)gridDim.x, rem = M % (int)gridDim.x;
  const int b = blockIdx.x;
  const long long row0 = (long long)b * base + min(b, rem);
  const int rows = base + (b < rem ? 1 : 0);
  const float rc = 1.f / (float)C;
  float* pds = part + (size_t)b * 2 * P;
  float* pdb = pds + P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = 0; i < rows; ++i) {
    const long long row = row0 + i;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * P);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + row * P);
    const float mu = mean[row], iv = inv[row];
    // ---- pass 1: sum(t) and sum(t * xhat) over the row
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 2
    for (int v = tid; v < nv; v += WIDE_THREADS) {
      float xv[8], dv[8];
      unpack8(xr[v], xv);
      unpack8(dr[v], dv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = v * 8 + k;
        const float t = t_of<true>(dv[k], col < C ? scale[col] : 0.f);
        s1 += t;
        s2 += t * ((xv[k] - mu) * iv);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      sums[i & 1][warp][0] = s1;
      sums[i & 1][warp][1] = s2;
    }
    __syncthreads();
    s1 = 0.f;
    s2 = 0.f;
#pragma unroll
    for (int w = 0; w < WIDE_WARPS; ++w) {  // in warp order on every thread
      s1 += sums[i & 1][w][0];
      s2 += sums[i & 1][w][1];
    }
    const float m1 = s1 * rc, m2 = s2 * rc;
    // ---- pass 2: dx, and this thread's columns of dscale and dbias
    uint4* out = reinterpret_cast<uint4*>(dx + row * P);
#pragma unroll 2
    for (int v = tid; v < nv; v += WIDE_THREADS) {
      float xv[8], dv[8], o8[8], ps[8], pb[8];
      unpack8(xr[v], xv);
      unpack8(dr[v], dv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = v * 8 + k;
        const float xh = (xv[k] - mu) * iv;
        o8[k] = (t_of<true>(dv[k], col < C ? scale[col] : 0.f) - m1 - xh * m2) * iv;
        ps[k] = dv[k] * xh;
        pb[k] = dv[k];
      }
      out[v] = sm90::pack8(o8);
      float4* ps4 = reinterpret_cast<float4*>(pds + v * 8);
      float4* pb4 = reinterpret_cast<float4*>(pdb + v * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 a = make_float4(ps[4 * h], ps[4 * h + 1], ps[4 * h + 2], ps[4 * h + 3]);
        float4 c = make_float4(pb[4 * h], pb[4 * h + 1], pb[4 * h + 2], pb[4 * h + 3]);
        if (i > 0) {
          const float4 a0 = ps4[h], c0 = pb4[h];
          a = make_float4(a0.x + a.x, a0.y + a.y, a0.z + a.z, a0.w + a.w);
          c = make_float4(c0.x + c.x, c0.y + c.y, c0.z + c.z, c0.w + c.w);
        }
        ps4[h] = a;
        pb4[h] = c;
      }
    }
  }
}

// dscale and dbias: the blocks' partials (nblk, 2, W) summed in block
// order. Block x takes REDUCE_COLS float4 columns of the 2W; thread (y, x)
// sums blocks y, y + REDUCE_SPLIT, ... of its column (one round of loads at
// nblk = 132), then the REDUCE_SPLIT sums are added in y order: 8 at a time
// by REDUCE_SPLIT / 8 threads, and those by one.
__global__ void __launch_bounds__(REDUCE_COLS * REDUCE_SPLIT)
ln_bwd_reduce(const float4* __restrict__ part, float4* __restrict__ ds, float4* __restrict__ db,
              int nblk, int W) {
  __shared__ float4 sums[REDUCE_SPLIT][REDUCE_COLS];
  const int tx = threadIdx.x % REDUCE_COLS, ty = threadIdx.x / REDUCE_COLS;
  const int k = blockIdx.x * REDUCE_COLS + tx;
  const int n4 = W / 2;  // float4s of a (2, W) row
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < n4) {
#pragma unroll 4
    for (int p = ty; p < nblk; p += REDUCE_SPLIT) {
      const float4 v = part[(size_t)p * n4 + k];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty < REDUCE_SPLIT / 8) {
    float4 a = sums[ty * 8][tx];
#pragma unroll
    for (int y = 1; y < 8; ++y) {
      const float4 v = sums[ty * 8 + y][tx];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    sums[ty * 8][tx] = a;
  }
  __syncthreads();
  if (ty == 0 && k < n4) {
    float4 a = sums[0][tx];
#pragma unroll
    for (int y = 8; y < REDUCE_SPLIT; y += 8) {
      const float4 v = sums[y][tx];
      a.x += v.x;
      a.y += v.y;
      a.z += v.z;
      a.w += v.w;
    }
    if (k < W / 4)
      ds[k] = a;
    else
      db[k - W / 4] = a;
  }
}

using KernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const float*,
                         const float*, const float*, __nv_bfloat16*, float*, int, int, int, int,
                         int, int);
const KernelFn KERNELS[2][MAX_VPT] = {
    {ln_bwd_kernel<1, false>, ln_bwd_kernel<2, false>, ln_bwd_kernel<3, false>,
     ln_bwd_kernel<4, false>},
    {ln_bwd_kernel<1, true>, ln_bwd_kernel<2, true>, ln_bwd_kernel<3, true>,
     ln_bwd_kernel<4, true>}};

}  // namespace

// x, dy (M, P) bf16 and dx (M, P) bf16 on 16-byte boundaries, of which the
// first C columns are the problem's (P % 8 == 0, C <= P < C + 8, the
// columns past C of dy zero); mean, inv (M,) f32; scale (C,) f32; ds, db
// (P,) f32; workspace (ctas, 2, P) f32. The plan (variant 0: the ring,
// with rows_per_stage, stages, threads_per_row, smem_bytes; variant 1: the
// wide kernel, with 1, 0, WIDE_THREADS, 0) is layernorm_bwd_plan's.
// Returns the first CUDA error of the two launches.
extern "C" int layernorm_bwd_launch(const void* x, const void* dy, const void* mean,
                                    const void* inv, const void* scale, void* dx, void* ds,
                                    void* db, void* workspace, int M, int C, int P, int variant,
                                    int ctas, int rows_per_stage, int stages,
                                    int threads_per_row, int smem, void* stream) {
  const int R = rows_per_stage, S = stages, tpr = threads_per_row;
  if (M < 1 || C < 1 || P % 8 != 0 || P < C || P >= C + 8) return cudaErrorInvalidValue;
  if (ctas < 1 || ctas > M) return cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx | (uintptr_t)ds | (uintptr_t)db |
       (uintptr_t)workspace) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == 0) {
    if (P > RING_MAX_PITCH || S < 2 || S > MAX_STAGES) return cudaErrorInvalidValue;
    if (tpr < 1 || tpr > 128 || (tpr & (tpr - 1)) != 0) return cudaErrorInvalidValue;
    const int vpt = (P / 8 + tpr - 1) / tpr;
    if (vpt > MAX_VPT || R < CONSUMERS / tpr || R % (CONSUMERS / tpr) != 0)
      return cudaErrorInvalidValue;
    const size_t need = smem_bytes(R, S, P, tpr);
    if (need != (size_t)smem || need > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
    const KernelFn kernel = KERNELS[P != C || C > 3072][vpt - 1];
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err != cudaSuccess) return err;
    kernel<<<ctas, THREADS, need, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<const float*>(mean), static_cast<const float*>(inv),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(dx),
        static_cast<float*>(workspace), M, C, P, R, S, tpr);
  } else if (variant == 1) {
    if (R != 1 || S != 0 || tpr != WIDE_THREADS || smem != 0) return cudaErrorInvalidValue;
    ln_bwd_wide_kernel<<<ctas, WIDE_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<const float*>(mean), static_cast<const float*>(inv),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(dx),
        static_cast<float*>(workspace), M, C, P);
  } else {
    return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce<<<(P / 2 + REDUCE_COLS - 1) / REDUCE_COLS, REDUCE_COLS * REDUCE_SPLIT, 0, s>>>(
      static_cast<const float4*>(workspace), static_cast<float4*>(ds), static_cast<float4*>(db),
      ctas, P);
  return cudaGetLastError();
}
