// Hopper building blocks of the port's 3x3 conv kernels: K1
// (csrc/conv_link.cu) and K5 (csrc/conv_link_bwd.cu).
//
// - PTX wrappers: mbarrier, TMA tensor loads, ldmatrix, wgmma with A in
//   registers and B described in shared memory, setmaxnreg, named barriers;
// - tensor maps encoded on the host through cudaGetDriverEntryPoint (the
//   libraries are plain nvcc -shared builds, not linked against libcuda);
// - the implicit-GEMM 3x3 main loop that K1 and K5's data-gradient pass
//   share: M = BM = 128 output pixels of one image-row segment, N = BN
//   output channels, K = 9 taps x Cin in chunks of KC input channels.
//
// The main loop's shared memory is a ring. Two halo stages hold the 3-row
// halo of one channel chunk, (3, BM + 2, KC) bf16, loaded by one 4-D TMA
// box over the NHWC map: the out-of-bounds zero fill pads the image border
// and a ragged last segment. NB weight stages hold one (tap, chunk) tile,
// (BN, KC) bf16 with K contiguous. Rows are KC * 2 bytes (128 with the
// 128-byte swizzle for KC = 64, 32 with the 32-byte swizzle for KC = 16).
// One producer thread issues the TMA loads against full/empty mbarriers;
// two consumer warpgroups (rows 0-63 and 64-127) run the nine taps of a
// halo stage, the tap (dr, dc) reading halo rows dr * (BM + 2) + m + dc.
// The caller's prologue hook transforms each halo stage in place once
// (then a fence.proxy.async and a named barrier), before its nine taps;
// K1's transformed links instead wait for warps of their own to transform
// it (csrc/conv_link.cu, XfPipe) and run only `taps`. Those rows start at
// any row of the 8-row swizzle atom, so A is read with ldmatrix through the
// swizzle XOR into registers and wgmma takes A from registers; B, aligned
// to the atom, is read by wgmma through a shared-memory descriptor.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

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

// Byte offset within a tile of RB-byte rows as TMA lays it out with the
// matching swizzle (RB = 128: 128-byte swizzle, bits 4-6 ^= bits 7-9;
// RB = 32: 32-byte swizzle, bit 4 ^= bit 7). The tile is 1024-byte aligned.
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  static_assert(RB == 128 || RB == 32, "row bytes");
  constexpr uint32_t mask = RB == 128 ? 7 : 1;
  return off ^ (((off >> 7) & mask) << 4);
}

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// generic-proxy writes to shared memory become visible to the async proxy
// (TMA, wgmma) that touches the same bytes next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier 1 among the 256 consumer threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// named barrier ID among N threads (a multiple of 32)
template <int ID, int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Shared-memory matrix descriptor of a swizzled tile of RB-byte rows
// (layout 1 = 128-byte swizzle, 3 = 32-byte swizzle). K-major operands:
// sbo is the stride between 8-row groups, lbo unused. MN-major operands
// (RB bytes of N per K row): sbo is the stride between groups of 8 K rows,
// lbo the stride between RB-wide column blocks.
template <int RB>
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = RB == 128 ? 1 : 3;
  return static_cast<uint64_t>((saddr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// D (64 x N, f32, registers) += A (64 x 16 bf16, registers, the mma.m16n8k16
// A fragment of each warp's 16 rows) * B (16 x N bf16, shared memory;
// TRANS_B = 0: K-major, 1: N-major). D's element i of a thread lies at row
// 16 * (warp % 4) + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
// 2 * (lane % 4) + i % 2.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  static_assert(N == 16 || N == 64 || N == 256, "wgmma width");
  if constexpr (N == 16)
    wgmma_m64n16k16<TRANS_B>(d, a, desc_b);
  else if constexpr (N == 64)
    wgmma_m64n64k16<TRANS_B>(d, a, desc_b);
  else
    wgmma_m64n256k16<TRANS_B>(d, a, desc_b);
}

// ---------------------------------------------------------------------------
// tensor maps (host)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiledFn>(nullptr);
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Error codes of the launch functions beside cudaError_t's: no driver entry
// point, or a tensor map the driver refused (10000 + its CUresult).
constexpr int ERR_NO_ENCODE = 9999;
constexpr int ERR_ENCODE = 10000;

// A tiled map of a bf16 tensor of `rank` dimensions, innermost first:
// dims[i] elements, strides[i] elements between consecutive indices of
// dimension i + 1, a box of box[i] elements, zero fill out of bounds, and
// the swizzle that matches rows of box[0] * 2 bytes (128 or 32).
inline int encode_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                      const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides[i] * 2;
  }
  const CUtensorMapSwizzle sw =
      box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        gdim, gstride, bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

// (B, H, W, C) NHWC map read in boxes of (1, bh, bw, bc)
inline int encode_nhwc(CUtensorMap* map, const void* base, int B, int H, int W, int C, int bc,
                       int bw, int bh) {
  const uint64_t dims[4] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W),
                            static_cast<uint64_t>(H), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(C), static_cast<uint64_t>(W) * C,
                               static_cast<uint64_t>(H) * W * C};
  const uint32_t box[4] = {static_cast<uint32_t>(bc), static_cast<uint32_t>(bw),
                           static_cast<uint32_t>(bh), 1};
  return encode_map(map, base, 4, dims, strides, box);
}

// (9, rows, K) tap-major weights read in boxes of (1, br, bk)
inline int encode_taps(CUtensorMap* map, const void* base, int rows, int K, int bk, int br) {
  const uint64_t dims[3] = {static_cast<uint64_t>(K), static_cast<uint64_t>(rows), 9};
  const uint64_t strides[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(rows) * K};
  const uint32_t box[3] = {static_cast<uint32_t>(bk), static_cast<uint32_t>(br), 1};
  return encode_map(map, base, 3, dims, strides, box);
}

// ---------------------------------------------------------------------------
// the implicit-GEMM 3x3 main loop
// ---------------------------------------------------------------------------

template <int BN_, int KC_>
struct Conv3x3 {
  static constexpr int BM = 128;  // output pixels per block, along one image row
  static constexpr int BN = BN_;  // output channels per block
  static constexpr int KC = KC_;  // input channels per chunk
  static constexpr int NB = BN == 256 ? 3 : 6;  // weight stages
  static constexpr int RB = KC * 2;             // bytes per staged row
  static constexpr int HALO = BM + 2;
  static constexpr int THREADS = 384;  // two consumer warpgroups, one producer
  // The narrow tiles hold little work per block: two blocks share an SM,
  // so that one's pipeline fill and epilogue overlap the other's loop, at
  // the registers of two blocks (no setmaxnreg). The wide ones run one
  // block per SM with the registers moved to the consumers.
  static constexpr int MIN_BLOCKS = (BN == 16 || KC == 16) && BN <= 64 ? 2 : 1;
  static constexpr uint32_t A_BYTES = 3 * HALO * RB;
  static constexpr uint32_t A_STRIDE = (A_BYTES + 1023) / 1024 * 1024;
  static constexpr uint32_t B_BYTES = BN * RB;
  static constexpr uint32_t B_STRIDE = (B_BYTES + 1023) / 1024 * 1024;
  static constexpr uint32_t RING_BYTES = 2 * A_STRIDE + NB * B_STRIDE;
  // an epilogue may stage the f32 tile, rows padded by 8 floats (K1: the
  // per-thread column sums, K5: the tile), then 2 x 2048 f32 of column
  // sums (K5) or the bf16 tile (K1), over the ring once the loop is done
  static constexpr int OUT_LD = BN + 8;
  static constexpr uint32_t OUT_BYTES =
      BM * OUT_LD * 4 + (2 * 2048 * 4 > BM * BN * 2 ? 2 * 2048 * 4 : BM * BN * 2);
  static constexpr uint32_t BAR_OFF = RING_BYTES > OUT_BYTES ? RING_BYTES : OUT_BYTES;
  // + 1024 to align the dynamic shared memory's start by hand
  static constexpr uint32_t SMEM = BAR_OFF + 8 * (4 + 2 * NB) + 1024;
  static_assert(KC == 64 || KC == 16, "chunk width");
  static_assert(SMEM <= 232448 / MIN_BLOCKS - 1024, "shared memory");
  // Products left in flight while the next tap is loaded: one, with a
  // second register set of A fragments, where a block has the SM to
  // itself; none where two blocks share its registers.
  static constexpr int IN_FLIGHT = MIN_BLOCKS == 1 ? 1 : 0;

  uint8_t* base;

  __device__ explicit Conv3x3(uint8_t* raw)
      : base(reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023))) {}

  __device__ uint8_t* a_stage(int i) const { return base + i * A_STRIDE; }
  __device__ uint8_t* b_stage(int i) const { return base + 2 * A_STRIDE + i * B_STRIDE; }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + BAR_OFF) + i;
  }
  // barriers: a_full 0-1, a_empty 2-3, b_full 4.., b_empty 4 + NB..
  __device__ uint64_t* a_full(int i) const { return bar(i); }
  __device__ uint64_t* a_empty(int i) const { return bar(2 + i); }
  __device__ uint64_t* b_full(int i) const { return bar(4 + i); }
  __device__ uint64_t* b_empty(int i) const { return bar(4 + NB + i); }
  __device__ float* out_tile() const { return reinterpret_cast<float*>(base); }
  __device__ float* out_red() const { return out_tile() + BM * OUT_LD; }

  // the register split of the roles, on entering the producer's and the
  // consumers' branch
  __device__ static void producer_regs() {
    if constexpr (MIN_BLOCKS == 1) setmaxnreg_dec<40>();
  }
  __device__ static void consumer_regs() {
    if constexpr (MIN_BLOCKS == 1) setmaxnreg_inc<232>();
  }

  // thread 0, before the roles split (then __syncthreads)
  __device__ void init() const {
    for (int i = 0; i < 2; ++i) {
      mbar_init(a_full(i), 1);
      mbar_init(a_empty(i), 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < NB; ++i) {
      mbar_init(b_full(i), 1);
      mbar_init(b_empty(i), 8);
    }
    mbar_init_fence();
  }

  // The producer thread: chunk c's halo, box (1, 3, BM + 2, KC) at
  // (b, h - 1, w0 - 1, c * KC), then its nine weight tiles, box (1, BN, KC)
  // at (tap_map(tap), n0, c * KC).
  template <class TapMap>
  __device__ void produce(const CUtensorMap* xmap, const CUtensorMap* wmap, int b, int h, int w0,
                          int n0, int n_chunks, TapMap tap_map) const {
    for (int c = 0; c < n_chunks; ++c) {
      const int a = c & 1;
      mbar_wait(a_empty(a), ((c >> 1) & 1) ^ 1);
      mbar_expect_tx(a_full(a), A_BYTES);
      tma_load_4d(a_stage(a), xmap, a_full(a), c * KC, w0 - 1, h - 1, b);
      for (int tap = 0; tap < 9; ++tap) {
        const int i = c * 9 + tap;
        const int s = i % NB;
        mbar_wait(b_empty(s), ((i / NB) & 1) ^ 1);
        mbar_expect_tx(b_full(s), B_BYTES);
        tma_load_3d(b_stage(s), wmap, b_full(s), c * KC, n0, tap_map(tap));
      }
    }
  }

  // The 256 consumer threads: acc (the warpgroup's 64 x BN tile, layout of
  // wgmma_m64k16) += the block's conv. When transform.active,
  // transform(A, c) transforms chunk c's halo stage in place, leaving the
  // out-of-image units at zero, before a fence.proxy.async and a consumer
  // barrier publish it.
  template <class Transform>
  __device__ void consume(float (&acc)[BN / 2], int n_chunks, Transform& transform) const {
    for (int c = 0; c < n_chunks; ++c) {
      const int a = c & 1;
      mbar_wait(a_full(a), (c >> 1) & 1);
      if (transform.active) {
        transform(a_stage(a), c);
        fence_proxy_async();
        consumer_sync();
      }
      taps(acc, c);
    }
  }

  // The consumers' nine taps of chunk c on its halo stage, in (tap, k16)
  // order. IN_FLIGHT taps' products run while the next tap's weight tile
  // is awaited and its A fragments are loaded: a tap's weight stage is
  // released once its group is done; the halo stage after all nine.
  __device__ __forceinline__ void taps(float (&acc)[BN / 2], int c) const {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    // the halo row (output pixel) this lane addresses for ldmatrix, and
    // which 8 channels of each k16 step
    const int mrow = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
    const int khalf = lane >> 4;
    const int a = c & 1;
    const uint32_t a_addr = smem_u32(a_stage(a));
    // unrolled where the A register sets alternate
    uint32_t af[IN_FLIGHT + 1][KC / 16][4];
#pragma unroll(IN_FLIGHT == 1 ? 9 : 1)
    for (int tap = 0; tap < 9; ++tap) {
      const int i = c * 9 + tap;
      const int s = i % NB;
      mbar_wait(b_full(s), (i / NB) & 1);
      const uint32_t row = (tap / 3) * HALO + mrow + tap % 3;
      uint32_t(&f)[KC / 16][4] = af[tap % (IN_FLIGHT + 1)];
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        ldmatrix_x4(f[ks], a_addr + swz<RB>(row * RB + (2 * ks + khalf) * 16));
      const uint32_t b_addr = smem_u32(b_stage(s));
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
        wgmma_m64k16<BN, 0>(acc, f[ks], make_desc<RB>(b_addr + ks * 32, 16, 8 * RB));
      wgmma_commit();
      if (tap >= IN_FLIGHT) {
        wgmma_wait<IN_FLIGHT>();
        if (lane == 0) mbar_arrive(b_empty((i - IN_FLIGHT) % NB));
      }
    }
    wgmma_wait<0>();
    if (lane == 0) {
#pragma unroll
      for (int tap = 9 - IN_FLIGHT; tap < 9; ++tap) mbar_arrive(b_empty((c * 9 + tap) % NB));
      mbar_arrive(a_empty(a));
    }
  }
};

}  // namespace sm90
