"""The backward of one training DDIM step as a Triton kernel (kernel K6 of
the port).

Replaces the TPU kernel diffusiondepth_tpu/ops/fused_denoiser.py
_sched_bwd_kernel (reached through _sched_bwd inside the backward of
fused_sampler_step). Per element of the (B, H, W, 16) latent:

    d    = dxp + dxpb                        (f32 + bf16 cotangents)
    dx   = d * (sp / sa)                     (the closed-form DDIM transpose;
    deps = d * (sq - sp * sb / sa)            autodiff cancels near t = 0)
    pre  = round(round(u6 * a) + b)          (GroupNorm-3 affine, bf16)
    t6   = pre > 0 ? round(round(deps) * scale) : 0
    xhat = round(round(u6 - mean) * inv)

and per block and channel the partials (sum t6, sum round(t6 * xhat)) of
the GroupNorm-3 backward. The sums take the rounded t6 and the rounded
products, the values K5 sums and the plain version
(``ops/fused_denoiser.py::sched_bwd_plain``) sums; the JAX kernel's
compiler sums unrounded ones, about 0.3% apart.

What bounds it on the H100: bytes. Per element it reads 4 + 2 + 2 bytes
and writes 4 + 2, ~14 B for ~25 operations: at the training latent
(4, 176, 453, 16) ~71 MB, ~21 us at 3.35 TB/s.

What the design does about it: one pass, each byte once. A program owns
PIX pixels x 16 channels of one image, a contiguous (PIX, 16) tile, so
its channel sums are a reduction over the tile's first axis and are
written per program, with no atomics; the caller sums the (B, T, 2, 16)
partials in a fixed order. Rounding to bf16 mid-computation is done on the
bits (``_round_bf16``, as in ``csrc/ddim_step.py``): a truncf/extf pair
can be folded away.

Loaded by ``diffusiondepth_tpu_torch.ops.fused_denoiser`` only when it
launches the kernel: it imports triton, which only the machine with the
card has.
"""

import triton
import triton.language as tl

PIX = 64  # pixels per program


def n_blocks(hw: int) -> int:
    """Programs (partial rows) per image of hw pixels."""
    return triton.cdiv(hw, PIX)


@triton.jit
def _round_bf16(v):
    """Round f32 to the nearest bf16 (ties to even), kept in f32."""
    b = v.to(tl.uint32, bitcast=True)
    b = b + 0x7FFF + ((b >> 16) & 1)
    b = (b >> 16) << 16
    return b.to(tl.float32, bitcast=True)


@triton.jit
def sched_bwd_kernel(dxp_ptr, dxpb_ptr, u_ptr, coef_ptr, s_ptr, dx_ptr, t_ptr, ps_ptr,
                     hw, n_t, HAS_B: tl.constexpr, C: tl.constexpr, PIX: tl.constexpr):
    t = tl.program_id(0)
    b = tl.program_id(1)
    pix = t * PIX + tl.arange(0, PIX)
    ch = tl.arange(0, C)
    pm = pix < hw
    offs = (b.to(tl.int64) * hw + pix)[:, None] * C + ch[None, :]
    m = pm[:, None]
    d = tl.load(dxp_ptr + offs, mask=m, other=0.0)
    if HAS_B:
        d = d + tl.load(dxpb_ptr + offs, mask=m, other=0.0).to(tl.float32)
    sa = tl.load(s_ptr)
    sb = tl.load(s_ptr + 1)
    sp = tl.load(s_ptr + 2)
    sq = tl.load(s_ptr + 3)
    tl.store(dx_ptr + offs, d * (sp / sa), mask=m)
    deps = d * (sq - sp * sb / sa)

    cb = coef_ptr + b * 8 * C + ch
    a = _round_bf16(tl.load(cb))[None, :]
    o = _round_bf16(tl.load(cb + C))[None, :]
    inv = _round_bf16(tl.load(cb + 2 * C))[None, :]
    mean = _round_bf16(tl.load(cb + 3 * C))[None, :]
    scale = _round_bf16(tl.load(cb + 4 * C))[None, :]
    u = tl.load(u_ptr + offs, mask=m, other=0.0).to(tl.float32)
    pre = _round_bf16(_round_bf16(u * a) + o)
    t6 = tl.where((pre > 0.0) & m, _round_bf16(_round_bf16(deps) * scale), 0.0)
    xh = _round_bf16(_round_bf16(u - mean) * inv)
    tl.store(t_ptr + offs, t6.to(tl.bfloat16), mask=m)
    pb = ps_ptr + ((b * n_t + t) * 2) * C + ch
    tl.store(pb, tl.sum(t6, axis=0))
    tl.store(pb + C, tl.sum(_round_bf16(t6 * xh), axis=0))


def launch(dxp, dxpb, u6, coefs, sched, dx, t6, ps):
    B, H, W, C = u6.shape
    n_t = n_blocks(H * W)
    sched_bwd_kernel[(n_t, B)](
        dxp, dxp if dxpb is None else dxpb, u6, coefs, sched, dx, t6, ps, H * W, n_t,
        HAS_B=dxpb is not None, C=C, PIX=PIX, num_warps=4)
