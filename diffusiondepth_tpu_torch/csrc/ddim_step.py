"""The eval DDIM update as a Triton kernel (kernel K3 of the port).

Replaces the TPU kernel diffusiondepth_tpu/ops/fused_denoiser.py
_flat_ddim_kernel (reached through flat_ddim_update), and absorbs the
GroupNorm-3 affine + ReLU finish that the JAX eval path runs in XLA glue
before it (fused_denoiser_apply's last lines):

    eps = relu(round(round(u6 * aeff) + beff))       (bf16 arithmetic)
    x0  = (x - sb * eps) / sa
    eps2 = (x - sa * x0) / sb
    x'  = sp * x0 + sq * eps2                          (f32)

with the four f32 scalars [sqrt(a_t), sqrt(1-a_t), sqrt(a_prev),
sqrt(1-a_prev)] read from a device row, so no step waits on the host.

What bounds it on the H100: bytes. Per latent element it reads u6 (2 B)
and x (4 B) and writes x' (4 B) for about ten f32 operations: ~137 MB per
step at the bs8 eval latent (8, 176, 608, 16), ~41 us at 3.35 TB/s.

What the design does about it: one pass, each byte once, contiguous
1024-element blocks; the per-(batch, channel) affine is gathered from a
(B, 16) table that stays in L1. The TPU's grouped (B, H, G, 128) layout
was a lane-padding workaround and is not carried over.

This file is loaded by ``diffusiondepth_tpu_torch.ops.fused_denoiser`` only
when it launches the kernel: it imports triton, which only the machine
with the card has.
"""

import triton
import triton.language as tl


@triton.jit
def _round_bf16(v):
    """Round f32 to the nearest bf16 (ties to even), kept in f32. Integer
    arithmetic on the bits: a truncf/extf pair can be folded away by the
    compiler, which would skip the rounding."""
    b = v.to(tl.uint32, bitcast=True)
    b = b + 0x7FFF + ((b >> 16) & 1)
    b = (b >> 16) << 16
    return b.to(tl.float32, bitcast=True)


@triton.jit
def ddim_step_kernel(u_ptr, x_ptr, a_ptr, b_ptr, s_ptr, out_ptr, n, per_batch,
                     C: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    bc = (offs // per_batch) * C + offs % C
    u = tl.load(u_ptr + offs, mask=m, other=0.0).to(tl.float32)
    a = _round_bf16(tl.load(a_ptr + bc, mask=m, other=0.0))
    o = _round_bf16(tl.load(b_ptr + bc, mask=m, other=0.0))
    eps = _round_bf16(u * a)
    eps = _round_bf16(eps + o)
    eps = tl.maximum(eps, 0.0)
    x = tl.load(x_ptr + offs, mask=m, other=0.0)
    sa = tl.load(s_ptr)
    sb = tl.load(s_ptr + 1)
    sp = tl.load(s_ptr + 2)
    sq = tl.load(s_ptr + 3)
    x0 = (x - sb * eps) / sa
    e2 = (x - sa * x0) / sb
    tl.store(out_ptr + offs, sp * x0 + sq * e2, mask=m)


def launch(u6, x, aeff, beff, sched, out):
    n = x.numel()
    B, H, W, C = x.shape
    block = 1024
    ddim_step_kernel[(triton.cdiv(n, block),)](
        u6, x, aeff, beff, sched, out, n, H * W * C, C=C, BLOCK=block,
        num_warps=4)
