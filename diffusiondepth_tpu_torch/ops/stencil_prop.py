"""Stencil-compiled non-local propagation, NLSPN's inner loop (port of
``diffusiondepth_tpu/ops/stencil_prop.py``).

NLSPN's propagation step is a modulated deformable convolution of the
1-channel depth map with a frozen all-ones 3x3 kernel: per pixel, 9 taps
at ``p + tap_k + offset_k(p)`` are read bilinearly and weighted by their
affinity. The offsets and affinities are fixed over the ``prop_time``
steps, so they are compiled once into a dense local stencil

    M[p, dy, dx] = sum_k aff_k(p) * bilinear_weight_k(p, dy, dx)

over a (D x D) window of integer displacements (D = 2R + 4 for offset
radius R), and every step is a shift-and-multiply-accumulate

    out(p) = sum_{dy, dx} M[p, dy, dx] * depth(p + dy - R - 1, p + dx - R - 1).

Offsets are clamped to [-R, R]: exact for |offset| <= R. Shifted reads
outside the image are zero, as the bilinear sampler's invalid corners.

Memory, the part the JAX package leaves to XLA's fusion. At NLSPN's
training shape M is (8, 240, 1216, 256) f32, 2.39 GB. ``build_stencil``
scatters each tap's four bilinear weights (aff_k * wy * wx) into their
slots, so autograd keeps the (B, H, W, 36) slot indices and the per-tap
weights, not nine (B, H, W, 256) products. ``stencil_apply`` is an
``autograd.Function`` linear in M and the depth map: it keeps M (the same
tensor at every step) and its (B, H, W, 1) input, and forms dM and the
input's gradient from strided views of the padded map in the backward.
Forward and backward run a sample at a time, so no temporary is larger
than one sample's M.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window_size(radius: int) -> int:
    """D such that every bilinear corner of tap + clamped offset fits:
    displacements span [-(R+1), R+2]."""
    return 2 * radius + 4


def build_stencil(offset: torch.Tensor, aff: torch.Tensor, radius: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Compile (offset, affinity) into the dense stencil M (B, H, W, D*D).

    offset: (B, H, W, 2K), (dy, dx) pairs per tap of a square tap grid
    ({-1, 0, 1}^2 for 3x3), DCNv2's channel convention; aff: (B, H, W, K).
    Slot (iy, ix) is channel iy * D + ix. Matches
    ``modulated_deform_conv(feat, offset, aff, ones((3, 3, 1, 1)),
    padding=1)`` wherever every |offset| <= radius."""
    b, h, w, two_k = offset.shape
    K = two_k // 2
    kh = kw = int(round(K ** 0.5))
    if kh * kw != K:
        raise ValueError("stencil_prop supports square tap grids")
    D = window_size(radius)
    R1 = radius + 1
    dev = offset.device

    off = offset.float().reshape(b, h, w, K, 2)
    k = torch.arange(K, device=dev)
    tap_y = (k // kw - (kh - 1) // 2).float()
    tap_x = (k % kw - (kw - 1) // 2).float()

    def axis(tap, o):
        """Per tap: the first slot along one axis and the weights of it and
        the next: (B, H, W, K) long, (B, H, W, K, 2)."""
        s = tap + torch.clamp(o, -radius, radius)  # continuous displacement
        f0 = torch.floor(s)
        w1 = s - f0
        return f0.long() + R1, torch.stack([1.0 - w1, w1], dim=-1)

    iy0, wy = axis(tap_y, off[..., 0])
    ix0, wx = axis(tap_x, off[..., 1])
    two = torch.arange(2, device=dev)
    idx = ((iy0[..., None] + two)[..., :, None] * D
           + (ix0[..., None] + two)[..., None, :])  # (B, H, W, K, 2, 2)
    vals = aff.float()[..., None, None] * (wy[..., :, None] * wx[..., None, :])
    M = torch.zeros(b, h, w, D * D, device=dev, dtype=torch.float32)
    M = M.scatter_add(-1, idx.reshape(b, h, w, 4 * K), vals.reshape(b, h, w, 4 * K))
    return M.to(dtype)


def _shifts(fpad: torch.Tensor, h: int, w: int, D: int) -> torch.Tensor:
    """(b, h, w, D, D) strided view of a padded (b, h + D, w + D) map:
    [.., y, x, iy, ix] = fpad[.., y + iy, x + ix]. No copy."""
    sb, sh, sw = fpad.stride()
    return fpad.as_strided((fpad.shape[0], h, w, D, D), (sb, sh, sw, sh, sw))


def _pad(feat: torch.Tensor, radius: int) -> torch.Tensor:
    D, R1 = window_size(radius), radius + 1
    return F.pad(feat[..., 0], (R1, D - R1, R1, D - R1)).contiguous()


class _StencilStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, M, feat, radius):
        b, h, w, _ = feat.shape
        D = window_size(radius)
        ctx.radius = radius
        ctx.save_for_backward(M, feat)
        fpad = _pad(feat, radius).to(M.dtype)
        out = torch.empty(b, h, w, device=M.device, dtype=torch.float32)
        for i in range(b):  # one sample's product at a time
            prod = M[i:i + 1].reshape(1, h, w, D, D) * _shifts(fpad[i:i + 1], h, w, D)
            torch.sum(prod, dim=(-2, -1), dtype=torch.float32, out=out[i:i + 1])
        return out[..., None].to(feat.dtype)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        M, feat = ctx.saved_tensors
        radius = ctx.radius
        b, h, w, _ = feat.shape
        D, R1 = window_size(radius), radius + 1
        g = g.to(M.dtype)
        dM = dfeat = None
        if ctx.needs_input_grad[0]:
            # dM[p, d] = g[p] * shift_d(feat)[p]
            fpad = _pad(feat, radius).to(M.dtype)
            dM = torch.empty(b, h, w, D, D, device=M.device, dtype=M.dtype)
            for i in range(b):
                torch.mul(_shifts(fpad[i:i + 1], h, w, D), g[i:i + 1, ..., None],
                          out=dM[i:i + 1])
            dM = dM.reshape(b, h, w, D * D)
        if ctx.needs_input_grad[1]:
            # the transposed stencil: fold, the adjoint of the shifted reads
            dpad = []
            for i in range(b):
                p = (M[i].reshape(h * w, D * D) * g[i].reshape(h * w, 1)).t()
                dpad.append(F.fold(p[None], (h + D - 1, w + D - 1), D))
            dfeat = torch.cat(dpad)[:, 0, R1:R1 + h, R1:R1 + w, None].to(feat.dtype)
        return dM, dfeat, None


def stencil_apply(M: torch.Tensor, feat: torch.Tensor, radius: int) -> torch.Tensor:
    """One propagation step: out = sum_d M_d * shift_d(feat).

    M: (B, H, W, D*D) from ``build_stencil``; feat: (B, H, W, 1). Returns
    (B, H, W, 1) in feat's dtype, summed in M's (f32)."""
    return _StencilStep.apply(M, feat, radius)
