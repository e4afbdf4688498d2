"""Last-dim LayerNorm with bf16 traffic and f32 statistics, and its
backward.

Port of ``diffusiondepth_tpu/ops/layernorm.py``: ``layernorm_fwd`` launches
the Triton kernel K9 and ``layernorm_bwd`` the Triton kernel K10
(``csrc/layernorm.py``) on a CUDA tensor; both run their plain versions,
the JAX package's ``_ln_jnp_fwd`` / ``_ln_jnp_bwd``, on a CPU tensor.
``LayerNormBF16`` is the counterpart of the ``layernorm_bf16`` custom_vjp:
forward K9, backward K10, with the input and the per-row (mean, inv) as
residuals. ``models/common.py::LayerNorm`` calls it under the bf16 policy.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import native

BF16 = torch.bfloat16


def layernorm_fwd_plain(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (M, C) -> (y (M, C) in x2's type, mean (M,) f32, inv (M,) f32),
    statistics and normalisation in f32."""
    xf = x2.float()
    c = x2.shape[-1]
    mean = xf.sum(-1) / c
    d = xf - mean[:, None]
    var = (d * d).sum(-1) / c
    inv = torch.rsqrt(var + eps)
    y = d * inv[:, None] * scale.float() + bias.float()
    return y.to(x2.dtype), mean, inv


def layernorm_bwd_plain(x2: torch.Tensor, dy2: torch.Tensor, mean: torch.Tensor,
                        inv: torch.Tensor, scale: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dx (M, C) in x2's type, dscale (C,) f32, dbias (C,) f32), with
    xhat recomputed from x2, mean and inv."""
    xf = x2.float()
    dyf = dy2.float()
    c = x2.shape[-1]
    xhat = (xf - mean[:, None]) * inv[:, None]
    t = dyf * scale.float()
    m1 = t.sum(-1) / c
    m2 = (t * xhat).sum(-1) / c
    dx = (t - m1[:, None] - xhat * m2[:, None]) * inv[:, None]
    return dx.to(x2.dtype), (dyf * xhat).sum(0), dyf.sum(0)


def layernorm_fwd(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (M, C) bf16, scale and bias (C,) f32 -> (y (M, C) bf16, mean (M,)
    f32, inv (M,) f32): kernel K9 on the card, the plain version for a CPU
    tensor."""
    native.no_autograd("layernorm_fwd", x2, scale, bias)
    if x2.device.type == "cpu":
        return layernorm_fwd_plain(x2, scale, bias, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    m, c = x2.shape
    native.check_tensors("layernorm_fwd", ((x2, (m, c), BF16), (scale, (c,), torch.float32),
                                           (bias, (c,), torch.float32)), x2.device)
    y = torch.empty_like(x2)
    mean = torch.empty(m, dtype=torch.float32, device=x2.device)
    inv = torch.empty(m, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        native.triton_module("layernorm").fwd_launch(x2, scale, bias, float(eps), y, mean, inv)
    native.LAUNCHES["layernorm_fwd"] += 1
    return y, mean, inv


def layernorm_bwd(x2: torch.Tensor, dy2: torch.Tensor, mean: torch.Tensor,
                  inv: torch.Tensor, scale: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx (M, C) bf16, dscale (C,) f32, dbias (C,) f32) of ``layernorm_fwd``
    for dy2 (M, C) bf16: kernel K10 on the card, the plain version for a
    CPU tensor. dscale and dbias are reduced from per-program partials in a
    fixed order, so two launches on the same inputs give the same bits."""
    native.no_autograd("layernorm_bwd", x2, dy2, mean, inv, scale)
    if x2.device.type == "cpu":
        return layernorm_bwd_plain(x2, dy2, mean, inv, scale)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    m, c = x2.shape
    native.check_tensors("layernorm_bwd", ((x2, (m, c), BF16), (dy2, (m, c), BF16),
                                           (mean, (m,), torch.float32),
                                           (inv, (m,), torch.float32),
                                           (scale, (c,), torch.float32)), x2.device)
    mod = native.triton_module("layernorm")
    dx = torch.empty_like(x2)
    part = torch.empty((mod.bwd_programs(m), 2, c), dtype=torch.float32, device=x2.device)
    ds = torch.empty(c, dtype=torch.float32, device=x2.device)
    db = torch.empty(c, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        mod.bwd_launch(x2, dy2, mean, inv, scale, dx, part, ds, db)
    native.LAUNCHES["layernorm_bwd"] += 1
    return dx, ds, db


class LayerNormBF16(torch.autograd.Function):
    """Differentiable last-dim LayerNorm of a bf16 input: forward K9,
    backward K10. Saves the (M, C) input, the per-row mean and inv and the
    scale; the cotangent is cast to bf16 before K10, as the JAX custom_vjp
    does. ``apply(x, scale, bias, eps)`` with x bf16 and scale, bias (C,)
    f32; returns bf16 of x's shape."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, mean, inv = layernorm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, mean, inv, scale)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, mean, inv, scale = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).to(x2.dtype).contiguous()
        dx, ds, db = layernorm_bwd(x2, dy2, mean, inv, scale)
        return dx.reshape(dy.shape), ds.to(scale.dtype), db.to(scale.dtype), None
