"""Shared building blocks, NHWC (port of ``diffusiondepth_tpu/models/common.py``).

Parameters are float32 and keep the reference torch layouts and names
(Conv2d OIHW, ConvTranspose2d (I, O, kh, kw), Linear (O, I)). A module built
with ``dtype=torch.bfloat16`` casts its input and parameters to bf16 for the
product and adds the bias in bf16, as flax modules do under the bf16
policy; normalisations compute their statistics in f32.

The slice is the eval path: ``BatchNorm2d`` uses its running statistics and
has no training mode yet (ROADMAP, training slice).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _dt(dtype: Optional[torch.dtype], *ts: torch.Tensor) -> torch.dtype:
    if dtype is not None:
        return dtype
    out = ts[0].dtype
    for t in ts[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int = 1, padding: int = 0,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dt = _dt(dtype, x, weight)
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), weight.to(dt), None, stride, padding)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def conv_transpose2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], stride: int,
                          padding: int, output_padding: int,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dt = _dt(dtype, x, weight)
    y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), weight.to(dt), None,
                           stride, padding, output_padding)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def linear(x: torch.Tensor, lin: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    dt = _dt(dtype, x, lin.weight)
    return F.linear(x.to(dt), lin.weight.to(dt),
                    None if lin.bias is None else lin.bias.to(dt))


def act_fn(x: torch.Tensor, name: Optional[str], negative_slope: float = 0.2) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return F.relu(x)
    if name == "leaky_relu":
        return F.leaky_relu(x, negative_slope)
    raise ValueError(name)


class BatchNorm2d(nn.Module):
    """Eval BatchNorm with the reference's parameter and buffer names;
    f32 arithmetic, output in the compute dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm2d of the port is eval-only; training is the next "
                "slice (ROADMAP Queue 1, M10)")
        y = x.float() - self.running_mean
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (y * mul + self.bias).to(_dt(dtype, x))


class ConvBNAct(nn.Sequential):
    """Conv2d (no bias) + BatchNorm [+ activation], children ``0`` (conv)
    and ``1`` (bn) as in the reference's ``nn.Sequential``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, act: Optional[str] = "leaky_relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(nn.Conv2d(cin, cout, kernel, stride, padding, bias=False),
                         BatchNorm2d(cout))
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self
        y = conv2d_nhwc(x, conv.weight, None, conv.stride, conv.padding, self.dtype)
        return act_fn(bn(y, self.dtype), self.act)


class DeconvBNAct(nn.Sequential):
    """ConvTranspose2d k2 s2 (exact 2x upsampling, no bias) + BatchNorm +
    ReLU, children ``0`` (deconv) and ``1`` (bn): the FPN up-path."""

    def __init__(self, cin: int, cout: int, dtype: Optional[torch.dtype] = None):
        super().__init__(nn.ConvTranspose2d(cin, cout, 2, 2, bias=False), BatchNorm2d(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv, bn = self
        y = conv_transpose2d_nhwc(x, deconv.weight, None, 2, 0, 0, self.dtype)
        return F.relu(bn(y, self.dtype))


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """GroupNorm (eps 1e-5) over an NHWC map.

    f32: flax's arithmetic (var = E[x^2] - E[x]^2). bf16: the JAX package's
    bf16 GroupNorm, statistics from f32-accumulated sums, normalisation
    arithmetic in bf16."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    if dtype != torch.bfloat16:
        xf = x.float().reshape(b, -1, num_groups, cg)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean, 0.0)
        y = xf - mean
        mul = torch.rsqrt(var + 1e-5) * weight.float().reshape(1, 1, num_groups, cg)
        y = y * mul + bias.float().reshape(1, 1, num_groups, cg)
        return y.reshape(x.shape).to(_dt(dtype, x))
    xb = x.to(torch.bfloat16)
    x2 = xb.reshape(b, -1, c)
    n_group = x2.shape[1] * cg
    s1 = x2.float().sum(1).reshape(b, num_groups, cg).sum(-1)
    s2 = (x2 * x2).float().sum(1).reshape(b, num_groups, cg).sum(-1)
    mean = s1 / n_group
    var = torch.clamp_min(s2 / n_group - mean * mean, 0.0)
    inv = torch.rsqrt(var + 1e-5)
    xg = xb.reshape(b, -1, num_groups, cg)
    xhat = ((xg - mean.to(torch.bfloat16)[:, None, :, None])
            * inv.to(torch.bfloat16)[:, None, :, None]).reshape(x.shape)
    return xhat * weight.to(torch.bfloat16) + bias.to(torch.bfloat16)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Last-dim LayerNorm in f32, output in the compute dtype."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(_dt(dtype, x))
