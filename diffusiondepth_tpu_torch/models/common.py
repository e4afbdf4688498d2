"""Shared building blocks, NHWC (port of ``diffusiondepth_tpu/models/common.py``).

Parameters are float32 and keep the reference torch layouts and names
(Conv2d OIHW, ConvTranspose2d (I, O, kh, kw), Linear (O, I)). A module built
with ``dtype=torch.bfloat16`` casts its input and parameters to bf16 for the
product and adds the bias in bf16, as flax modules do under the bf16
policy; normalisations compute their statistics in f32.

``conv2d_nhwc`` (``groups == 1``), ``conv_transpose2d_nhwc`` and
``linear`` are column-parallel where their weight is a shard of a
tensor-parallel state (``parallel/tensor.py``): each rank computes its
output features, which are gathered along the last dim before the bias is
added; a grouped conv takes its weight whole.

``BatchNorm2d`` uses its running statistics in eval mode and the batch
statistics in training mode. ``LayerNorm`` is the JAX package's opt-in
LayerNorm module, whose bf16 branch runs the kernels K9/K10.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.layernorm import LayerNormBF16
from ..parallel.mesh import all_reduce_sum, data_mesh
from ..parallel.tensor import copy_to_model, gather_from_model, shard_info, whole


def _dt(dtype: Optional[torch.dtype], *ts: torch.Tensor) -> torch.dtype:
    if dtype is not None:
        return dtype
    out = ts[0].dtype
    for t in ts[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def _column_parallel(x: torch.Tensor, weight: torch.Tensor, dt: torch.dtype, product):
    """``product(x, w)`` (an NHWC or (..., features) output) with ``weight``
    whole, or, where it is a shard, this rank's output features gathered
    over the model group."""
    sh = shard_info(weight)
    if sh is None:
        return product(x.to(dt), weight.to(dt))
    return gather_from_model(product(copy_to_model(x.to(dt), sh), weight.to(dt)), sh)


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int = 1, padding: int = 0,
                dtype: Optional[torch.dtype] = None, groups: int = 1) -> torch.Tensor:
    dt = _dt(dtype, x, weight)
    if groups > 1:
        weight = whole(weight)

    def product(xt, w):
        y = F.conv2d(xt.permute(0, 3, 1, 2), w, None, stride, padding, 1, groups)
        return y.permute(0, 2, 3, 1)

    y = _column_parallel(x, weight, dt, product)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def conv_transpose2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], stride: int,
                          padding: int, output_padding: int,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dt = _dt(dtype, x, weight)

    def product(xt, w):
        y = F.conv_transpose2d(xt.permute(0, 3, 1, 2), w, None, stride, padding,
                               output_padding)
        return y.permute(0, 2, 3, 1)

    y = _column_parallel(x, weight, dt, product)
    if bias is not None:
        y = y + bias.to(dt)
    return y


def linear(x: torch.Tensor, lin: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    dt = _dt(dtype, x, lin.weight)
    if shard_info(lin.weight) is None:
        return F.linear(x.to(dt), lin.weight.to(dt),
                        None if lin.bias is None else lin.bias.to(dt))
    y = _column_parallel(x, lin.weight, dt, F.linear)
    return y if lin.bias is None else y + lin.bias.to(dt)


def act_fn(x: torch.Tensor, name: Optional[str], negative_slope: float = 0.2) -> torch.Tensor:
    if name is None:
        return x
    if name == "relu":
        return F.relu(x)
    if name == "leaky_relu":
        return F.leaky_relu(x, negative_slope)
    if name == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(name)


class BatchNorm2d(nn.Module):
    """BatchNorm over an NHWC map with the reference's parameter and buffer
    names; f32 arithmetic, output in the compute dtype.

    Training mode normalises with the batch statistics as flax does (mean
    and var = E[x^2] - E[x]^2, the biased variance, clamped at 0) and
    updates the running statistics by hand with torch momentum 0.1 (flax
    momentum 0.9) from that biased variance; ``F.batch_norm`` would store
    the unbiased one. Under an active data-parallel mesh the statistics are
    the global batch's, as in JAX's cross-replica BatchNorm: (sum x,
    sum x^2, count) go through one differentiable all-reduce, in f32, and
    every rank updates the same running statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None,
                running: bool = False) -> torch.Tensor:
        """``running=True`` normalises with the running statistics in
        training mode too (flax's ``use_running_average``)."""
        if self.training and not running:
            xf = x.float()
            axes = tuple(range(xf.ndim - 1))
            if data_mesh() is None:
                mean = xf.mean(axes)
                var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            else:
                c = xf.shape[-1]
                sums = all_reduce_sum(torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                                                 xf.new_full((1,), xf.numel() // c)]))
                mean = sums[:c] / sums[-1]
                var = torch.clamp_min(sums[c:2 * c] / sums[-1] - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var + m * var)
        else:
            xf, mean, var = x.float(), self.running_mean, self.running_var
        y = xf - mean
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (y * mul + self.bias).to(_dt(dtype, x))


def dropout(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's ``Dropout`` with a drawn ``keep_mask`` of ``x``'s shape: the
    kept elements scaled by 1 / (1 - rate) in ``x``'s type, the rest 0."""
    return torch.where(keep_mask, x / (1.0 - rate), torch.zeros_like(x))


def drop_path(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth: ``keep_mask`` (B,) bool keeps a sample's residual
    branch, scaled by 1 / (1 - rate), and zeroes it otherwise."""
    keep = keep_mask.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ConvBNAct(nn.Sequential):
    """Conv2d [+ BatchNorm] [+ activation], children ``0`` (conv) and ``1``
    (bn) as in the reference's ``nn.Sequential``. The conv has a bias only
    when BatchNorm is off (``use_bn=False``: the reference ``conv_bn_relu``
    with ``bn=False``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 0, act: Optional[str] = "leaky_relu",
                 dtype: Optional[torch.dtype] = None, use_bn: bool = True):
        layers = [nn.Conv2d(cin, cout, kernel, stride, padding, bias=not use_bn)]
        if use_bn:
            layers.append(BatchNorm2d(cout))
        super().__init__(*layers)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor, running: bool = False) -> torch.Tensor:
        """``running=True``: the BatchNorm uses its running statistics in
        training mode too."""
        conv = self[0]
        y = conv2d_nhwc(x, conv.weight, conv.bias, conv.stride, conv.padding, self.dtype)
        if len(self) > 1:
            y = self[1](y, self.dtype, running)
        return act_fn(y, self.act)


# kernel -> the torch (padding, output_padding) of an exact 2x upsampling
_DECONV_PAD = {2: (0, 0), 3: (1, 1), 4: (1, 0)}


class DeconvBNAct(nn.Sequential):
    """ConvTranspose2d, stride 2 (exact 2x upsampling, no bias) + BatchNorm
    + activation, children ``0`` (deconv) and ``1`` (bn). The defaults are
    the FPN up-path's k2 + ReLU; NLSPN's decoder (the reference
    ``convt_bn_relu``) is k3, padding 1, output padding 1 + LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, dtype: Optional[torch.dtype] = None,
                 kernel: int = 2, act: Optional[str] = "relu"):
        super().__init__(nn.ConvTranspose2d(cin, cout, kernel, 2, bias=False), BatchNorm2d(cout))
        self.dtype = dtype
        self.kernel = kernel
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv, bn = self
        pad, out_pad = _DECONV_PAD[self.kernel]
        y = conv_transpose2d_nhwc(x, deconv.weight, None, 2, pad, out_pad, self.dtype)
        return act_fn(bn(y, self.dtype), self.act)


def max_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """torch MaxPool2d on an NHWC map (the border pads with -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding)
    return y.permute(0, 2, 3, 1)


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


class LayerNorm(nn.Module):
    """Last-dim LayerNorm with an affine (port of the JAX package's
    ``models/common.py::LayerNorm``), parameters ``weight``/``bias`` (JAX's
    ``scale``/``bias``). ``dtype`` not bf16: f32 statistics and
    normalisation, output in ``dtype`` or the input's type. bf16: the
    input is cast to bf16 and ``LayerNormBF16`` runs (K9 forward, K10
    backward on the card, at any width and from any view), output bf16.
    No model of the port builds it: the Swin blocks use ``layer_norm``, as
    the JAX ones use flax's."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype != torch.bfloat16:
            xf = x.float()
            mean = xf.mean(-1, keepdim=True)
            var = ((xf - mean) ** 2).mean(-1, keepdim=True)
            y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
            return y.to(self.dtype or x.dtype)
        return LayerNormBF16.apply(x.to(torch.bfloat16), self.weight, self.bias, self.eps)
