"""Depth <-> latent transforms (port of
``diffusiondepth_tpu/models/depth_transform.py``): the six registered
transforms and ``build_depth_transform``.

``t`` encodes metric depth (B, H, W, 1) into a latent; ``inv_t(value,
running=False)`` decodes it to depth (B, H, W, 1). ``running=True`` makes
the decoder's BatchNorms use their running statistics in training mode
too (the ``vis`` heads decode every step's latent that way). The learned
transforms decode through ``depth = 1 / clamp(sigmoid(.), eps) - 1``,
computed in f32 whatever the compute dtype (depths reach 1/eps = 1e6).

State-dict names: the default transform keeps the reference's
``conv_transform.{0,1}.{0,1}`` and ``conv_inv_transform.{0,1,3.0}``; the
others follow the same layout, one ``nn.Sequential`` index per layer of
the JAX module, in its order:

* ``...X4``: ``conv_transform.{0,1,2}.{0,1}``; ``conv_inv_transform.0``
  (the first deconv: bias, no BN or activation), ``.1`` (the second
  deconv, no bias), ``.2`` (its BN), ``.3`` (ReLU), ``.4.0`` (output conv);
* ``...1x1``: ``conv_transform.{0,1}`` (the 1x1 convs, no bias), the
  decoder as the default's;
* ``DeepDepthTransform``: ``conv_transform.{0,1}.{0,1}``,
  ``conv_inv_transform.{0,1}.{0,1}``;
* the two reciprocal transforms have no parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..registry import DEPTH_TRANSFORMS
from .common import (
    BatchNorm2d, ConvBNAct, conv2d_nhwc, conv_transpose2d_nhwc, max_pool2d,
)


def _reciprocal_decode(v: torch.Tensor, eps: float) -> torch.Tensor:
    return 1.0 / torch.clamp(v.float(), min=eps) - 1.0


def _deconv(x: torch.Tensor, deconv: nn.ConvTranspose2d, dtype) -> torch.Tensor:
    """The k4 s2 p1 transposed conv: an exact 2x upsampling."""
    return conv_transpose2d_nhwc(x, deconv.weight, deconv.bias, 2, 1, 0, dtype)


def _decoder(hidden: int) -> nn.Sequential:
    """deconv k4 s2 p1 (bias), BN, ReLU, output conv (bias): the default
    transform's decoder (reference ``conv_inv_transform``)."""
    return nn.Sequential(
        nn.ConvTranspose2d(hidden, hidden, 4, 2, 1, 0, bias=True),
        BatchNorm2d(hidden),
        nn.ReLU(),
        nn.Sequential(nn.Conv2d(hidden, 1, 3, 1, 1, bias=True)),
    )


def _decode(seq: nn.Sequential, value: torch.Tensor, dtype, eps: float,
            running: bool) -> torch.Tensor:
    deconv, bn, _, out = seq
    x = F.relu(bn(_deconv(value, deconv, dtype), dtype, running))
    x = conv2d_nhwc(x, out[0].weight, out[0].bias, 1, 1, dtype)
    return _reciprocal_decode(torch.sigmoid(x), eps)


@DEPTH_TRANSFORMS.register()
class DeepDepthTransformWithUpsampling(nn.Module):
    """Stride-2 conv encoder with Tanh; x2 deconv decoder with Sigmoid."""

    def __init__(self, hidden: int = 16, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.conv_transform = nn.Sequential(
            ConvBNAct(1, hidden, 3, 2, 1, act="leaky_relu", dtype=dtype),
            ConvBNAct(hidden, hidden, 3, 1, 1, act=None, dtype=dtype),
        )
        self.conv_inv_transform = _decoder(hidden)

    def t(self, depth: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv_transform[1](self.conv_transform[0](depth)))

    def inv_t(self, value: torch.Tensor, running: bool = False) -> torch.Tensor:
        return _decode(self.conv_inv_transform, value, self.dtype, self.eps, running)


@DEPTH_TRANSFORMS.register()
class DeepDepthTransformWithUpsampling1x1(nn.Module):
    """1x1-conv encoder with Tanh, then a 3x3 stride-2 max pool; the
    default decoder."""

    def __init__(self, hidden: int = 16, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.conv_transform = nn.Sequential(
            nn.Conv2d(1, hidden, 1, bias=False), nn.Conv2d(hidden, hidden, 1, bias=False))
        self.conv_inv_transform = _decoder(hidden)

    def t(self, depth: torch.Tensor) -> torch.Tensor:
        x = depth
        for conv in self.conv_transform:
            x = conv2d_nhwc(x, conv.weight, None, 1, 0, self.dtype)
        return max_pool2d(torch.tanh(x), 3, 2, 1)

    def inv_t(self, value: torch.Tensor, running: bool = False) -> torch.Tensor:
        return _decode(self.conv_inv_transform, value, self.dtype, self.eps, running)


@DEPTH_TRANSFORMS.register()
class DeepDepthTransformWithUpsamplingX4(nn.Module):
    """Two stride-2 convs and one stride-1 conv with Tanh (a quarter-
    resolution latent); two x2 deconvs, the first without BN or
    activation, then the output conv with Sigmoid."""

    def __init__(self, hidden: int = 16, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.conv_transform = nn.Sequential(
            ConvBNAct(1, hidden, 3, 2, 1, act="leaky_relu", dtype=dtype),
            ConvBNAct(hidden, hidden, 3, 2, 1, act="leaky_relu", dtype=dtype),
            ConvBNAct(hidden, hidden, 3, 1, 1, act=None, dtype=dtype),
        )
        self.conv_inv_transform = nn.Sequential(
            nn.ConvTranspose2d(hidden, hidden, 4, 2, 1, 0, bias=True),
            nn.ConvTranspose2d(hidden, hidden, 4, 2, 1, 0, bias=False),
            BatchNorm2d(hidden),
            nn.ReLU(),
            nn.Sequential(nn.Conv2d(hidden, 1, 3, 1, 1, bias=True)),
        )

    def t(self, depth: torch.Tensor) -> torch.Tensor:
        x = depth
        for layer in self.conv_transform:
            x = layer(x)
        return torch.tanh(x)

    def inv_t(self, value: torch.Tensor, running: bool = False) -> torch.Tensor:
        up1, up2, bn, _, out = self.conv_inv_transform
        x = _deconv(value, up1, self.dtype)
        x = F.relu(bn(_deconv(x, up2, self.dtype), self.dtype, running))
        x = conv2d_nhwc(x, out[0].weight, out[0].bias, 1, 1, self.dtype)
        return _reciprocal_decode(torch.sigmoid(x), self.eps)


@DEPTH_TRANSFORMS.register()
class DeepDepthTransform(nn.Module):
    """Full-resolution variant: two conv + BN layers each way."""

    def __init__(self, hidden: int = 16, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.conv_transform = nn.Sequential(
            ConvBNAct(1, hidden, 3, 1, 1, act="leaky_relu", dtype=dtype),
            ConvBNAct(hidden, hidden, 3, 1, 1, act=None, dtype=dtype),
        )
        self.conv_inv_transform = nn.Sequential(
            ConvBNAct(hidden, hidden, 3, 1, 1, act="leaky_relu", dtype=dtype),
            ConvBNAct(hidden, 1, 3, 1, 1, act=None, dtype=dtype),
        )

    def t(self, depth: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv_transform[1](self.conv_transform[0](depth)))

    def inv_t(self, value: torch.Tensor, running: bool = False) -> torch.Tensor:
        dec1, dec2 = self.conv_inv_transform
        x = torch.sigmoid(dec2(dec1(value, running), running))
        return _reciprocal_decode(x, self.eps)


@DEPTH_TRANSFORMS.register()
class ReciprocalDepthTransform(nn.Module):
    """t(d) = a / clamp(1 + max(d, 0), eps) + b; parameter-free."""

    def __init__(self, linear=(1.0, 0.0), eps: float = 1e-6):
        super().__init__()
        self.linear = tuple(linear)
        self.eps = eps

    def t(self, depth: torch.Tensor) -> torch.Tensor:
        a, b = self.linear
        return a / torch.clamp(1.0 + torch.clamp(depth, min=0.0), min=self.eps) + b

    def inv_t(self, value: torch.Tensor, running: bool = False) -> torch.Tensor:
        a, b = self.linear
        return a / torch.clamp(value - b, min=self.eps) - 1.0


@DEPTH_TRANSFORMS.register()
class ReciprocalDepthTransformII(nn.Module):
    """t(d) = min_depth / max(d, min_depth); parameter-free."""

    def __init__(self, min_depth: float = 0.5):
        super().__init__()
        self.min_depth = min_depth

    def t(self, depth: torch.Tensor) -> torch.Tensor:
        return self.min_depth / torch.clamp(depth, min=self.min_depth)

    def inv_t(self, value: torch.Tensor, running: bool = False) -> torch.Tensor:
        return self.min_depth / value


def build_depth_transform(cfg, **kwargs) -> nn.Module:
    """From an mmcv-style cfg dict, e.g. ``dict(type=
    'DeepDepthTransformWithUpsampling', hidden=16, eps=1e-6)``, the heads'
    default."""
    return DEPTH_TRANSFORMS.build(cfg, **kwargs)
