"""``nn.Module`` wrappers of the deformable-conv family, NHWC (port of
``diffusiondepth_tpu/ops/deform_conv_modules.py``).

The reference's ``deformconv/modules``: ``ModulatedDeformConv`` and
``DeformConv`` take their offsets (and mask) from the caller; the
``*Pack`` variants learn them from the input with an extra convolution,
``conv_offset``, initialised to zero so that they start as plain
convolutions. ``DeformRoIPoolingPack`` learns its part offsets with two
Linear layers, ``offset_fc1`` and ``offset_fc2`` (the second zero). The
weights keep the reference's layout, (Cout, Cin // groups, kh, kw), and
reach the functions of ``deform_conv.py`` as HWIO. No model builds these
modules; they complete the op surface that NLSPN's port brought.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..models.common import conv2d_nhwc, linear
from ..parallel.tensor import whole
from .deform_conv import deform_conv, deform_psroi_pooling, modulated_deform_conv


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    return weight.permute(2, 3, 1, 0)


class _DeformBase(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1, groups: int = 1,
                 deformable_groups: int = 1, bias: bool = True):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.dilation, self.groups, self.deformable_groups = dilation, groups, deformable_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                               kernel_size, kernel_size))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def _conv_offset(self, in_channels: int, per_tap: int) -> nn.Conv2d:
        k = self.kernel_size
        conv = nn.Conv2d(in_channels, self.deformable_groups * per_tap * k * k, k,
                         self.stride, self.padding)
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
        return conv

    def _learned(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv_offset
        return conv2d_nhwc(x, c.weight, c.bias, self.stride, self.padding)


class ModulatedDeformConv(_DeformBase):
    """DCNv2 taking its offsets (B, Ho, Wo, dg * K * 2) and mask
    (B, Ho, Wo, dg * K) from the caller."""

    def forward(self, x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return modulated_deform_conv(x, offset, mask, _hwio(whole(self.weight)), self.bias,
                                     self.stride, self.padding, self.dilation, self.groups,
                                     self.deformable_groups)


class ModulatedDeformConvPack(ModulatedDeformConv):
    """DCNv2 that learns offsets and mask from its input: ``conv_offset``
    emits (o1, o2, mask logits), each dg * K wide; the offsets interleave
    o1 and o2 into per-tap (dy, dx) pairs."""

    def __init__(self, in_channels: int, out_channels: int, *args, **kwargs):
        super().__init__(in_channels, out_channels, *args, **kwargs)
        self.conv_offset = self._conv_offset(in_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        n = self.deformable_groups * self.kernel_size ** 2
        out = self._learned(x)
        o1, o2 = out[..., :n], out[..., n:2 * n]
        mask = torch.sigmoid(out[..., 2 * n:])
        offset = torch.stack([o1, o2], dim=-1).reshape(*o1.shape[:3], 2 * n)
        return super().forward(x, offset, mask)


class DeformConv(_DeformBase):
    """DCN v1 taking its offsets from the caller; no bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1, groups: int = 1,
                 deformable_groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, deformable_groups, bias=False)

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        return deform_conv(x, offset, _hwio(whole(self.weight)), None, self.stride, self.padding,
                           self.dilation, self.groups, self.deformable_groups)


class DeformConvPack(DeformConv):
    """DCN v1 with offsets learned by ``conv_offset``."""

    def __init__(self, in_channels: int, out_channels: int, *args, **kwargs):
        super().__init__(in_channels, out_channels, *args, **kwargs)
        self.conv_offset = self._conv_offset(in_channels, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return super().forward(x, self._learned(x))


class DeformRoIPooling(nn.Module):
    """Deformable PS-RoI pooling with the caller's part offsets."""

    def __init__(self, out_size: int, spatial_scale: float = 1.0, sampling_ratio: int = 2,
                 gamma: float = 0.1):
        super().__init__()
        self.out_size, self.spatial_scale = out_size, spatial_scale
        self.sampling_ratio, self.gamma = sampling_ratio, gamma

    def forward(self, x: torch.Tensor, rois: torch.Tensor,
                offset: Optional[torch.Tensor] = None) -> torch.Tensor:
        return deform_psroi_pooling(x, rois, offset, self.out_size, self.spatial_scale,
                                    self.sampling_ratio, self.gamma)


class DeformRoIPoolingPack(DeformRoIPooling):
    """Learns per-part offsets from a first, offset-free pooling pass:
    ``offset_fc1`` (ReLU) and ``offset_fc2`` (zero-initialised) on the
    flattened (out_size, out_size, c_out) pooling."""

    def __init__(self, out_size: int, in_features: int, spatial_scale: float = 1.0,
                 sampling_ratio: int = 2, gamma: float = 0.1, hidden: int = 256):
        super().__init__(out_size, spatial_scale, sampling_ratio, gamma)
        self.offset_fc1 = nn.Linear(in_features, hidden)
        self.offset_fc2 = nn.Linear(hidden, out_size * out_size * 2)
        nn.init.zeros_(self.offset_fc2.weight)
        nn.init.zeros_(self.offset_fc2.bias)

    def forward(self, x: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        pooled = super().forward(x, rois, None)
        r = pooled.shape[0]
        h = torch.relu(linear(pooled.reshape(r, -1), self.offset_fc1, None))
        off = linear(h, self.offset_fc2, None).reshape(r, self.out_size, self.out_size, 2)
        return super().forward(x, rois, off)
