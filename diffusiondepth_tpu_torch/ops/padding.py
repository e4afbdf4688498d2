"""Adaptive padding and a generic conv patch embedding for NHWC maps (port
of ``diffusiondepth_tpu/ops/padding.py``): the standalone helpers for
custom backbones. The Swin backbone pads to its patch size inline.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.common import layer_norm
from ..parallel.tensor import whole


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def adaptive_pad(
    x: torch.Tensor,
    kernel_size: Union[int, Tuple[int, int]],
    stride: Union[int, Tuple[int, int]] = 1,
    dilation: Union[int, Tuple[int, int]] = 1,
    mode: str = "corner",
) -> torch.Tensor:
    """Zero-pad an NHWC map so that a VALID conv covers it fully:
    ``'corner'`` pads bottom and right only, ``'same'`` splits the pad
    evenly (the extra pixel at the bottom and right)."""
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    h, w = x.shape[1], x.shape[2]
    pad_h = max((-(-h // sh) - 1) * sh + (kh - 1) * dh + 1 - h, 0)
    pad_w = max((-(-w // sw) - 1) * sw + (kw - 1) * dw + 1 - w, 0)
    if pad_h == 0 and pad_w == 0:
        return x
    if mode == "corner":
        top, left = 0, 0
    elif mode == "same":
        top, left = pad_h // 2, pad_w // 2
    else:
        raise ValueError(mode)
    # F.pad takes the last axes first: (C), W, H
    return F.pad(x, (0, 0, left, pad_w - left, top, pad_h - top))


class PatchEmbed(nn.Module):
    """Conv patch embedding after ``adaptive_pad``, then an optional
    LayerNorm (eps 1e-5, f32 statistics). Names ``projection`` and
    ``norm``; the conv has a bias."""

    def __init__(self, in_channels: int = 3, embed_dims: int = 768, kernel_size: int = 16,
                 stride: Optional[int] = None, dilation: int = 1, pad_mode: str = "corner",
                 use_norm: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stride = stride or kernel_size
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.pad_mode = pad_mode
        self.dtype = dtype
        self.projection = nn.Conv2d(in_channels, embed_dims, kernel_size, self.stride,
                                    dilation=dilation)
        self.norm = nn.LayerNorm(embed_dims, eps=1e-5) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = adaptive_pad(x, self.kernel_size, self.stride, self.dilation, self.pad_mode)
        p = self.projection
        dt = self.dtype or torch.promote_types(x.dtype, p.weight.dtype)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), whole(p.weight).to(dt), None, p.stride, 0,
                     p.dilation).permute(0, 2, 3, 1) + p.bias.to(dt)
        if self.norm is not None:
            y = layer_norm(y, self.norm, self.dtype)
        return y
