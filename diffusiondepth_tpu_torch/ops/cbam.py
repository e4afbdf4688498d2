"""CBAM channel and spatial attention, NHWC (port of
``diffusiondepth_tpu/ops/cbam.py``), used by the ``BasicBlockWithCBAM``
ResNet block.

Parameter names: ``ChannelAttention.fc1/fc2`` (1x1 convs, no bias),
``SpatialAttention.conv1`` (k x k conv over [mean, max], no bias);
``CBAMWithPosEmbed.dim_reduce`` (3x3 conv + BN + ReLU), ``pos_embed.0/.1``
(the positional MLP, Linear 2 -> 8 -> planes), ``ca``, ``dim_expand`` (1x1
conv + BN + ReLU back to the block's width) and ``sa``. No converter of the
reference's checkpoints reads them; ``utils/convert_jax_params.py`` maps
the JAX modules' trees onto them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.common import ConvBNAct, conv2d_nhwc, linear
from .native import constant


class ChannelAttention(nn.Module):
    def __init__(self, channels: int, ratio: int = 16, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        mid = max(channels // ratio, 1)
        self.fc1 = nn.Conv2d(channels, mid, 1, bias=False)
        self.fc2 = nn.Conv2d(mid, channels, 1, bias=False)

    def _mlp(self, v: torch.Tensor) -> torch.Tensor:
        v = F.relu(conv2d_nhwc(v, self.fc1.weight, None, dtype=self.dtype))
        return conv2d_nhwc(v, self.fc2.weight, None, dtype=self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> sigmoid gate (B, 1, 1, C)."""
        avg = x.mean(dim=(1, 2), keepdim=True)
        mx = x.amax(dim=(1, 2), keepdim=True)
        return torch.sigmoid(self._mlp(avg) + self._mlp(mx))


class SpatialAttention(nn.Module):
    def __init__(self, kernel_size: int = 7, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> sigmoid gate (B, H, W, 1)."""
        s = torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)], dim=-1)
        return torch.sigmoid(conv2d_nhwc(s, self.conv1.weight, None, 1,
                                         self.conv1.padding, self.dtype))


class CBAM(nn.Module):
    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ca = ChannelAttention(channels, dtype=dtype)
        self.sa = SpatialAttention(dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.ca(x)
        return x * self.sa(x)


class CBAMWithPosEmbed(nn.Module):
    """CBAM on a width-``pos_embed_planes`` reduction of the map plus a
    learned 2-D positional MLP; the input position is (x, y) / (W, H) - 0.5,
    computed in the compute type as the JAX module does."""

    def __init__(self, channels: int, pos_embed_planes: int = 16,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.dim_reduce = ConvBNAct(channels, pos_embed_planes, 3, 1, 1, act="relu", dtype=dtype)
        self.pos_embed = nn.Sequential(nn.Linear(2, 8), nn.Linear(8, pos_embed_planes))
        self.ca = ChannelAttention(pos_embed_planes, dtype=dtype)
        self.dim_expand = ConvBNAct(pos_embed_planes, channels, 1, 1, 0, act="relu", dtype=dtype)
        self.sa = SpatialAttention(dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x_r = self.dim_reduce(x)
        dt = x_r.dtype
        yy, xx = torch.meshgrid(torch.arange(h, device=x.device),
                                torch.arange(w, device=x.device), indexing="ij")
        pos = torch.stack([xx, yy], dim=-1).to(dt)
        pos = pos / constant(("cbam_size", w, h), lambda: [w, h], x.device, dt) - 0.5
        f = F.relu(linear(pos, self.pos_embed[0], self.dtype))
        f = F.relu(linear(f, self.pos_embed[1], self.dtype))
        x_r = x_r + f[None]
        x = x * self.dim_expand(self.ca(x_r))
        return x * self.sa(x_r)
