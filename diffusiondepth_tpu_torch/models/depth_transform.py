"""Depth <-> latent transform (port of ``DeepDepthTransformWithUpsampling``
in ``diffusiondepth_tpu/models/depth_transform.py``), the default of every
DDIM head. The five other registered transforms are still to be ported.

``t`` encodes metric depth (B, H, W, 1) into a 16-channel half-resolution
latent; ``inv_t`` decodes through ``depth = 1 / clamp(sigmoid(.), eps) - 1``,
computed in f32 whatever the compute dtype (depths reach 1/eps = 1e6).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm2d, ConvBNAct, conv2d_nhwc, conv_transpose2d_nhwc


class DeepDepthTransformWithUpsampling(nn.Module):
    """Reference names: ``conv_transform.{0,1}.{0,1}`` (encoder conv + bn),
    ``conv_inv_transform.0`` (deconv k4 s2 p1, bias), ``.1`` (bn), ``.2``
    (ReLU), ``.3.0`` (output conv)."""

    def __init__(self, hidden: int = 16, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.conv_transform = nn.Sequential(
            ConvBNAct(1, hidden, 3, 2, 1, act="leaky_relu", dtype=dtype),
            ConvBNAct(hidden, hidden, 3, 1, 1, act=None, dtype=dtype),
        )
        self.conv_inv_transform = nn.Sequential(
            nn.ConvTranspose2d(hidden, hidden, 4, 2, 1, 0, bias=True),
            BatchNorm2d(hidden),
            nn.ReLU(),
            nn.Sequential(nn.Conv2d(hidden, 1, 3, 1, 1, bias=True)),
        )

    def t(self, depth: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv_transform[1](self.conv_transform[0](depth)))

    def inv_t(self, value: torch.Tensor, running: bool = False) -> torch.Tensor:
        """``running=True``: the BatchNorm uses its running statistics in
        training mode too."""
        deconv, bn, _, out = self.conv_inv_transform
        x = conv_transpose2d_nhwc(value, deconv.weight, deconv.bias, 2, 1, 0, self.dtype)
        x = F.relu(bn(x, self.dtype, running))
        x = conv2d_nhwc(x, out[0].weight, out[0].bias, 1, 1, self.dtype)
        return 1.0 / torch.clamp(torch.sigmoid(x).float(), min=self.eps) - 1.0
