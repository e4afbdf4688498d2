"""The stemless mmbev ResNet backbone, NHWC (port of
``diffusiondepth_tpu/models/backbones/mmbev_resnet.py``).

Four stages of blocks run straight on the RGB input (no 7x7 stem), strides
(2, 2, 2, 2), widths (64, 128, 256, 512); all four levels are returned
(H/2 .. H/16). Each stage's first block downsamples its identity with a
strided 3x3 conv *with* bias and no BatchNorm (an mmbev quirk). As in the
reference, ``mmbev_res50`` and ``mmbev_res101`` are built from Basic
blocks, not bottlenecks.

Parameter names are the reference's, ``layers.{i}.{j}.conv1/bn1/conv2/bn2
/downsample`` (``conv3/bn3`` in a bottleneck, ``cbam.*`` in a CBAM block),
the names ``convert_resnet_mmbev`` reads. In training mode every
BatchNorm normalises with the batch statistics and updates its running
ones, as flax's does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.cbam import CBAMWithPosEmbed
from ...registry import BACKBONES
from ..common import BatchNorm2d, conv2d_nhwc


class BasicBlock(nn.Module):
    """3x3 (stride) + BN + ReLU -> 3x3 + BN, plus the identity, ReLU."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.Conv2d(cin, planes * self.expansion, 3, stride, 1, bias=True)
                           if downsample else None)

    def _identity(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is None:
            return x
        d = self.downsample
        return conv2d_nhwc(x, d.weight, d.bias, self.stride, 1, self.dtype)

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        out = conv2d_nhwc(x, self.conv1.weight, None, self.stride, 1, self.dtype)
        out = F.relu(self.bn1(out, self.dtype))
        out = conv2d_nhwc(out, self.conv2.weight, None, 1, 1, self.dtype)
        return self.bn2(out, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self._residual(x) + self._identity(x))


class BasicBlockWithCBAM(BasicBlock):
    """BasicBlock with ``CBAMWithPosEmbed`` on the residual branch."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cin, planes, stride, downsample, dtype)
        self.cbam = CBAMWithPosEmbed(planes, min(planes, 16), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.cbam(self._residual(x)) + self._identity(x))


class Bottleneck(BasicBlock):
    """mmdet Bottleneck (style 'pytorch'): 1x1 -> 3x3 (stride) -> 1x1 (x4)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(cin, planes, stride, downsample, dtype)
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv2d_nhwc(x, self.conv1.weight, None, dtype=self.dtype),
                              self.dtype))
        out = conv2d_nhwc(out, self.conv2.weight, None, self.stride, 1, self.dtype)
        out = F.relu(self.bn2(out, self.dtype))
        return self.bn3(conv2d_nhwc(out, self.conv3.weight, None, dtype=self.dtype), self.dtype)


_BLOCKS = {"Basic": BasicBlock, "BottleNeck": Bottleneck, "BasicBlockWithCBAM": BasicBlockWithCBAM}


class ResNetForMMBEV(nn.Module):
    def __init__(self, num_layer: Sequence[int] = (2, 2, 2, 2),
                 num_channels: Sequence[int] = (64, 128, 256, 512),
                 stride: Sequence[int] = (2, 2, 2, 2), block_type: str = "Basic",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if block_type not in _BLOCKS:
            raise ValueError(f"unknown block_type {block_type!r}; known: {sorted(_BLOCKS)}")
        block = _BLOCKS[block_type]
        self.dtype = dtype
        layers = []
        cin = 3  # RGB
        for n, ch, s in zip(num_layer, num_channels, stride):
            planes = ch // 4 if block is Bottleneck else ch
            blocks = [block(cin, planes, s, downsample=True, dtype=dtype)]
            blocks += [block(ch, planes, dtype=dtype) for _ in range(1, n)]
            layers.append(nn.Sequential(*blocks))
            cin = ch
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """(B, H, W, 3) -> the four stage outputs. ``generator`` is unused:
        the ResNet draws nothing."""
        feats = []
        for layer in self.layers:
            x = layer(x)
            feats.append(x)
        return feats


@BACKBONES.register(name="mmbev_res18")
def mmbev_res18(dtype=None):
    return ResNetForMMBEV(num_layer=(2, 2, 2, 2), dtype=dtype)


@BACKBONES.register(name="mmbev_res50")
def mmbev_res50(dtype=None):
    return ResNetForMMBEV(num_layer=(3, 4, 6, 3), dtype=dtype)


@BACKBONES.register(name="mmbev_res101")
def mmbev_res101(dtype=None):
    return ResNetForMMBEV(num_layer=(3, 4, 23, 3), dtype=dtype)
