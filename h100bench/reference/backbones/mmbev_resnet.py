"""The stemless mmbev ResNet of the reference: four stages of Basic blocks
at stride 2, all four levels out.

``build(spec)`` gives the module and its four levels' channels.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..model import BatchNorm, conv


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        # mmbev: the identity of a stage's first block is a strided 3x3 conv with a bias
        self.downsample = nn.Conv2d(cin, planes, 3, stride, 1) if downsample else None

    def forward(self, x):
        y = self.bn2(conv(F.relu(self.bn1(conv(x, self.conv1))), self.conv2))
        return F.relu(y + (x if self.downsample is None else conv(x, self.downsample)))


class ResNetMMBEV(nn.Module):
    """No stem; four stages of Basic blocks at stride 2; all four levels out."""

    def __init__(self, num_layer=(3, 4, 6, 3), channels=(64, 128, 256, 512)):
        super().__init__()
        layers, cin = [], 3
        for n, ch in zip(num_layer, channels):
            layers.append(nn.Sequential(BasicBlock(cin, ch, 2, True),
                                        *[BasicBlock(ch, ch) for _ in range(1, n)]))
            cin = ch
        self.layers = nn.ModuleList(layers)

    def forward(self, rgb):
        outs, x = [], rgb
        for layer in self.layers:
            x = layer(x)
            outs.append(x)
        return outs


def build(spec: dict):
    return ResNetMMBEV(tuple(spec["num_layer"]), tuple(spec["channels"])), list(spec["channels"])
