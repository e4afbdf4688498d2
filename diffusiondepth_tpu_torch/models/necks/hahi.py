"""HAHI heterogeneous feature neck, conv path (port of
``diffusiondepth_tpu/models/necks/hahi.py`` with ``self_att=cross_att=False``,
as the shipped Swin and MPViT heads construct it).

Per level a 1x1 conv+BN+ReLU; the transformer levels are projected to the
embedding width and fused back with a 3x3 conv, the conv level is projected
and fused with a 3x3 conv. Parameter names follow the reference mmcv
``ConvModule`` layout (``lateral_convs.{i}.conv/.bn``,
``conv_proj.0.conv/.bn``, ...).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import BatchNorm2d, conv2d_nhwc


class ConvModule(nn.Module):
    """conv (with bias) -> BatchNorm -> ReLU, names ``conv`` and ``bn``."""

    def __init__(self, cin: int, cout: int, kernel: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, kernel, 1, kernel // 2, bias=True)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_nhwc(x, self.conv.weight, self.conv.bias, 1,
                        self.conv.padding, self.dtype)
        return F.relu(self.bn(y, self.dtype))


class HAHIHeteroNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (192, 384, 768, 1536),
                 out_channels: Sequence[int] = (192, 384, 768, 1536),
                 embedding_dim: int = 512, self_att: bool = False,
                 cross_att: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if self_att or cross_att:
            raise NotImplementedError(
                "HAHI deformable self/cross attention is not ported yet "
                "(ROADMAP Queue 1, M15: ops/msda.py); the shipped heads run "
                "the conv path")
        n = len(in_channels)
        e = embedding_dim
        self.embedding_dim = e
        self.lateral_convs = nn.ModuleList(
            [ConvModule(in_channels[i], out_channels[i], 1, dtype) for i in range(n)])
        self.trans_proj = nn.ModuleList(
            [ConvModule(out_channels[i + 1], e, 1, dtype) for i in range(n - 1)])
        self.trans_fusion = nn.ModuleList(
            [ConvModule(out_channels[i + 1] + e, out_channels[i + 1], 3, dtype)
             for i in range(n - 1)])
        self.conv_proj = nn.Sequential(ConvModule(out_channels[0], e, 1, dtype))
        self.conv_fusion = nn.Sequential(ConvModule(out_channels[0] + e, out_channels[0], 3, dtype))

    def forward(self, inputs: Sequence[torch.Tensor]):
        feats = [conv(f) for conv, f in zip(self.lateral_convs, inputs)]
        feat_conv, feats_trans = feats[0], feats[1:]
        # with attention off the projected tokens pass through unchanged
        toks = [proj(f) for proj, f in zip(self.trans_proj, feats_trans)]
        conv_skip = self.conv_proj[0](feat_conv)
        outs = [self.conv_fusion[0](torch.cat([conv_skip, feat_conv], dim=-1))]
        for fuse, f, tok in zip(self.trans_fusion, feats_trans, toks):
            outs.append(fuse(torch.cat([f, tok], dim=-1)))
        return tuple(outs)
