"""HAHI heterogeneous feature neck (port of
``diffusiondepth_tpu/models/necks/hahi.py``).

Per level a 1x1 conv+BN+ReLU; the transformer levels (1..n-1) are projected
to the embedding width, flattened and concatenated into one token sequence,
optionally enhanced by deformable self-attention over all of them ("HI"),
folded back and fused with their level by a 3x3 conv; the conv level (0) is
projected, optionally cross-attends into the fused tokens by deformable
attention ("HA"), and is fused with its level by a 3x3 conv. The shipped
Swin and MPViT heads build the neck with both attentions off; the
attention modules (``level_embed``, ``self_attn``, ``reference_points_fc``,
``multi_att``) exist only when switched on, so the attention-off state
dict is the conv path's. Parameter names follow the reference mmcv
``ConvModule`` layout (``lateral_convs.{i}.conv/.bn``, ``conv_proj.0.conv/.bn``,
...) and mmcv's MSDA names.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.msda import MultiScaleDeformableAttention
from ...ops.native import constant
from ...parallel.tensor import whole
from ..common import BatchNorm2d, conv2d_nhwc, linear
from .positional_encoding import SinePositionalEncoding


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


def _grid_reference_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(sum H*W, 2): each token's centre as (x, y) normalised to [0, 1],
    level after level (all-valid masks: valid ratios of 1)."""
    pts = []
    for (h, w) in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return np.concatenate(pts, 0)


class HAHIHeteroNeck(nn.Module):
    """``self_att``/``cross_att`` switch the two deformable attentions on;
    each MSDA has ``num_heads`` heads and ``num_points`` points on 4 level
    slots (the reference's), of which the run uses n-1; the sine encoding
    has ``pe_num_feats`` features per axis (2 * pe_num_feats must be the
    embedding width)."""

    def __init__(self, in_channels: Sequence[int] = (192, 384, 768, 1536),
                 out_channels: Sequence[int] = (192, 384, 768, 1536),
                 embedding_dim: int = 512, self_att: bool = False,
                 cross_att: bool = False, num_points: int = 8, num_heads: int = 8,
                 pe_num_feats: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        n = len(in_channels)
        e = embedding_dim
        self.embedding_dim = e
        self.self_att = self_att
        self.cross_att = cross_att
        self.dtype = dtype
        self.lateral_convs = nn.ModuleList(
            [ConvModule(in_channels[i], out_channels[i], 1, dtype) for i in range(n)])
        self.trans_proj = nn.ModuleList(
            [ConvModule(out_channels[i + 1], e, 1, dtype) for i in range(n - 1)])
        self.trans_fusion = nn.ModuleList(
            [ConvModule(out_channels[i + 1] + e, out_channels[i + 1], 3, dtype)
             for i in range(n - 1)])
        self.conv_proj = nn.Sequential(ConvModule(out_channels[0], e, 1, dtype))
        self.conv_fusion = nn.Sequential(ConvModule(out_channels[0] + e, out_channels[0], 3, dtype))

        if self_att or cross_att:
            self.positional_encoding = SinePositionalEncoding(pe_num_feats)
            self.level_embed = nn.Parameter(torch.randn(4, e))  # the reference's 4 slots

        def msda():
            return MultiScaleDeformableAttention(e, num_heads, num_levels=4,
                                                 num_points=num_points, dtype=dtype)

        if self_att:
            self.self_attn = msda()
        if cross_att:
            self.reference_points_fc = nn.Linear(e, 2)
            self.multi_att = msda()

    def self_attention(self, src: torch.Tensor, shapes: List[Tuple[int, int]],
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Deformable self-attention over the levels' concatenated tokens
        (B, sum H*W, E): each level's query position is its sine encoding
        plus its ``level_embed`` row, each token's reference point its
        centre on every level."""
        dt, dev = src.dtype, src.device
        level_embed = whole(self.level_embed)
        pos = torch.cat([self.positional_encoding.table(h, w, dev, dt) + level_embed[i].to(dt)
                         for i, (h, w) in enumerate(shapes)], 1)
        ref = constant((_grid_reference_points, tuple(shapes)),
                       lambda: _grid_reference_points(shapes), dev, dt)
        ref = ref[None, :, None, :].expand(src.shape[0], -1, len(shapes), 2)
        return self.self_attn(src, None, pos, ref, shapes, generator=generator)

    def cross_attention(self, conv_skip: torch.Tensor, src: torch.Tensor,
                        shapes: List[Tuple[int, int]],
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Deformable cross-attention from the conv level's tokens into the
        fused tokens ``src``: the query position is the sine encoding, the
        reference points ``sigmoid(reference_points_fc(encoding))`` on
        every level, the identity the un-positioned query. (B, h, w, E)
        in and out."""
        b, h0, w0, e = conv_skip.shape
        query = conv_skip.reshape(b, h0 * w0, e)
        qpe = self.positional_encoding.table(h0, w0, query.device, query.dtype)
        ref = torch.sigmoid(linear(qpe, self.reference_points_fc, self.dtype))
        ref = ref[:, :, None, :].expand(b, -1, len(shapes), 2)
        out = self.multi_att(query, src, qpe, ref, shapes, generator=generator)
        return out.reshape(b, h0, w0, e)

    def forward(self, inputs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the attentions' dropout masks in training."""
        feats = [conv(f) for conv, f in zip(self.lateral_convs, inputs)]
        feat_conv, feats_trans = feats[0], feats[1:]
        toks = [proj(f) for proj, f in zip(self.trans_proj, feats_trans)]
        shapes = [(t.shape[1], t.shape[2]) for t in toks]
        b, e = feat_conv.shape[0], self.embedding_dim
        src = None
        if self.self_att or self.cross_att:
            src = torch.cat([t.reshape(b, -1, e) for t in toks], 1)
        if self.self_att:
            src = self.self_attention(src, shapes, generator)
            toks = list(torch.split(src, [h * w for h, w in shapes], 1))
            toks = [t.reshape(b, h, w, e) for t, (h, w) in zip(toks, shapes)]
        conv_skip = self.conv_proj[0](feat_conv)
        if self.cross_att:
            conv_skip = self.cross_attention(conv_skip, src, shapes, generator)
        outs = [self.conv_fusion[0](torch.cat([conv_skip, feat_conv], dim=-1))]
        for fuse, f, tok in zip(self.trans_fusion, feats_trans, toks):
            outs.append(fuse(torch.cat([f, tok], dim=-1)))
        return tuple(outs)
