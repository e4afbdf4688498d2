"""MPViT backbone of the reference (Lee et al., "MPViT: Multi-Path Vision
Transformer for Dense Prediction", CVPR 2022, arXiv:2112.11010), as the
DiffusionDepth reference repository runs it (``src/model/backbone/mpvit.py``):
it joins Swin-L and the stemless mmbev ResNet among the reference's
backbones. Float32, NCHW, every product through ``model.py``'s ``conv``,
``linear`` and ``matmul``, and each depthwise conv through ``grouped``
here, which rounds its inputs with ``model.py``'s ``rounded`` as ``conv``
does (``conv`` takes no groups).

* Stem: two 3x3 Conv + BatchNorm + Hardswish at stride 1 (the reference
  repository's dense-prediction edit of MPViT's stride-2 stem), to
  ``dims[0]`` channels.
* Stage ``s``: ``paths[s]`` depthwise-separable patch embeds (depthwise 3x3,
  pointwise 1x1, BatchNorm, Hardswish) in a chain, the first at stride 2,
  so the pyramid is 1/2, 1/4, 1/8 and 1/16 of the input. The first path's
  map goes through the inverted-residual conv path (1x1 ConvBN + Hardswish,
  depthwise 3x3 + BatchNorm + Hardswish, 1x1 ConvBN, plus its input); each
  path's map through its encoder of ``layers[s]`` blocks. The stage
  concatenates [inverted residual, encoders] and aggregates them with a 1x1
  ConvBN + Hardswish to ``dims[s + 1]`` channels (the last keeps its own).
* A block: x + depthwise3x3(x) (the encoder's one convolutional position
  encoding, with bias, in every block); x + factorised attention of
  LayerNorm(x); x + MLP (exact GELU, ratio ``mlp_ratio``) of LayerNorm(x);
  LayerNorm eps 1e-6.
* Factorised attention over the N tokens of a map, per head of ``Ch``
  channels: scale * Q (softmax_N(K)^T V) + Q * CRPE(V), then a linear
  projection; scale ``Ch ** -0.5``. The softmax runs over the token axis.
  CRPE: V's channels, head-major, split into head groups {3: 2, 5: 3, 7: 3}
  (window: heads), each group through a depthwise conv of that window with
  bias.
* BatchNorm with running statistics (eval); drop-path is inactive in eval.

The parameter names are the program's (``stem.{0,1}.{conv,bn}``,
``patch_embed_stages.{s}.patch_embeds.{p}.patch_conv.{dwconv,pwconv,bn}``,
``mhca_stages.{s}.{mhca_blks.{p}.{cpe,crpe,MHCA_layers}, InvRes, aggregate}``),
so one state dict loads into both. Departures from the published
description: none in the arithmetic; the module tree holds only what the
forward uses (no classification head), and ``encoders`` is this file's own
entry point to the stage's path encoders, which the benchmark's counting
(``reference/work.py``) and its tests run alone.

``build(spec)`` gives the module and its four levels' channels.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..model import BatchNorm, conv, linear, matmul, rounded

CRPE_WINDOWS = {3: 2, 5: 3, 7: 3}  # window: heads


def grouped(x, m: nn.Conv2d):
    """``m``, a grouped (depthwise) conv, on ``x``, its inputs rounded to
    ``PRODUCT_PRECISION``."""
    return F.conv2d(rounded(x), rounded(m.weight), m.bias, m.stride, m.padding, 1, m.groups)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm, Hardswish where ``act``."""

    def __init__(self, cin, cout, k=1, stride=1, act=False):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        y = self.bn(conv(x, self.conv))
        return F.hardswish(y) if self.act else y


class PatchConv(nn.Module):
    def __init__(self, dim, stride):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, stride, 1, groups=dim, bias=False)
        self.pwconv = nn.Conv2d(dim, dim, 1, bias=False)
        self.bn = BatchNorm(dim)

    def forward(self, x):
        return F.hardswish(self.bn(conv(grouped(x, self.dwconv), self.pwconv)))


class PatchEmbed(nn.Module):
    def __init__(self, dim, stride):
        super().__init__()
        self.patch_conv = PatchConv(dim, stride)


class ConvPosEnc(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x):
        return x + grouped(x, self.proj)


class ConvRelPosEnc(nn.Module):
    def __init__(self, head_ch, windows: Dict[int, int]):
        super().__init__()
        self.splits = [heads * head_ch for heads in windows.values()]
        self.conv_list = nn.ModuleList([nn.Conv2d(c, c, w, 1, w // 2, groups=c)
                                        for w, c in zip(windows, self.splits)])

    def forward(self, q, v, hw):
        """q * conv(v); q, v (B, heads, N, Ch), the maps of v (B, heads * Ch,
        H, W), head-major."""
        b, heads, n, ch = v.shape
        parts = torch.split(v.transpose(-2, -1).reshape(b, heads * ch, *hw), self.splits, 1)
        pos = torch.cat([grouped(p, m) for p, m in zip(parts, self.conv_list)], 1)
        return q * pos.reshape(b, heads, ch, n).transpose(-2, -1)


class FactorAtt(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, crpe: ConvRelPosEnc):
        """x (B, H, W, C) -> (B, H, W, C)."""
        b, h, w, c = x.shape
        heads, ch = self.heads, c // self.heads
        qkv = linear(x.reshape(b, h * w, c), self.qkv)
        q, k, v = qkv.reshape(b, h * w, 3, heads, ch).permute(2, 0, 3, 1, 4)
        kv = matmul(k.softmax(dim=2).transpose(-2, -1), v)  # (B, heads, Ch, Ch)
        out = self.scale * matmul(q, kv) + crpe(q, v, (h, w))  # (B, heads, N, Ch)
        return linear(out.transpose(1, 2).reshape(b, h, w, c), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def norm_nhwc(x, ln: nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map, returned NHWC."""
    return F.layer_norm(x.permute(0, 2, 3, 1), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class MHCABlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.factoratt_crpe = FactorAtt(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, cpe: ConvPosEnc, crpe: ConvRelPosEnc):
        x = cpe(x)
        x = x + self.factoratt_crpe(norm_nhwc(x, self.norm1), crpe).permute(0, 3, 1, 2)
        y = linear(F.gelu(linear(norm_nhwc(x, self.norm2), self.mlp.fc1)), self.mlp.fc2)
        return x + y.permute(0, 3, 1, 2)


class MHCAEncoder(nn.Module):
    def __init__(self, dim, layers, heads, mlp_ratio):
        super().__init__()
        self.cpe = ConvPosEnc(dim)
        self.crpe = ConvRelPosEnc(dim // heads, CRPE_WINDOWS)
        self.MHCA_layers = nn.ModuleList([MHCABlock(dim, heads, mlp_ratio)
                                          for _ in range(layers)])

    def forward(self, x):
        for blk in self.MHCA_layers:
            x = blk(x, self.cpe, self.crpe)
        return x


class ResBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv1 = ConvBN(dim, dim, 1, act=True)
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=False)
        self.norm = BatchNorm(dim)
        self.conv2 = ConvBN(dim, dim, 1)

    def forward(self, x):
        y = F.hardswish(self.norm(grouped(self.conv1(x), self.dwconv)))
        return x + self.conv2(y)


class PatchEmbedStage(nn.Module):
    def __init__(self, dim, paths):
        super().__init__()
        self.patch_embeds = nn.ModuleList([PatchEmbed(dim, 2 if p == 0 else 1)
                                           for p in range(paths)])


class MHCAStage(nn.Module):
    def __init__(self, dim, out_dim, layers, heads, mlp_ratio, paths):
        super().__init__()
        self.mhca_blks = nn.ModuleList([MHCAEncoder(dim, layers, heads, mlp_ratio)
                                        for _ in range(paths)])
        self.InvRes = ResBlock(dim)
        self.aggregate = ConvBN(dim * (paths + 1), out_dim, 1, act=True)


class MPViT(nn.Module):
    def __init__(self, paths: Sequence[int], layers: Sequence[int], dims: Sequence[int],
                 heads: Sequence[int], mlp_ratios: Sequence[int]):
        super().__init__()
        n = len(dims)
        self.stem = nn.ModuleList([ConvBN(3, dims[0] // 2, 3, act=True),
                                   ConvBN(dims[0] // 2, dims[0], 3, act=True)])
        self.patch_embed_stages = nn.ModuleList([PatchEmbedStage(dims[s], paths[s])
                                                 for s in range(n)])
        self.mhca_stages = nn.ModuleList([
            MHCAStage(dims[s], dims[min(s + 1, n - 1)], layers[s], heads[s], mlp_ratios[s],
                      paths[s]) for s in range(n)])

    def embed(self, s: int, x) -> List[torch.Tensor]:
        """Stage ``s``'s chained patch embeds: one map a path."""
        maps = []
        for pe in self.patch_embed_stages[s].patch_embeds:
            x = pe.patch_conv(x)
            maps.append(x)
        return maps

    def encoders(self, s: int, maps: List[torch.Tensor]) -> List[torch.Tensor]:
        """Stage ``s``'s path encoders, each on its path's map."""
        return [enc(m) for enc, m in zip(self.mhca_stages[s].mhca_blks, maps)]

    def forward(self, rgb):
        x = rgb
        for m in self.stem:
            x = m(x)
        outs = []
        for s, stage in enumerate(self.mhca_stages):
            maps = self.embed(s, x)
            x = stage.aggregate(torch.cat([stage.InvRes(maps[0]), *self.encoders(s, maps)], 1))
            outs.append(x)
        return outs


def build(spec: dict):
    dims = list(spec["embed_dims"])
    model = MPViT(spec["num_path"], spec["num_layers"], dims, spec["num_heads"],
                  spec["mlp_ratios"])
    return model, dims[1:] + dims[-1:]
