"""MPViT (Multi-Path Vision Transformer) backbone, NHWC (port of
``diffusiondepth_tpu/models/backbones/mpvit.py``).

* The conv stem runs at stride 1 (the reference's dense-prediction edit),
  so the pyramid is (1/2, 1/4, 1/8, 1/16) of the input.
* Each stage embeds ``num_path`` paths as a chain of depthwise-separable
  convs: path p takes path p-1's output, path 0 (stride 2) the stage input.
* Each path runs an ``MHCAEncoder``: one ConvPosEnc and one ConvRelPosEnc
  shared by its blocks, factorised (linear) attention with the softmax of
  K over the token axis in f32, LayerNorm eps 1e-6, exact GELU.
* The stage concatenates [InvRes(path 0), the path encoders] and
  aggregates with a 1x1 Conv + BN + Hardswish to ``dims[s + 1]`` channels
  (the last stage keeps ``dims[s]``).

Under ``norm_eval`` (the reference's default) every BatchNorm of the
backbone stays in eval mode in training: ``train()`` keeps them there, so
they normalise with the running statistics and never update them, while
drop-path stays active. Each block with a drop-path rate draws two masks
(attention branch, MLP branch) from the caller's ``torch.Generator``.

Parameter names are the reference's (``stem.{0,1}``,
``patch_embed_stages.{s}.patch_embeds.{p}.patch_conv.{dwconv,pwconv,bn}``,
``mhca_stages.{s}.{InvRes,mhca_blks.{p},aggregate}``), the names
``convert_mpvit`` reads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel.mesh import draw_rows
from ...registry import BACKBONES
from ..common import BatchNorm2d, conv2d_nhwc, drop_path, layer_norm, linear


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x * clip(x + 3, 0, 6) / 6, in the JAX package's order."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class ConvBN(nn.Module):
    """Conv2d (no bias) + BN [+ Hardswish], names ``conv`` and ``bn``."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, pad: int = 0,
                 act: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.act = act
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = self.bn(conv2d_nhwc(x, c.weight, None, c.stride, c.padding, self.dtype), self.dtype)
        return hardswish(x) if self.act else x


class _DWConvBN(nn.Module):
    """Depthwise 3x3 (stride) + pointwise 1x1 + BN + Hardswish, the
    reference's ``patch_conv``."""

    def __init__(self, dim: int, stride: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype
        self.dwconv = nn.Conv2d(dim, dim, 3, stride, 1, groups=dim, bias=False)
        self.pwconv = nn.Conv2d(dim, dim, 1, bias=False)
        self.bn = BatchNorm2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dwconv
        x = conv2d_nhwc(x, d.weight, None, d.stride, 1, self.dtype, groups=d.groups)
        x = conv2d_nhwc(x, self.pwconv.weight, None, dtype=self.dtype)
        return hardswish(self.bn(x, self.dtype))


class DWCPatchEmbed(nn.Module):
    def __init__(self, dim: int, stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_conv = _DWConvBN(dim, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.patch_conv(x)


class ConvPosEnc(nn.Module):
    """x + depthwise3x3(x) (with bias) on the token grid."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.proj
        return x + conv2d_nhwc(x, p.weight, p.bias, 1, 1, self.dtype, groups=p.groups)


class ConvRelPosEnc(nn.Module):
    """Convolutional relative position encoding: the heads of V, laid out
    head-major as (heads * Ch) channels, are split into windows
    (``{window: heads}``), each group through a depthwise conv with bias;
    returns q * conv(v). q, v: (B, H, W, heads, Ch)."""

    def __init__(self, head_ch: int, num_heads: int, window: Optional[Dict[int, int]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        window = window or {3: 2, 5: 3, 7: 3}
        if sum(window.values()) != num_heads:
            raise ValueError(f"window splits {window} do not cover {num_heads} heads")
        self.dtype = dtype
        self.splits = [split * head_ch for split in window.values()]
        self.conv_list = nn.ModuleList([
            nn.Conv2d(c, c, win, 1, win // 2, groups=c)
            for win, c in zip(window, self.splits)])

    def forward(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, h, w, heads, ch = v.shape
        parts = torch.split(v.reshape(b, h, w, heads * ch), self.splits, dim=-1)
        outs = [conv2d_nhwc(part, conv.weight, conv.bias, 1, conv.padding, self.dtype,
                            groups=conv.groups)
                for part, conv in zip(parts, self.conv_list)]
        return q * torch.cat(outs, dim=-1).reshape(b, h, w, heads, ch)


class FactorAttConvRelPosEnc(nn.Module):
    """Factorised attention: scale * q (softmax_N(k)^T v) + q * crpe(v)."""

    def __init__(self, dim: int, num_heads: int = 8, qk_scale: Optional[float] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, crpe: ConvRelPosEnc) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = self.num_heads
        ch = c // heads
        qkv = linear(x, self.qkv, self.dtype).reshape(b, h, w, 3, heads, ch)
        q, k, v = qkv.unbind(3)
        # the softmax over the token axis runs on a (B, heads, Ch, N) copy,
        # with the tokens last: over a middle axis of N ~ 1e6 tokens the
        # card's softmax was 80% of the backbone's time
        k_sm = torch.softmax(k.reshape(b, h * w, heads, ch).permute(0, 2, 3, 1).float(),
                             dim=-1).to(x.dtype)
        kv = torch.einsum("bhkn,bnhv->bhkv", k_sm, v.reshape(b, h * w, heads, ch))
        factor = torch.einsum("bnhk,bhkv->bnhv", q.reshape(b, h * w, heads, ch), kv)
        out = self.scale * factor.reshape(b, h, w, heads, ch) + crpe(q, v)
        return linear(out.reshape(b, h, w, c), self.proj, self.dtype)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class MHCABlock(nn.Module):
    """CPE -> LN -> FactorAtt (+ drop-path residual) -> LN -> MLP (+ drop-path
    residual)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.drop_path_rate = 0.0
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.factoratt_crpe = FactorAttConvRelPosEnc(dim, num_heads, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, cpe: ConvPosEnc, crpe: ConvRelPosEnc,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: (2, B) bool drop-path masks, or None for no drop-path."""
        x = cpe(x)
        y = self.factoratt_crpe(layer_norm(x, self.norm1, self.dtype), crpe)
        if keep is not None:
            y = drop_path(y, keep[0], self.drop_path_rate)
        x = x + y
        y = F.gelu(linear(layer_norm(x, self.norm2, self.dtype), self.mlp.fc1, self.dtype))
        y = linear(y, self.mlp.fc2, self.dtype)
        if keep is not None:
            y = drop_path(y, keep[1], self.drop_path_rate)
        return x + y


class MHCAEncoder(nn.Module):
    """A path's encoder: one CPE and one CRPE shared by ``num_layers`` blocks."""

    def __init__(self, dim: int, num_layers: int = 1, num_heads: int = 8, mlp_ratio: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cpe = ConvPosEnc(dim, dtype)
        self.crpe = ConvRelPosEnc(dim // num_heads, num_heads, dtype=dtype)
        self.MHCA_layers = nn.ModuleList([
            MHCABlock(dim, num_heads, mlp_ratio, dtype) for _ in range(num_layers)])


class ResBlock(nn.Module):
    """Inverted-residual conv path of a stage: 1x1 ConvBN + Hardswish,
    depthwise 3x3 + BN + Hardswish, 1x1 ConvBN, plus the input."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBN(dim, dim, 1, act=True, dtype=dtype)
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=False)
        self.norm = BatchNorm2d(dim)
        self.conv2 = ConvBN(dim, dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        y = conv2d_nhwc(y, self.dwconv.weight, None, 1, 1, self.dtype, groups=self.dwconv.groups)
        y = self.conv2(hardswish(self.norm(y, self.dtype)))
        return x + y


class _PatchEmbedStage(nn.Module):
    def __init__(self, dim: int, num_path: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.patch_embeds = nn.ModuleList([
            DWCPatchEmbed(dim, 2 if p == 0 else 1, dtype) for p in range(num_path)])


class _MHCAStage(nn.Module):
    def __init__(self, dim: int, out_dim: int, num_layers: int, num_heads: int,
                 mlp_ratio: int, num_path: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.mhca_blks = nn.ModuleList([
            MHCAEncoder(dim, num_layers, num_heads, mlp_ratio, dtype) for _ in range(num_path)])
        self.InvRes = ResBlock(dim, dtype)
        self.aggregate = ConvBN(dim * (num_path + 1), out_dim, 1, act=True, dtype=dtype)


class MPViT(nn.Module):
    def __init__(self, num_stages: int = 4, num_layers: Sequence[int] = (1, 1, 1, 1),
                 mlp_ratios: Sequence[int] = (8, 8, 4, 4), num_path: Sequence[int] = (4, 4, 4, 4),
                 embed_dims: Sequence[int] = (64, 128, 256, 512),
                 num_heads: Sequence[int] = (8, 8, 8, 8), drop_path_rate: float = 0.0,
                 norm_eval: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = embed_dims
        self.dtype = dtype
        self.norm_eval = norm_eval
        self.stem = nn.ModuleList([
            ConvBN(3, dims[0] // 2, 3, 1, 1, act=True, dtype=dtype),
            ConvBN(dims[0] // 2, dims[0], 3, 1, 1, act=True, dtype=dtype)])
        self.patch_embed_stages = nn.ModuleList([
            _PatchEmbedStage(dims[s], num_path[s], dtype) for s in range(num_stages)])
        self.mhca_stages = nn.ModuleList([
            _MHCAStage(dims[s], dims[s + 1] if s + 1 < num_stages else dims[s],
                       num_layers[s], num_heads[s], mlp_ratios[s], num_path[s], dtype)
            for s in range(num_stages)])
        rates = iter(np.linspace(0, drop_path_rate, sum(num_layers)).tolist())
        for stage, n in zip(self.mhca_stages, num_layers):
            stage_rates = [next(rates) for _ in range(n)]
            for enc in stage.mhca_blks:
                for blk, rate in zip(enc.MHCA_layers, stage_rates):
                    blk.drop_path_rate = rate

    def train(self, mode: bool = True) -> "MPViT":
        """Training mode; under ``norm_eval`` every BatchNorm stays in eval."""
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        return self

    def _encoder(self, enc: MHCAEncoder, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        for blk in enc.MHCA_layers:
            keep = None
            if self.training and blk.drop_path_rate > 0:
                keep = (draw_rows(torch.rand, (2, x.shape[0]), dim=1, generator=generator,
                                  device=x.device) < 1.0 - blk.drop_path_rate)
            x = blk(x, enc.cpe, enc.crpe, keep)
        return x

    def stage(self, s: int, x: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Stage ``s`` on its input (the stem's output or stage s-1's):
        the chained patch embeds, InvRes and the path encoders, aggregated."""
        embed, stage = self.patch_embed_stages[s], self.mhca_stages[s]
        paths = []
        for pe in embed.patch_embeds:
            x = pe(x)
            paths.append(x)
        feats = [stage.InvRes(paths[0])]
        feats += [self._encoder(enc, p, generator) for enc, p in zip(stage.mhca_blks, paths)]
        return stage.aggregate(torch.cat(feats, dim=-1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """(B, H, W, 3) -> the four stage outputs at 1/2 .. 1/16."""
        for conv in self.stem:
            x = conv(x)
        outs = []
        for s in range(len(self.mhca_stages)):
            x = self.stage(s, x, generator)
            outs.append(x)
        return outs


def _mpvit(paths, layers, dims, mlp, dprate, dtype=None):
    return MPViT(num_stages=4, num_path=paths, num_layers=layers, embed_dims=dims,
                 mlp_ratios=mlp, num_heads=(8, 8, 8, 8), drop_path_rate=dprate, dtype=dtype)


@BACKBONES.register(name="mpvit_tiny")
def mpvit_tiny(dtype=None):
    """Stage outputs (96, 176, 216, 216)."""
    return _mpvit((2, 3, 3, 3), (1, 2, 4, 1), (64, 96, 176, 216), (2,) * 4, 0.0, dtype)


@BACKBONES.register(name="mpvit_xsmall")
def mpvit_xsmall(dtype=None):
    """Stage outputs (128, 192, 256, 256)."""
    return _mpvit((2, 3, 3, 3), (1, 2, 4, 1), (64, 128, 192, 256), (4,) * 4, 0.0, dtype)


@BACKBONES.register(name="mpvit_small")
def mpvit_small(dtype=None):
    """Stage outputs (128, 216, 288, 288), the MPViT head's channels."""
    return _mpvit((2, 3, 3, 3), (1, 3, 6, 3), (64, 128, 216, 288), (4,) * 4, 0.2, dtype)


@BACKBONES.register(name="mpvit_base")
def mpvit_base(dtype=None):
    """Stage outputs (224, 368, 480, 480)."""
    return _mpvit((2, 3, 3, 3), (1, 3, 8, 3), (128, 224, 368, 480), (4,) * 4, 0.4, dtype)
