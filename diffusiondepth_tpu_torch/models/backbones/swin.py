"""Swin Transformer backbone, NHWC, eval path (port of
``diffusiondepth_tpu/models/backbones/swin.py``).

Parameter names follow the reference's mmcv Swin
(``patch_embed.projection``, ``stages.{i}.blocks.{j}.attn.w_msa.qkv``,
``...ffn.layers.0.0``, ``stages.{i}.downsample.reduction``, ``norm{i}``), so
a reference state dict loads as it is. Window attention runs through
``ops.window_attention.window_attention`` (kernel K4 on the card) straight
from the qkv Linear output.

Known details kept from the reference: the block pads after ``norm1`` (the
padded tokens are zeros), the shift is a roll by -shift before attention and
+shift after, GELU is exact, and PatchMerging concatenates its 2x2 unfold
channel-slowest (nn.Unfold order).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.window_attention import window_attention
from ...registry import BACKBONES
from ..common import conv2d_nhwc, layer_norm, linear


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(h_pad: int, w_pad: int, window: int, shift: int) -> np.ndarray:
    """(nW, N, N) attention mask with 0 / -100 entries for shifted windows."""
    img_mask = np.zeros((h_pad, w_pad), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    nwh, nww = h_pad // window, w_pad // window
    win = img_mask.reshape(nwh, window, nww, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, N, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """(B, nW, N, C) -> (B, H, W, C)."""
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class WindowMSA(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int, window_size: int = 7,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.window_size = window_size
        self.scale = (embed_dims // num_heads) ** -0.5
        self.dtype = dtype
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims)
        self.proj = nn.Linear(embed_dims, embed_dims)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size, window_size).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, nW, N, C) window-major; mask (nW, N, N) f32 or None."""
        n = x.shape[2]
        qkv = linear(x, self.qkv, self.dtype)
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, self.num_heads).permute(2, 0, 1).float().contiguous()
        out = window_attention(qkv.contiguous(), bias, mask, self.scale, self.num_heads)
        return linear(out, self.proj, self.dtype)


class ShiftWindowMSA(nn.Module):
    def __init__(self, embed_dims, num_heads, window_size, dtype):
        super().__init__()
        self.w_msa = WindowMSA(embed_dims, num_heads, window_size, dtype)


class FFN(nn.Module):
    """mmcv FFN names: ``layers.0.0`` (fc1), ``layers.1`` (fc2)."""

    def __init__(self, embed_dims: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Sequential(nn.Linear(embed_dims, hidden)),
                                     nn.Linear(hidden, embed_dims)])


class SwinBlock(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int,
                 window_size: int = 7, shift: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size, dtype)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.ffn = FFN(embed_dims, feedforward_channels)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, h_pad: int, w_pad: int, device: torch.device) -> torch.Tensor:
        key = (h_pad, w_pad, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(shifted_window_mask(
                h_pad, w_pad, self.window_size, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = self.window_size
        shortcut = x
        y = layer_norm(x, self.norm1, self.dtype)
        pad_b = (ws - h % ws) % ws
        pad_r = (ws - w % ws) % ws
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
        h_pad, w_pad = h + pad_b, w + pad_r
        mask = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), dims=(1, 2))
            mask = self._mask(h_pad, w_pad, y.device)
        y = self.attn.w_msa(window_partition(y, ws), mask)
        y = window_reverse(y, ws, h_pad, w_pad)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        if pad_b or pad_r:
            y = y[:, :h, :w, :]
        x = shortcut + y

        fc1, fc2 = self.ffn.layers[0][0], self.ffn.layers[1]
        y = layer_norm(x, self.norm2, self.dtype)
        y = F.gelu(linear(y, fc1, self.dtype))
        y = linear(y, fc2, self.dtype)
        return x + y


class PatchMerging(nn.Module):
    """2x2 unfold (channel slowest) -> LayerNorm -> Linear(4C -> 2C, no bias)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * in_channels, eps=1e-5)
        self.reduction = nn.Linear(4 * in_channels, out_channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = x.shape[1], x.shape[2]
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(b, h // 2, w // 2, 4 * c)
        return linear(layer_norm(x, self.norm, self.dtype), self.reduction, self.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dims: int, patch_size: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.projection = nn.Conv2d(3, embed_dims, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dims, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        h, w = x.shape[1], x.shape[2]
        pad_b, pad_r = (p - h % p) % p, (p - w % p) % p
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        x = conv2d_nhwc(x, self.projection.weight, self.projection.bias, p, 0, self.dtype)
        return layer_norm(x, self.norm, self.dtype)


class SwinStage(nn.Module):
    def __init__(self, blocks: Sequence[SwinBlock], downsample: Optional[PatchMerging]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Four-stage Swin pyramid returning NHWC maps (eval: no dropout, no
    drop-path, no activation checkpointing)."""

    def __init__(self, embed_dims: int = 96, patch_size: int = 4, window_size: int = 7,
                 mlp_ratio: int = 4, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.patch_embed = PatchEmbed(embed_dims, patch_size, dtype)
        stages = []
        dims = embed_dims
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = [SwinBlock(dims, heads, mlp_ratio * dims, window_size,
                                shift=(j % 2 == 1), dtype=dtype) for j in range(depth)]
            down = PatchMerging(dims, 2 * dims, dtype) if i < len(depths) - 1 else None
            stages.append(SwinStage(blocks, down))
            self.add_module(f"norm{i}", nn.LayerNorm(dims, eps=1e-5))
            dims *= 2
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            outs.append(layer_norm(x, getattr(self, f"norm{i}"), self.dtype))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


@BACKBONES.register(name="swin_large_naive_l4w722422k")
def swin_large_naive_l4w722422k(dtype=None):
    """Swin-L: embed 192, depths (2, 2, 18, 2), heads (6, 12, 24, 48), window 7."""
    return SwinTransformer(embed_dims=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48), dtype=dtype)


@BACKBONES.register(name="swin_micro")
def swin_micro(dtype=None):
    """Every layer type of the flagship backbone at test size; pyramid
    channels (32, 64, 128, 256)."""
    return SwinTransformer(embed_dims=32, depths=(1, 2, 1, 1),
                           num_heads=(1, 2, 4, 8), dtype=dtype)
