"""Swin Transformer backbone, NHWC (port of
``diffusiondepth_tpu/models/backbones/swin.py``).

Parameter names follow the reference's mmcv Swin
(``patch_embed.projection``, ``stages.{i}.blocks.{j}.attn.w_msa.qkv``,
``...ffn.layers.0.0``, ``stages.{i}.downsample.reduction``, ``norm{i}``), so
a reference state dict loads as it is. Window attention takes one of three
routes, as the JAX ``WindowMSA`` does (the card standing where JAX tests
for a TPU):

* by default, ``ops.window_attention.WindowAttentionQKV`` (kernel K4
  forward, K7 backward on the card) straight from the qkv Linear output;
* ``use_pallas`` at eval, ``window_attention_split`` (kernel K8) on q, k, v
  permuted to (B, nW, H, N, D);
* ``use_pallas`` in training, or ``fused_qkv_attention=False``, the einsum
  path in plain PyTorch, with the JAX path's rounding points (logits in the
  compute type, softmax in f32).

Training mode adds drop-path (rate ``linspace(0, drop_path_rate, depth)``
over the blocks), JAX's dropouts where their rates are above 0
(``attn_drop_rate`` on the attention probabilities, ``drop_rate`` after
the patch embedding, on the attention projection and after both FFN
Linears; every shipped config has 0) and, with ``remat``, per-block
rematerialisation with ``torch.utils.checkpoint``. The checkpoint restores
the global RNG, not an explicit ``torch.Generator``, so each block's
drop-path and dropout masks are drawn before the checkpointed call and
passed in: the recompute uses the same masks. With ``attn_drop_rate > 0``
a training call takes the einsum path, as JAX routes around its fused
kernel (``attn_drop_fallback``): K4/K7 have no dropout. The masks are the
port's draws (``draw_rows`` from the caller's generator); JAX's dropout
bits come from its own key splits and are not reproduced.

Known details kept from the reference: the block pads after ``norm1`` (the
padded tokens are zeros), the shift is a roll by -shift before attention and
+shift after, GELU is exact, and PatchMerging concatenates its 2x2 unfold
channel-slowest (nn.Unfold order).
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ...ops.native import to_device
from ...ops.window_attention import (
    WindowAttentionQKV, window_attention_einsum, window_attention_split,
)
from ...parallel.mesh import draw_rows
from ...parallel.tensor import whole
from ...registry import BACKBONES
from ...trace import span
from ..common import conv2d_nhwc, drop_path, dropout, layer_norm, linear

_WARNED = set()


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(msg)


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


def shifted_window_mask_on(h_pad: int, w_pad: int, window: int, shift: int,
                           device) -> torch.Tensor:
    """``shifted_window_mask`` computed with torch on ``device``: the same
    values. An exported program computes it on the card at each call
    instead of copying a host constant there (a copy waits for the stream)."""
    def region(n):  # 0, 1, 2 over the three bands of shifted_window_mask's slices
        i = torch.arange(n, device=device)
        return (i >= n - window).int() + (i >= n - shift).int()

    img = region(h_pad)[:, None] * 3 + region(w_pad)[None, :]
    win = img.reshape(h_pad // window, window, w_pad // window, window).permute(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0).to(torch.float32)


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
                 dtype: Optional[torch.dtype] = None, use_pallas: bool = False,
                 fused_qkv_attention: bool = True, attn_drop_rate: float = 0.0,
                 proj_drop_rate: float = 0.0):
        super().__init__()
        self.attn_drop_rate = attn_drop_rate
        self.proj_drop_rate = proj_drop_rate
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.window_size = window_size
        self.scale = (embed_dims // num_heads) ** -0.5
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.fused_qkv_attention = fused_qkv_attention
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims)
        self.proj = nn.Linear(embed_dims, embed_dims)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size, window_size).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                drops: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """x (B, nW, N, C) window-major; mask (nW, N, N) f32 or None;
        ``drops``: the keep masks of the attention dropout ("attn", (B, nW,
        heads, N, N)) and the projection's ("proj", (B, nW, N, C)), in
        training where their rates are above 0."""
        b, nw, n, c = x.shape
        drops = drops or {}
        attn_keep = drops.get("attn")
        qkv = linear(x, self.qkv, self.dtype)
        table = whole(self.relative_position_bias_table)
        # the index buffer is made from numpy and stays on the host (build_model
        # places only what torch makes on the device): a copy at each call
        bias = table[to_device(self.relative_position_index, table.device)]
        bias = bias.reshape(n, n, self.num_heads).permute(2, 0, 1).float().contiguous()
        fused = self.fused_qkv_attention and not self.use_pallas
        if fused and attn_keep is not None:
            _warn_once("attn_drop_fallback",
                       "attn_drop_rate > 0 disables the fused window-attention training "
                       "kernel; this training run uses the einsum attention path")
        if fused and attn_keep is None:
            out = WindowAttentionQKV.apply(qkv.contiguous(), bias, mask, self.scale,
                                           self.num_heads)
        elif self.use_pallas and not self.training:
            q, k, v = (t.permute(0, 1, 3, 2, 4).contiguous() for t in
                       qkv.reshape(b, nw, n, 3, self.num_heads, c // self.num_heads).unbind(3))
            out = window_attention_split(q, k, v, bias, mask, self.scale)
            out = out.permute(0, 1, 3, 2, 4).reshape(b, nw, n, c)
        else:
            out = window_attention_einsum(qkv, bias, mask, self.scale, self.num_heads,
                                          attn_keep, self.attn_drop_rate)
        out = linear(out, self.proj, self.dtype)
        if drops.get("proj") is not None:
            out = dropout(out, drops["proj"], self.proj_drop_rate)
        return out


class ShiftWindowMSA(nn.Module):
    def __init__(self, embed_dims, num_heads, window_size, dtype, use_pallas,
                 fused_qkv_attention, attn_drop_rate=0.0, proj_drop_rate=0.0):
        super().__init__()
        self.w_msa = WindowMSA(embed_dims, num_heads, window_size, dtype, use_pallas,
                               fused_qkv_attention, attn_drop_rate, proj_drop_rate)


class FFN(nn.Module):
    """mmcv FFN names: ``layers.0.0`` (fc1), ``layers.1`` (fc2)."""

    def __init__(self, embed_dims: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Sequential(nn.Linear(embed_dims, hidden)),
                                     nn.Linear(hidden, embed_dims)])


class SwinBlock(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int,
                 window_size: int = 7, shift: bool = False,
                 dtype: Optional[torch.dtype] = None, use_pallas: bool = False,
                 fused_qkv_attention: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = 0.0  # training only; SwinTransformer sets it
        self.drop_rate = drop_rate
        self.attn_drop_rate = attn_drop_rate
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = window_size // 2 if shift else 0
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size, dtype, use_pallas,
                                   fused_qkv_attention, attn_drop_rate, drop_rate)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.ffn = FFN(embed_dims, feedforward_channels)
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, h_pad: int, w_pad: int, device: torch.device) -> torch.Tensor:
        """The shift mask, made on ``device`` and cached by size and device.
        While ``torch.export`` traces, it is made anew and not cached: it is
        a fake tensor there, which a later eager call must not find, and the
        program computes it on the device."""
        key = (h_pad, w_pad, str(device))
        if key in self._masks:
            return self._masks[key]
        mask = shifted_window_mask_on(h_pad, w_pad, self.window_size, self.shift, device)
        if not torch.compiler.is_compiling():
            self._masks[key] = mask
        return mask

    def draw_dropout(self, x: torch.Tensor, generator: Optional[torch.Generator]
                     ) -> Optional[Dict[str, torch.Tensor]]:
        """The keep masks of this block's dropouts on an input of ``x``'s
        shape, drawn from ``generator`` (this rank's rows of the global
        batch's draw): "attn" (B, nW, heads, N, N) at ``attn_drop_rate``,
        "proj" (B, nW, N, C), "ffn1" (B, H, W, hidden) and "ffn2" (B, H, W,
        C) at ``drop_rate``; None where both rates are 0."""
        if self.attn_drop_rate <= 0 and self.drop_rate <= 0:
            return None
        b, h, w, c = x.shape
        ws = self.window_size
        nw = -(-h // ws) * -(-w // ws)

        def keep(shape, rate):
            return draw_rows(torch.rand, shape, generator=generator, device=x.device) < 1.0 - rate

        out = {}
        if self.attn_drop_rate > 0:
            out["attn"] = keep((b, nw, self.num_heads, ws * ws, ws * ws), self.attn_drop_rate)
        if self.drop_rate > 0:
            out["proj"] = keep((b, nw, ws * ws, c), self.drop_rate)
            out["ffn1"] = keep((b, h, w, self.ffn.layers[0][0].out_features), self.drop_rate)
            out["ffn2"] = keep((b, h, w, c), self.drop_rate)
        return out

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                drops: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """``keep``: (2, B) bool drop-path masks of the attention and FFN
        branches, or None for no drop-path; ``drops``: the dropout masks of
        ``draw_dropout``, or None for no dropout."""
        drops = drops or {}
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
        y = self.attn.w_msa(window_partition(y, ws), mask, drops)
        y = window_reverse(y, ws, h_pad, w_pad)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), dims=(1, 2))
        if pad_b or pad_r:
            y = y[:, :h, :w, :]
        if keep is not None:
            y = drop_path(y, keep[0], self.drop_path_rate)
        x = shortcut + y

        fc1, fc2 = self.ffn.layers[0][0], self.ffn.layers[1]
        y = layer_norm(x, self.norm2, self.dtype)
        y = F.gelu(linear(y, fc1, self.dtype))
        if "ffn1" in drops:
            y = dropout(y, drops["ffn1"], self.drop_rate)
        y = linear(y, fc2, self.dtype)
        if "ffn2" in drops:
            y = dropout(y, drops["ffn2"], self.drop_rate)
        if keep is not None:
            y = drop_path(y, keep[1], self.drop_path_rate)
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
    """Four-stage Swin pyramid returning NHWC maps. Eval: no drop-path, no
    activation checkpointing. Training: drop-path at
    ``linspace(0, drop_path_rate, total depth)`` (masks from the caller's
    generator) and, with ``remat`` and under grad, each block
    rematerialised in the backward. ``drop_rate`` and ``attn_drop_rate`` are
    JAX's dropouts (module docstring), 0 in the shipped configs.
    ``use_pallas`` and ``fused_qkv_attention`` choose the window attention
    (module docstring)."""

    def __init__(self, embed_dims: int = 96, patch_size: int = 4, window_size: int = 7,
                 mlp_ratio: int = 4, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), drop_path_rate: float = 0.1,
                 remat: bool = True, use_pallas: bool = False,
                 fused_qkv_attention: bool = True, dtype: Optional[torch.dtype] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        self.remat = remat
        self.patch_embed = PatchEmbed(embed_dims, patch_size, dtype)
        stages = []
        dims = embed_dims
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = [SwinBlock(dims, heads, mlp_ratio * dims, window_size,
                                shift=(j % 2 == 1), dtype=dtype, use_pallas=use_pallas,
                                fused_qkv_attention=fused_qkv_attention,
                                drop_rate=drop_rate, attn_drop_rate=attn_drop_rate)
                      for j in range(depth)]
            down = PatchMerging(dims, 2 * dims, dtype) if i < len(depths) - 1 else None
            stages.append(SwinStage(blocks, down))
            self.add_module(f"norm{i}", nn.LayerNorm(dims, eps=1e-5))
            dims *= 2
        self.stages = nn.ModuleList(stages)
        blocks = [blk for stage in self.stages for blk in stage.blocks]
        for blk, rate in zip(blocks, np.linspace(0, drop_path_rate, len(blocks)).tolist()):
            blk.drop_path_rate = rate

    def _block(self, blk: SwinBlock, x: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training:
            return blk(x)
        keep = None
        if blk.drop_path_rate > 0:
            keep = (draw_rows(torch.rand, (2, x.shape[0]), dim=1, generator=generator,
                              device=x.device) < 1.0 - blk.drop_path_rate)
        drops = blk.draw_dropout(x, generator)
        if self.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(blk, x, keep, drops, use_reentrant=False)
        return blk(x, keep, drops)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = self.patch_embed(x)
        if self.training and self.drop_rate > 0:
            x = dropout(x, draw_rows(torch.rand, x.shape, generator=generator, device=x.device)
                        < 1.0 - self.drop_rate, self.drop_rate)
        outs = []
        for i, stage in enumerate(self.stages):
            with span(f"backbone.stage{i}"):
                for blk in stage.blocks:
                    x = self._block(blk, x, generator)
                outs.append(layer_norm(x, getattr(self, f"norm{i}"), self.dtype))
                if stage.downsample is not None:
                    x = stage.downsample(x)
        return outs


def _swin_large(dtype=None, use_pallas=False, remat=True, fused_qkv_attention=True):
    """Swin-L: embed 192, depths (2, 2, 18, 2), heads (6, 12, 24, 48), window 7."""
    return SwinTransformer(embed_dims=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                           remat=remat, use_pallas=use_pallas,
                           fused_qkv_attention=fused_qkv_attention, dtype=dtype)


# the reference's three names of one architecture (its pretrained weights
# differ, not its layers)
for _name in ("swin_large_naive_l4w722422k", "swin_large_naive_nopretrain",
              "swin_large_naive_swinlargepreatrain_add"):
    BACKBONES.register(_swin_large, name=_name)


@BACKBONES.register(name="swin_tiny")
def swin_tiny(dtype=None, use_pallas=False, remat=True, fused_qkv_attention=True):
    """Swin-T: embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24)."""
    return SwinTransformer(embed_dims=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                           remat=remat, use_pallas=use_pallas,
                           fused_qkv_attention=fused_qkv_attention, dtype=dtype)


@BACKBONES.register(name="swin_micro")
def swin_micro(dtype=None, use_pallas=False, remat=True, fused_qkv_attention=True):
    """Every layer type of the flagship backbone at test size; pyramid
    channels (32, 64, 128, 256)."""
    return SwinTransformer(embed_dims=32, depths=(1, 2, 1, 1), num_heads=(1, 2, 4, 8),
                           remat=remat, use_pallas=use_pallas,
                           fused_qkv_attention=fused_qkv_attention, dtype=dtype)
