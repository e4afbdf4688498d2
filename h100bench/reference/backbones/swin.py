"""Swin Transformer backbone of the reference (mmseg's names): four stages
of shifted-window attention blocks, each stage's output normed, NCHW.

``build(spec)`` gives the module and its four levels' channels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..model import conv, linear, matmul


def relative_position_index(ws: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return torch.from_numpy((rel[:, :, 0] * (2 * ws - 1) + rel[:, :, 1]).reshape(-1))


def shift_mask(hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, N, N): -100 between tokens of different regions of the shifted image."""
    img = np.zeros((hp, wp), np.int64)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.from_numpy(np.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)
                            .astype(np.float32))


class WindowMSA(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads, self.ws = heads, ws
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))

    def forward(self, x, mask):
        """x (B*nW, N, C); mask (nW, N, N) or None."""
        bw, n, c = x.shape
        d = c // self.heads
        q, k, v = linear(x, self.qkv).reshape(bw, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        attn = matmul(q * d ** -0.5, k.transpose(-2, -1))
        idx = relative_position_index(self.ws).to(x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, -1).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, self.heads, n, n) + mask[None, :, None]
            attn = attn.reshape(bw, self.heads, n, n)
        out = matmul(attn.softmax(-1), v).transpose(1, 2).reshape(bw, n, c)
        return linear(out, self.proj)


class ShiftWindowMSA(nn.Module):
    def __init__(self, dim, heads, ws):
        super().__init__()
        self.w_msa = WindowMSA(dim, heads, ws)


class FFN(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.layers = nn.ModuleList([nn.Sequential(nn.Linear(dim, hidden)),
                                     nn.Linear(hidden, dim)])


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift):
        super().__init__()
        self.ws, self.shift = ws, (ws // 2 if shift else 0)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = ShiftWindowMSA(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim)
        self.ffn = FFN(dim, 4 * dim)

    def forward(self, x):
        """x (B, H, W, C) tokens."""
        b, h, w, c = x.shape
        ws = self.ws
        y = self.norm1(x)
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))  # padded tokens are zeros after the norm
        mask = None
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), (1, 2))
            mask = shift_mask(hp, wp, ws, self.shift).to(x.device)
        y = y.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = self.attn.w_msa(y.reshape(-1, ws * ws, c), mask)
        y = y.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, hp, wp, c)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), (1, 2))
        x = x + y[:, :h, :w]
        fc1, fc2 = self.ffn.layers[0][0], self.ffn.layers[1]
        return x + linear(F.gelu(linear(self.norm2(x), fc1)), fc2)


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h, w = x.shape[1], x.shape[2]
        # the 2x2 neighbourhood, channel slowest (nn.Unfold's order)
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        return linear(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)), self.reduction)


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch=4):
        super().__init__()
        self.projection = nn.Conv2d(3, dim, patch, patch)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        p = self.projection.stride[0]
        h, w = x.shape[2], x.shape[3]
        x = F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p))
        return self.norm(conv(x, self.projection).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    def __init__(self, dim, depth, heads, ws, downsample):
        super().__init__()
        self.blocks = nn.ModuleList([SwinBlock(dim, heads, ws, j % 2 == 1)
                                     for j in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None


class Swin(nn.Module):
    """Four stages; returns each stage's normed output, NCHW."""

    def __init__(self, embed_dims=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48),
                 window_size=7):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dims)
        n = len(depths)
        self.stages = nn.ModuleList([
            SwinStage(embed_dims * 2 ** i, depths[i], num_heads[i], window_size, i < n - 1)
            for i in range(n)])
        for i in range(n):
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dims * 2 ** i))

    def forward(self, rgb):
        x = self.patch_embed(rgb)
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


def build(spec: dict):
    chans = [spec["embed_dims"] * 2 ** i for i in range(len(spec["depths"]))]
    return Swin(spec["embed_dims"], tuple(spec["depths"]), tuple(spec["num_heads"]),
                spec["window_size"]), chans
