"""Deformable-DETR encoder and AdaBins pixel-query decoder (port of
``diffusiondepth_tpu/models/necks/transformer.py``).

* ``DeformableDetrEncoder``: N x (MSDA self-attention -> LN -> FFN -> LN)
  over flattened multi-scale tokens;
* ``PureMSDEnTransformer``: level embeddings, sine encoding and grid
  reference points around that encoder, memories folded back per level;
* ``PixelTransformerDecoder``: learned bin queries cross-attend to the
  levels' pixel memories in turn (level ``i % levels`` in layer i); heads
  give bin widths, range-attention maps over the mask features and,
  optionally, a classification query's logits.

The bins heads of the reference build on these; no shipped model path
runs them. Batch first, NHWC maps, no padding masks (full images: valid
ratios of 1). The norms are plain LayerNorms in f32 (eps 1e-5), as the
JAX modules use flax's ``nn.LayerNorm``; the multi-head attention keeps
flax's separate ``query``/``key``/``value``/``out`` projections with
biases and computes the product with ``F.scaled_dot_product_attention``
(the JAX package has no Pallas kernel here either). Names follow the JAX
modules' (``layers.{i}``, ``self_attn``, ``norm1``, ``ffn.fc1``, ...).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.msda import MultiScaleDeformableAttention
from ...ops.native import constant
from ...parallel.tensor import whole
from ..common import layer_norm, linear
from .hahi import _grid_reference_points
from .positional_encoding import SinePositionalEncoding


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    x1 = torch.clamp(x, min=eps)
    x2 = torch.clamp(1.0 - x, min=eps)
    return torch.log(x1 / x2)


class _FFN(nn.Module):
    """x + fc2(ReLU(fc1(x)))."""

    def __init__(self, embed_dims: int, feedforward_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(embed_dims, feedforward_channels)
        self.fc2 = nn.Linear(feedforward_channels, embed_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + linear(F.relu(linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class DetrEncoderLayer(nn.Module):
    """MSDA self-attention -> LN -> FFN -> LN (post-norm, mmcv's
    ('self_attn', 'norm', 'ffn', 'norm') order)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4, feedforward_channels: int = 1024,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiScaleDeformableAttention(embed_dims, num_heads, num_levels,
                                                       num_points, dtype=dtype)
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.ffn = _FFN(embed_dims, feedforward_channels, dtype)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)

    def forward(self, x, query_pos, reference_points, spatial_shapes,
                generator: Optional[torch.Generator] = None):
        x = self.self_attn(x, None, query_pos, reference_points, spatial_shapes,
                           generator=generator)
        x = self.ffn(layer_norm(x, self.norm1, self.dtype))
        return layer_norm(x, self.norm2, self.dtype)


class DeformableDetrEncoder(nn.Module):
    def __init__(self, num_layers: int = 6, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4, feedforward_channels: int = 1024,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList([
            DetrEncoderLayer(embed_dims, num_heads, num_levels, num_points,
                             feedforward_channels, dtype) for _ in range(num_layers)])

    def forward(self, x, query_pos, reference_points, spatial_shapes,
                generator: Optional[torch.Generator] = None):
        for layer in self.layers:
            x = layer(x, query_pos, reference_points, spatial_shapes, generator)
        return x


class PureMSDEnTransformer(nn.Module):
    """The deformable multi-scale encoder alone, over ``num_levels`` maps
    (the JAX module takes the count from its input at init)."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256, num_heads: int = 8,
                 num_points: int = 4, feedforward_channels: int = 1024,
                 pe_num_feats: int = 128, num_levels: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dims = embed_dims
        self.level_embeds = nn.Parameter(torch.randn(num_levels, embed_dims))
        self.positional_encoding = SinePositionalEncoding(pe_num_feats)
        self.encoder = DeformableDetrEncoder(num_layers, embed_dims, num_heads, num_levels,
                                             num_points, feedforward_channels, dtype)

    def forward(self, mlvl_feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """NHWC maps of ``embed_dims`` channels, one per level -> the
        encoded memories, the same shapes."""
        if len(mlvl_feats) != self.level_embeds.shape[0]:
            raise ValueError(f"{len(mlvl_feats)} maps for {self.level_embeds.shape[0]} levels")
        b, e = mlvl_feats[0].shape[0], self.embed_dims
        shapes: List[Tuple[int, int]] = [(f.shape[1], f.shape[2]) for f in mlvl_feats]
        dt, dev = mlvl_feats[0].dtype, mlvl_feats[0].device
        src = torch.cat([f.reshape(b, -1, e) for f in mlvl_feats], 1)
        level_embeds = whole(self.level_embeds)
        pos = torch.cat([self.positional_encoding.table(h, w, dev, f.dtype)
                         + level_embeds[i].to(f.dtype)
                         for i, ((h, w), f) in enumerate(zip(shapes, mlvl_feats))], 1)
        ref = constant((_grid_reference_points, tuple(shapes)),
                       lambda: _grid_reference_points(shapes), dev, dt)
        ref = ref[None, :, None, :].expand(b, -1, len(shapes), 2)
        memory = self.encoder(src, pos.expand(b, -1, -1), ref, shapes, generator)
        return [m.reshape(b, h, w, e)
                for m, (h, w) in zip(torch.split(memory, [h * w for h, w in shapes], 1), shapes)]


class _MLP(nn.Module):
    """``num_layers`` Linear layers with ReLU between them."""

    def __init__(self, cin: int, hidden: int, out: int, num_layers: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        dims = [cin] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin in self.layers[:-1]:
            x = F.relu(linear(x, lin, self.dtype))
        return linear(x, self.layers[-1], self.dtype)


class _MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention``: ``query``/``key``/``value``
    projections to (heads, head_dim), softmax(q k^T / sqrt(head_dim)) v,
    and ``out`` back to the width, every projection with a bias."""

    def __init__(self, dims: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = nn.Linear(dims, dims)
        self.key = nn.Linear(dims, dims)
        self.value = nn.Linear(dims, dims)
        self.out = nn.Linear(dims, dims)
        for lin in (self.query, self.key, self.value):
            # flax's kernel is (dims, heads, head_dim): parallel/tensor.py
            # applies JAX's rule to that shape
            lin.jax_kernel_heads = num_heads

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        h = self.num_heads

        def heads(x, lin):
            y = linear(x, lin, self.dtype)
            return y.reshape(y.shape[0], y.shape[1], h, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(heads(q_in, self.query), heads(k_in, self.key),
                                           heads(v_in, self.value))
        o = o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)
        return linear(o, self.out, self.dtype)


class PixelTransformerDecoderLayer(nn.Module):
    """cross-attention (queries -> pixel memory) -> LN -> self-attention
    -> LN -> FFN -> LN."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.cross_attn = _MultiHeadAttention(embed_dims, num_heads, dtype)
        self.norm1 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.self_attn = _MultiHeadAttention(embed_dims, num_heads, dtype)
        self.norm2 = nn.LayerNorm(embed_dims, eps=1e-5)
        self.ffn = _FFN(embed_dims, feedforward_channels, dtype)
        self.norm3 = nn.LayerNorm(embed_dims, eps=1e-5)

    def forward(self, queries, query_pos, memory, memory_pos):
        attn = self.cross_attn(queries + query_pos, memory + memory_pos, memory)
        queries = layer_norm(queries + attn, self.norm1, self.dtype)
        qp = queries + query_pos
        queries = layer_norm(queries + self.self_attn(qp, qp, queries), self.norm2, self.dtype)
        return layer_norm(self.ffn(queries), self.norm3, self.dtype)


class PixelTransformerDecoder(nn.Module):
    """AdaBins-style bins decoding over ``num_feature_levels`` memories."""

    def __init__(self, hidden_dim: int = 256, num_layers: int = 9,
                 num_feature_levels: int = 3, num_queries: int = 100, num_heads: int = 8,
                 classify: bool = True, class_num: int = 249, pe_num_feats: int = 128,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_feature_levels = num_feature_levels
        self.classify = classify
        self.dtype = dtype
        nq = num_queries + (1 if classify else 0)
        self.query_embed = nn.Parameter(torch.randn(nq, hidden_dim))
        self.query_pos = nn.Parameter(torch.randn(nq, hidden_dim))
        self.positional_encoding = SinePositionalEncoding(pe_num_feats)
        self.layers = nn.ModuleList([
            PixelTransformerDecoderLayer(hidden_dim, num_heads, dtype=dtype)
            for _ in range(num_layers)])
        self.decoder_norm = nn.LayerNorm(hidden_dim, eps=1e-5)
        if classify:
            self.class_embed = _MLP(hidden_dim, hidden_dim, class_num, dtype=dtype)
        self.bins_embed = nn.Linear(hidden_dim, 1)
        self.mask_embed = _MLP(hidden_dim, hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, ms_feats: Sequence[torch.Tensor], mask_features: torch.Tensor):
        """ms_feats: NHWC memories of ``hidden_dim`` channels;
        mask_features (B, H, W, hidden_dim). Returns bins (B, Q), the
        range-attention maps (B, H, W, Q) and the class logits (B,
        class_num), or None without ``classify``."""
        b, c = mask_features.shape[0], self.hidden_dim
        queries = whole(self.query_embed)[None].expand(b, -1, -1)
        qpos = whole(self.query_pos)[None].expand(b, -1, -1).to(queries.dtype)
        mems, mposs = [], []
        for f in ms_feats[:self.num_feature_levels]:
            h, w = f.shape[1], f.shape[2]
            mems.append(f.reshape(b, h * w, c))
            mposs.append(self.positional_encoding.table(h, w, f.device, f.dtype).expand(b, -1, -1))
        for i, layer in enumerate(self.layers):
            lvl = i % len(mems)
            queries = layer(queries, qpos, mems[lvl], mposs[lvl])
        out = layer_norm(queries, self.decoder_norm, self.dtype)
        if self.classify:
            class_q, bins_q = out[:, 0], out[:, 1:]
            class_logits = self.class_embed(class_q)
        else:
            bins_q, class_logits = out, None
        bins = linear(bins_q, self.bins_embed, self.dtype)[..., 0]
        mask_embed = self.mask_embed(bins_q)
        dt = torch.promote_types(mask_embed.dtype, mask_features.dtype)
        range_maps = torch.einsum("bqc,bhwc->bhwq", mask_embed.to(dt), mask_features.to(dt))
        return bins, range_maps, class_logits
