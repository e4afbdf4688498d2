"""Multi-scale deformable attention (port of ``diffusiondepth_tpu/ops/msda.py``).

``bilinear_sample_nhwc`` samples a map in pixel coordinates (the deformable
convolutions and NLSPN's confidence read through it). ``ms_deform_attn`` is
the MSDA core with the math of mmcv's ``multi_scale_deformable_attn_pytorch``:
each query reads every level at ``reference_points + offsets`` by bilinear
sampling (zeros padding, ``align_corners=False``) and sums the reads with
its attention weights. ``MultiScaleDeformableAttention`` is mmcv's layer
around it (value and output projections, learned offsets and weights,
residual and dropout), with mmcv's parameter names.

The JAX package has no Pallas kernel here (an XLA gather composition), and
neither has the port: the core runs on ``F.grid_sample`` level by level, in
the compute dtype (bf16 included, on the card and the CPU), and keeps one
level's sampled values (B*heads, d, P, Nq) alive at a time. In bf16 the
grid is bf16; on the card ``grid_sample`` turns it into a pixel position
in f32, while the JAX package (its ``x * w - 0.5`` is bf16) and PyTorch's
CPU bf16 ``grid_sample`` round the position to bf16, so that on a level
wider than 128 their reads fall on whole pixels. A hand-written
gather-attend kernel, which would not write the sampled values out, is
later speed work.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.common import linear
from ..parallel.mesh import draw_rows


def bilinear_sample_nhwc(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with zero padding (``grid_sample`` with
    ``align_corners=False`` in pixel space).

    img: (B, H, W, C); x, y: (B, Q) pixel coordinates, which may lie outside
    the image. Returns (B, Q, C): the four corners (x0, y0), (x1, y0),
    (x0, y1), (x1, y1) summed in that order, each clamped into the image for
    its read and weighted by zero where it lies outside."""
    b, h, w, c = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0

    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1

    flat = img.reshape(b, h * w, c)

    def corner(xi, yi, wxi, wyi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        idx = yc * w + xc  # (B, Q)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))  # (B, Q, C)
        wgt = (wxi * wyi) * valid.to(img.dtype)
        return vals * wgt[..., None]

    return (corner(x0, y0, wx0, wy0)
            + corner(x1, y0, wx1, wy0)
            + corner(x0, y1, wx0, wy1)
            + corner(x1, y1, wx1, wy1))


def _attend_level(value_l: torch.Tensor, hw: Tuple[int, int], loc: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """One level: value_l (B, h*w, heads, d), loc (B, Nq, heads, P, 2) in
    [0, 1], weights (B, Nq, heads, P) -> (B*heads, d, Nq). The sampled
    values (B*heads, d, P, Nq) live only inside this call; with the queries
    innermost, the sum over the points reads them at full width."""
    b, _, heads, d = value_l.shape
    nq, p = loc.shape[1], loc.shape[3]
    h, w = hw
    # contiguous: torch 2.13's CPU bf16 grid_sample reads a strided view
    # (the batch-1 reshape is one) wrongly
    img = value_l.permute(0, 2, 3, 1).reshape(b * heads, d, h, w).contiguous()
    grid = (2.0 * loc - 1.0).to(img.dtype).permute(0, 2, 3, 1, 4).reshape(b * heads, p, nq, 2)
    sampled = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)
    wgt = weights.permute(0, 2, 3, 1).reshape(b * heads, 1, p, nq)
    if torch.is_grad_enabled() and (sampled.requires_grad or wgt.requires_grad):
        return (sampled * wgt).sum(2)
    return sampled.mul_(wgt).sum(2)  # no autograd: weight the samples in place


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """The MSDA core.

    value: (B, Nv, heads, d), the levels' tokens concatenated along Nv;
    spatial_shapes: (H_l, W_l) per level; sampling_locations: (B, Nq,
    heads, L, P, 2) as (x, y) normalised to [0, 1] (may lie outside);
    attention_weights: (B, Nq, heads, L, P). Returns (B, Nq, heads * d) in
    value's dtype, summed level by level."""
    b, nv, heads, d = value.shape
    nq, n_lvl = sampling_locations.shape[1], sampling_locations.shape[3]
    if n_lvl != len(spatial_shapes):
        raise ValueError(f"{n_lvl} levels of locations for {len(spatial_shapes)} shapes")
    out = None
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        part = _attend_level(value[:, start:start + h * w], (h, w),
                             sampling_locations[:, :, :, lvl], attention_weights[:, :, :, lvl])
        start += h * w
        out = part if out is None else out + part
    return out.reshape(b, heads, d, nq).permute(0, 3, 1, 2).reshape(b, nq, heads * d)


def _msda_offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """mmcv's rotating-grid bias of ``sampling_offsets``: head i points at
    angle 2*pi*i/heads, scaled to the unit square's edge, point k at k+1
    times that, the same for every level."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (heads, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    scale = np.arange(1, num_points + 1, dtype=np.float32)[None, None, :, None]
    return (grid * scale).reshape(-1)


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """Dropout's keep mask, each element kept with probability 1 - rate,
    drawn from ``generator`` (at the global batch's shape under an active
    data-parallel mesh, this rank's rows kept)."""
    return draw_rows(torch.rand, shape, generator=generator, device=device) < 1.0 - rate


class MultiScaleDeformableAttention(nn.Module):
    """mmcv's MSDA layer. The offset and weight projections are sized for
    ``num_levels`` level slots (reference checkpoints size them for 4); the
    run's level count is ``len(spatial_shapes)``, and the extra slots are
    sliced off the offsets after the reshape. The attention weights are
    softmaxed in f32 over all ``num_levels * num_points`` slots and only
    then sliced, so the weights used sum to less than 1 when fewer levels
    run (mmcv's order of operations). Offsets are in units of each level's
    (W, H). In training mode the output projection's result goes through
    dropout (``dropout`` rate), its keep mask drawn from the caller's
    generator. ``dtype``: the compute dtype of the projections (None: the
    input's)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_levels: int = 4,
                 num_points: int = 4, dropout: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.dropout = dropout
        self.dtype = dtype
        n_slots = num_heads * num_levels * num_points
        self.value_proj = nn.Linear(embed_dims, embed_dims)
        self.sampling_offsets = nn.Linear(embed_dims, n_slots * 2)
        self.attention_weights = nn.Linear(embed_dims, n_slots)
        self.output_proj = nn.Linear(embed_dims, embed_dims)
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_(
                torch.from_numpy(_msda_offset_bias_init(num_heads, num_levels, num_points)))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()
            for lin in (self.value_proj, self.output_proj):
                nn.init.xavier_uniform_(lin.weight)
                lin.bias.zero_()

    def forward(self, query: torch.Tensor, value: Optional[torch.Tensor],
                query_pos: Optional[torch.Tensor], reference_points: torch.Tensor,
                spatial_shapes: Sequence[Tuple[int, int]],
                identity: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query (B, Nq, C); value (B, Nv, C), or None for self-attention;
        query_pos added to the query (not to the identity); reference_points
        (B, Nq, L, 2) in [0, 1]; identity defaults to the query. Returns
        (B, Nq, C) = identity + output_proj(MSDA)."""
        if value is None:
            value = query
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos
        b, nq, c = query.shape
        heads, l_cfg, p = self.num_heads, self.num_levels, self.num_points
        n_lvl = len(spatial_shapes)

        v = linear(value, self.value_proj, self.dtype)
        v = v.reshape(b, value.shape[1], heads, c // heads)
        off = linear(query, self.sampling_offsets, self.dtype).reshape(
            b, nq, heads, l_cfg, p, 2)[:, :, :, :n_lvl]
        logits = linear(query, self.attention_weights, self.dtype)
        attn = torch.softmax(logits.reshape(b, nq, heads, l_cfg * p).float(), -1)
        attn = attn.to(query.dtype).reshape(b, nq, heads, l_cfg, p)[:, :, :, :n_lvl]
        # offsets over each level's (W, H), by Python scalars: a normaliser
        # tensor would be a host constant copied to the card at every call
        off = torch.stack([torch.stack([off[:, :, :, i, :, 0] / w, off[:, :, :, i, :, 1] / h],
                                       -1) for i, (h, w) in enumerate(spatial_shapes)], 3)
        locations = reference_points[:, :, None, :, None, :] + off

        out = ms_deform_attn(v, spatial_shapes, locations, attn)
        out = linear(out, self.output_proj, self.dtype)
        if self.training and self.dropout > 0:
            keep = keep_mask(out.shape, self.dropout, generator, out.device)
            out = torch.where(keep, out / (1.0 - self.dropout), torch.zeros_like(out))
        return identity + out
