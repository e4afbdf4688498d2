"""Sine positional encoding, DETR style (port of
``diffusiondepth_tpu/models/necks/positional_encoding.py``).

The table is computed with numpy, as the JAX package computes it, so the
two are bit-equal; ``SinePositionalEncoding.table`` hands it to a model as
a tensor copied to the device once (``ops.native.constant``).
Parameter-free; (H, W, 2 * num_feats) for an all-valid mask, the only mask
the HAHI neck passes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.native import constant


def sine_positional_encoding(h: int, w: int, num_feats: int = 256,
                             temperature: float = 10000.0, normalize: bool = False,
                             scale: float = 2.0 * np.pi, eps: float = 1e-6,
                             offset: float = 0.0) -> np.ndarray:
    """The (h, w, 2 * num_feats) f32 table: the y half, then the x half,
    each sin on even and cos on odd features."""
    y_embed = np.tile(np.arange(1, h + 1, dtype=np.float32)[:, None], (1, w))
    x_embed = np.tile(np.arange(1, w + 1, dtype=np.float32)[None, :], (h, 1))
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[-1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, -1:] + eps) * scale
    dim_t = temperature ** (2 * (np.arange(num_feats, dtype=np.float32) // 2) / num_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], -1)
    pos_x = pos_x.reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], -1)
    pos_y = pos_y.reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1).astype(np.float32)


class SinePositionalEncoding:
    """The mmcv module's arguments; ``table`` gives the encoding as a
    tensor on the device."""

    def __init__(self, num_feats: int = 256, temperature: float = 10000,
                 normalize: bool = False, scale: float = 2.0 * np.pi, eps: float = 1e-6,
                 offset: float = 0.0):
        self.num_feats = num_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale
        self.eps = eps
        self.offset = offset

    def _args(self, h: int, w: int):
        return (h, w, self.num_feats, self.temperature, self.normalize, self.scale, self.eps,
                self.offset)

    def __call__(self, h: int, w: int) -> np.ndarray:
        return sine_positional_encoding(*self._args(h, w))

    def table(self, h: int, w: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The (1, h * w, 2 * num_feats) table in ``dtype`` on ``device``."""
        return constant((sine_positional_encoding, *self._args(h, w)),
                        lambda: self(h, w).reshape(1, h * w, -1), device, dtype)
