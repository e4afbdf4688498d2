"""Resize and adaptive pooling for NHWC tensors (port of
``diffusiondepth_tpu/ops/resize.py``).

Bilinear resize and adaptive average pooling are separable: two small
dense products with matrices built in numpy, matching
``torch.nn.functional.interpolate`` and ``adaptive_avg_pool2d`` window
arithmetic, and copied to the device once (``native.constant``), as are
the nearest indices. The matrices take the input's dtype, as in the JAX package, so
a bf16 map is resized with bf16 weights. Nearest resize gathers the rows
and columns torch's legacy 'nearest' picks, floor(i * in / out) in integer
arithmetic; adaptive max pooling is torch's, whose windows are the same.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .native import constant


def _bilinear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        if align_corners:
            m[0, 0] = 1.0
            return m
        src = np.array([0.5 * in_size / 1.0 - 0.5])
    elif align_corners:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    for i in range(out_size):
        m[i, lo[i]] += 1.0 - w[i]
        m[i, hi[i]] += w[i]
    return m


def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -((-(i + 1) * in_size) // out_size)
        m[i, start:end] = 1.0 / (end - start)
    return m


def _table(x: torch.Tensor, make: Callable[..., np.ndarray], *args, dtype=None) -> torch.Tensor:
    """``make(*args)`` on ``x``'s device, made and copied once."""
    return constant((make, *args), lambda: make(*args), x.device, dtype)


def _apply_hw_matrices(x: torch.Tensor, make: Callable[..., np.ndarray], h_args: Tuple,
                       w_args: Tuple) -> torch.Tensor:
    mh = _table(x, make, *h_args, dtype=x.dtype)
    mw = _table(x, make, *w_args, dtype=x.dtype)
    x = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("ow,bhwc->bhoc", mw, x)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return x
    return _apply_hw_matrices(x, _bilinear_matrix, (h_in, h_out, align_corners),
                              (w_in, w_out, align_corners))


def adaptive_avg_pool2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = output_size
    if (h_in, w_in) == (h_out, w_out):
        return x
    return _apply_hw_matrices(x, _adaptive_avg_matrix, (h_in, h_out), (w_in, w_out))


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    return np.minimum((np.arange(out_size) * in_size) // out_size, in_size - 1)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return x
    return (x.index_select(1, _table(x, _nearest_index, h_in, h_out))
            .index_select(2, _table(x, _nearest_index, w_in, w_out)))


def adaptive_max_pool2d(x: torch.Tensor, output_size: Tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(output_size):
        return x
    y = F.adaptive_max_pool2d(x.permute(0, 3, 1, 2), tuple(output_size))
    return y.permute(0, 2, 3, 1)


def upsample2x_bilinear(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """scale_factor=2 bilinear upsampling."""
    return resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2), align_corners)
