"""Bilinear sampling in pixel coordinates with zero padding (port of
``diffusiondepth_tpu/ops/msda.py::bilinear_sample_nhwc``).

The deformable convolutions (``deform_conv.py``) and NLSPN's confidence
sampling read through it. The multi-scale deformable attention of the same
JAX module is not ported yet (ROADMAP Queue 1, M15).
"""

from __future__ import annotations

import torch


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
