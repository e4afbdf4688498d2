"""ip_basic classical depth densification (port of
``diffusiondepth_tpu/data/ip_basic.py``).

The morphological completion cascade of kujason/ip_basic, as the reference
vendors it (src/model/ops/ip_basic.py:65-287): invert depth, distance-binned
dilation, hole closing, masked median/bilateral smoothing, invert back.
The datasets apply it to the sparse ``depth_map`` under ``--ip_basic``; it
runs on the host.

The filters reproduce the OpenCV calls of the JAX module in numpy and
scipy, each on float32 as OpenCV computes it:

* ``_dilate`` / ``_close``: ``cv2.dilate`` / ``cv2.morphologyEx(CLOSE)``,
  the border ignored (padding of -inf for the dilation, +inf for the
  erosion);
* ``_median5``: ``cv2.medianBlur(x, 5)``, the border replicated;
* ``_bilateral``: ``cv2.bilateralFilter``'s float path as OpenCV 5
  computes it: radius ``d // 2`` over the offsets within that radius, space
  weights ``exp(-r^2 / (2 sigma_space^2))``, range weights
  ``exp(-dv^2 / (2 sigma_color^2))`` in float32 (OpenCV 4 reads them from
  a 4096-bin table instead, up to ~2e-4 of a pixel away), the centre's
  weight 1, the border reflected (REFLECT_101); the source itself when
  max - min is below FLT_EPSILON;
* ``_gaussian``: ``cv2.GaussianBlur((k, k), 0)`` for k of 1, 3, 5 or 7,
  OpenCV's fixed kernels (``[1, 4, 6, 4, 1] / 16`` at 5), rows then
  columns, the border reflected; other sizes raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

FLT_EPSILON = float(np.finfo(np.float32).eps)
# OpenCV's getGaussianKernel for sigma <= 0 and these sizes
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}


def _kernel_full(n: int) -> np.ndarray:
    return np.ones((n, n), np.uint8)


def _kernel_cross(n: int) -> np.ndarray:
    k = np.zeros((n, n), np.uint8)
    k[n // 2, :] = 1
    k[:, n // 2] = 1
    return k


def _kernel_diamond(n: int) -> np.ndarray:
    r = n // 2
    y, x = np.ogrid[-r : r + 1, -r : r + 1]
    return (np.abs(y) + np.abs(x) <= r).astype(np.uint8)


def _dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    return ndimage.grey_dilation(img, footprint=kernel.astype(bool), mode="constant",
                                 cval=-np.inf)


def _erode(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    return ndimage.grey_erosion(img, footprint=kernel.astype(bool), mode="constant",
                                cval=np.inf)


def _close(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    return _erode(_dilate(img, kernel), kernel)


def _median5(img: np.ndarray) -> np.ndarray:
    return ndimage.median_filter(img, size=5, mode="nearest")


def _bilateral(img: np.ndarray, d: int, sigma_color: float, sigma_space: float) -> np.ndarray:
    """``cv2.bilateralFilter(img, d, sigma_color, sigma_space)`` of a
    float32 (H, W) image (see the module docstring)."""
    src = np.asarray(img, np.float32)
    sigma_color = sigma_color if sigma_color > 0 else 1.0
    sigma_space = sigma_space if sigma_space > 0 else 1.0
    color_coeff = -0.5 / (sigma_color * sigma_color)
    space_coeff = -0.5 / (sigma_space * sigma_space)
    radius = d // 2 if d > 0 else int(round(sigma_space * 1.5))
    radius = max(radius, 1)
    vmin, vmax = float(src.min()), float(src.max())
    if abs(vmin - vmax) < FLT_EPSILON:
        return src.copy()
    h, w = src.shape
    pad = np.pad(src, radius, mode="reflect")
    acc = np.zeros_like(src)
    wsum = np.zeros_like(src)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(i * i + j * j)
            if r > radius or (i == 0 and j == 0):
                continue
            ws = np.float32(math.exp(r * r * space_coeff))
            v = pad[radius + i:radius + i + h, radius + j:radius + j + w]
            dv = v - src
            wt = ws * np.exp(dv * dv * np.float32(color_coeff))
            wsum += wt
            acc += v * wt
    return (acc + src) / (wsum + np.float32(1.0))


def _gaussian(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` of a float32 image."""
    if k not in _SMALL_GAUSSIAN:
        raise NotImplementedError(f"GaussianBlur of size {k} (only OpenCV's fixed 1, 3, 5, 7)")
    kern = np.asarray(_SMALL_GAUSSIAN[k], np.float32)
    r = k // 2
    out = np.asarray(img, np.float32)
    for axis in (1, 0):
        pad = np.pad(out, [(r, r) if a == axis else (0, 0) for a in (0, 1)], mode="reflect")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for t in range(k):
            acc += kern[t] * np.take(pad, np.arange(t, t + n), axis=axis)
        out = acc
    return out


def _top_mask(depth: np.ndarray) -> np.ndarray:
    """True at/below each column's highest valid pixel (the reference's
    per-column loops, ip_basic.py:211-216,231-243, vectorised)."""
    valid = depth > 0.1
    top_row = np.argmax(valid, axis=0)  # 0 when column empty
    top_row = np.where(valid.any(axis=0), top_row, depth.shape[0])
    rows = np.arange(depth.shape[0])[:, None]
    return rows >= top_row[None, :]


def fill_in_fast(
    depth_map: np.ndarray,
    max_depth: float = 100.0,
    custom_kernel: Optional[np.ndarray] = None,
    extrapolate: bool = False,
    blur_type: str = "bilateral",
    blur_kernel_size: int = 5,
) -> np.ndarray:
    """Single-scale completion (reference ip_basic.py:65-134)."""
    d = np.float32(depth_map).copy()
    kernel = _kernel_diamond(5) if custom_kernel is None else custom_kernel

    valid = d > 0.1
    d[valid] = max_depth - d[valid]  # invert so dilation prefers NEAR

    d = _dilate(d, kernel)
    d = _close(d, _kernel_full(5))

    empty = d < 0.1
    d[empty] = _dilate(d, _kernel_full(7))[empty]

    if extrapolate:
        mask = _top_mask(d)
        col_top_vals = d[np.argmax(d > 0.1, axis=0), np.arange(d.shape[1])]
        d = np.where(~mask, col_top_vals[None, :], d).astype(np.float32)
        empty = d < 0.1
        d[empty] = _dilate(d, _kernel_full(31))[empty]

    d = _median5(d)
    if blur_type == "bilateral":
        d = _bilateral(d, blur_kernel_size, 1.5, 2.0)
    elif blur_type == "gaussian":
        valid = d > 0.1
        blurred = _gaussian(d, blur_kernel_size)
        d[valid] = blurred[valid]

    valid = d > 0.1
    d[valid] = max_depth - d[valid]
    return d


def fill_in_multiscale(
    depth_map: np.ndarray,
    max_depth: float = 100.0,
    extrapolate: bool = False,
    blur_type: str = "bilateral",
) -> Tuple[np.ndarray, None]:
    """Distance-binned multi-scale completion (reference ip_basic.py:137-287):
    far/med/near points dilated with growing cross kernels so that close
    structures stay crisp while distant returns spread further."""
    d_in = np.float32(depth_map).copy()

    near = (d_in > 0.1) & (d_in <= 15.0)
    med = (d_in > 15.0) & (d_in <= 30.0)
    far = d_in > 30.0

    d = d_in.copy()
    valid = d > 0.1
    d[valid] = max_depth - d[valid]

    dil_far = _dilate(d * far, _kernel_cross(3))
    dil_med = _dilate(d * med, _kernel_cross(5))
    dil_near = _dilate(d * near, _kernel_cross(7))

    out = d.copy()
    for dil in (dil_far, dil_med, dil_near):  # nearest wins (written last)
        m = dil > 0.1
        out[m] = dil[m]

    out = _close(out, _kernel_full(5))

    blurred = _median5(out)
    valid = out > 0.1
    out[valid] = blurred[valid]

    # fill holes below each column's highest return
    mask = _top_mask(out)
    empty = (out <= 0.1) & mask
    out[empty] = _dilate(out, _kernel_full(9))[empty]

    if extrapolate:
        col_top_vals = out[np.argmax(out > 0.1, axis=0), np.arange(out.shape[1])]
        out = np.where(~mask, col_top_vals[None, :], out).astype(np.float32)
        mask = np.ones_like(mask)

    for _ in range(6):
        empty = (out < 0.1) & mask
        out[empty] = _dilate(out, _kernel_full(5))[empty]

    blurred = _median5(out)
    valid = (out > 0.1) & mask
    out[valid] = blurred[valid]

    if blur_type == "gaussian":
        blurred = _gaussian(out, 5)
        valid = (out > 0.1) & mask
        out[valid] = blurred[valid]
    elif blur_type == "bilateral":
        blurred = _bilateral(out, 5, 0.5, 2.0)
        out[valid] = blurred[valid]

    valid = out > 0.1
    out[valid] = max_depth - out[valid]
    return out, None


def densify_depth_map(depth_map: np.ndarray, depth_mask: np.ndarray) -> np.ndarray:
    """The model-level ip_basic branch, host-side: mask, clamp to [0, 100],
    then ``fill_in_multiscale`` (the reference's ``_extract_depth_ipbasic``,
    diffusion_dcbase_model.py:96-110, in the working form the datasets
    apply under ``--ip_basic``). Accepts (H, W) or (H, W, 1); returns the
    same shape."""
    dm = np.float32(depth_map)
    mask = np.float32(depth_mask).reshape(dm.shape)
    chan = dm.ndim == 3
    if chan:
        dm, mask = dm[..., 0], mask[..., 0]
    dm = np.clip(dm * mask, 0.0, 100.0)
    out, _ = fill_in_multiscale(dm)
    return out[..., None] if chan else out
