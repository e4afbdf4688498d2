"""Host-side image transforms on numpy arrays, reproducing what Pillow
computes for the augmentation chain of the KITTI-DC loader.

Images are numpy arrays: RGB as (H, W, 3) uint8, depth maps as (H, W)
float32 (Pillow's mode 'F'). Each function follows Pillow's C code:

* ``rotate``: ``Image.rotate(angle, expand=False)``, counter-clockwise
  about (w/2, h/2). Nearest (the depth maps) walks the inverse affine map
  in 16.16 fixed point as Pillow's ``affine_fixed``; bicubic (RGB) is
  Pillow's generic transform with its a = -1 cubic, edge-clamped taps and
  truncation to uint8. Pixels whose source falls outside are 0.
* ``resize_shorter``: ``Image.resize``. BICUBIC and BILINEAR are Pillow's
  separable convolution (the a = -0.5 cubic of support 2, or the triangle
  of support 1, the support scaled by the downscale factor), horizontal
  pass first. On uint8 each pass is rounded back to uint8 from 22-bit
  fixed-point coefficients; on float32 (BILINEAR, Pillow's mode 'F') the
  coefficients and the sums are double, each pass stored as float32.
  NEAREST samples the pixel centre of each output pixel, accumulated in
  double as Pillow's ``ImagingScaleAffine``.
* ``center_crop``: torchvision's, the offsets ``int(round((H - h) / 2))``.
* ``adjust_brightness/contrast/saturation``: ``ImageEnhance`` blends
  against black, the rounded mean of the L image, and the L image (ITU-R
  601-2 luma in 16-bit fixed point), with ``Image.blend``'s float32
  arithmetic, clipping and truncation.

Depth maps come out bit-exact; RGB within one uint8 level of Pillow's.
"""

from __future__ import annotations

import math
import random
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

NEAREST = 0
BILINEAR = 2
BICUBIC = 3


def size(img: np.ndarray) -> Tuple[int, int]:
    """(width, height), as Pillow's ``Image.size``."""
    return img.shape[1], img.shape[0]


def hflip(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def crop(img: np.ndarray, top: int, left: int, height: int, width: int) -> np.ndarray:
    """Pillow's ``crop((left, top, left + width, top + height))``: the part
    outside the image is 0."""
    out = np.zeros((height, width) + img.shape[2:], img.dtype)
    h, w = img.shape[:2]
    y0, y1 = max(top, 0), min(top + height, h)
    x0, x1 = max(left, 0), min(left + width, w)
    if y0 < y1 and x0 < x1:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def center_crop(img: np.ndarray, crop_hw: Tuple[int, int]) -> np.ndarray:
    """torchvision's ``center_crop`` of an (H, W[, C]) array to ``crop_hw``."""
    ch, cw = crop_hw
    w, h = size(img)
    return crop(img, int(round((h - ch) / 2.0)), int(round((w - cw) / 2.0)), ch, cw)


# ------------------------------------------------------------------ rotate
def _rotate_matrix(w: int, h: int, angle: float):
    """The inverse affine map (a, b, c, d, e, f) of ``Image.rotate``."""
    cx, cy = w / 2, h / 2
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]
    m[2], m[5] = m[0] * -cx + m[1] * -cy + m[2], m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return m


def _fix16(v: float) -> int:
    return math.floor(v * 65536.0 + 0.5)


def _affine_nearest(img: np.ndarray, m) -> np.ndarray:
    """Pillow's ``affine_fixed``: 16.16 fixed point, nearest source pixel."""
    h, w = img.shape[:2]
    for x, y in ((0, 0), (w, h), (0, h), (w, 0)):
        if not (abs(x * m[0] + y * m[1] + m[2]) < 32768.0
                and abs(x * m[3] + y * m[4] + m[5]) < 32768.0):
            raise ValueError("image too large for the fixed-point nearest rotation")
    a0, a1, a3, a4 = (_fix16(v) for v in (m[0], m[1], m[3], m[4]))
    a2 = _fix16(m[2] + m[0] * 0.5 + m[1] * 0.5)
    a5 = _fix16(m[5] + m[3] * 0.5 + m[4] * 0.5)
    ys = np.arange(h, dtype=np.int64)[:, None]
    xs = np.arange(w, dtype=np.int64)[None, :]
    xin = (a2 + ys * a1 + xs * a0) >> 16
    yin = (a5 + ys * a4 + xs * a3) >> 16
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(img)
    out[ok] = img[yin[ok], xin[ok]]
    return out


def _cubic_a1(v1, v2, v3, v4, d):
    """Pillow's BICUBIC macro of Geometry.c (the a = -1 cubic), in double."""
    p1 = v2
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return p1 + d * (p2 + d * (p3 + d * p4))


def _affine_bicubic(img: np.ndarray, m) -> np.ndarray:
    """Pillow's generic affine transform with ``bicubic_filter32RGB``."""
    h, w = img.shape[:2]
    ys = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xs = np.arange(w, dtype=np.float64)[None, :] + 0.5
    xx = m[0] * xs + m[1] * ys + m[2]
    yy = m[3] * xs + m[4] * ys + m[5]
    inside = (xx >= 0.0) & (xx < w) & (yy >= 0.0) & (yy < h)
    xx, yy = xx[inside] - 0.5, yy[inside] - 0.5
    x0, y0 = np.floor(xx), np.floor(yy)
    dx, dy = (xx - x0)[:, None], (yy - y0)[:, None]
    x0, y0 = x0.astype(np.int64) - 1, y0.astype(np.int64) - 1
    flat = img.reshape(h * w, -1)
    cols = [np.clip(x0 + i, 0, w - 1) for i in range(4)]
    rows = []
    for j in range(4):
        base = np.clip(y0 + j, 0, h - 1) * w
        taps = [np.take(flat, base + c, axis=0).astype(np.float64) for c in cols]
        rows.append(_cubic_a1(*taps, dx))
    v = _cubic_a1(*rows, dy)
    out = np.zeros((h, w, flat.shape[1]), np.uint8)
    # clip then truncate: <= 0 -> 0, >= 255 -> 255, else (UINT8)v
    out[inside] = np.clip(v, 0.0, 255.0).astype(np.uint8)
    return out.reshape(img.shape)


def rotate(img: np.ndarray, angle: float, resample) -> np.ndarray:
    """``Image.rotate(angle, resample, expand=False)``: counter-clockwise
    about the centre, no expansion; NEAREST for any dtype, BICUBIC for
    uint8."""
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    m = _rotate_matrix(w, h, angle)
    if resample == NEAREST:
        return _affine_nearest(img, m)
    if resample == BICUBIC and img.dtype == np.uint8:
        return _affine_bicubic(img, m)
    raise NotImplementedError(f"rotate with resample {resample} of {img.dtype}")


# ------------------------------------------------------------------ resize
_PRECISION_BITS = 32 - 8 - 2


def _bicubic_kernel(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` of Resample.c, a = -0.5."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear_kernel(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bilinear_filter``: the triangle of support 1."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# resample -> (filter, support) as Pillow's ``filterp``
_FILTERS = {BICUBIC: (_bicubic_kernel, 2.0), BILINEAR: (_bilinear_kernel, 1.0)}


def _coeffs_double(in_size: int, out_size: int, resample):
    """Pillow's ``precompute_coeffs``: per output pixel its first source
    pixel and the normalised double weights of its taps (0 past the
    last)."""
    kernel, support = _FILTERS[resample]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centers + support + 0.5).astype(np.int64), in_size) - xmin
    ks = np.arange(ksize)
    w = kernel((ks[None, :] + xmin[:, None] - centers[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(ks[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # in order, as the C loop sums
        ww = ww + w[:, k]
    return xmin, np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)


def _coeffs(in_size: int, out_size: int, resample):
    """``_coeffs_double`` + Pillow's ``normalize_coeffs_8bpc``: the
    weights as int32 fixed point."""
    xmin, w = _coeffs_double(in_size, out_size, resample)
    scaled = w * (1 << _PRECISION_BITS)
    kk = np.where(w < 0, (-0.5 + scaled).astype(np.int64), (0.5 + scaled).astype(np.int64))
    return xmin, kk


def _resample_axis(src: np.ndarray, out_size: int, axis: int, resample) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` (0 or 1) of an
    (H, W, C) uint8 array, in int32 as Pillow sums."""
    in_size = src.shape[axis]
    xmin, kk = _coeffs(in_size, out_size, resample)
    s = np.moveaxis(src, axis, 0)
    acc = np.full((out_size,) + s.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        wk = kk[:, k].astype(np.int32).reshape((-1,) + (1,) * (s.ndim - 1))
        acc += np.take(s, idx, axis=0).astype(np.int32) * wk
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resample_axis_f32(src: np.ndarray, out_size: int, axis: int, resample) -> np.ndarray:
    """One pass of Pillow's ``ImagingResample*_32bpc`` on float32: the
    taps summed in order in double, stored as float32."""
    in_size = src.shape[axis]
    xmin, w = _coeffs_double(in_size, out_size, resample)
    s = np.moveaxis(src, axis, 0)
    acc = np.zeros((out_size,) + s.shape[1:], np.float64)
    for k in range(w.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        acc += np.take(s, idx, axis=0) * w[:, k].reshape((-1,) + (1,) * (s.ndim - 1))
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def _resize_separable(img: np.ndarray, new_w: int, new_h: int, resample) -> np.ndarray:
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    axis_pass = _resample_axis if img.dtype == np.uint8 else _resample_axis_f32
    if new_w != w:
        x = axis_pass(x, new_w, 1, resample)
    if new_h != h:
        x = axis_pass(x, new_h, 0, resample)
    return x.reshape((new_h, new_w) + img.shape[2:])


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's ``ImagingScaleAffine`` source index per output pixel: the
    centre, accumulated in double in order."""
    step = float(in_size) / out_size
    pos = np.add.accumulate(np.concatenate([[0.0 + step * 0.5], np.full(out_size - 1, step)]))
    return np.where(pos < 0, -1, pos.astype(np.int64))


def resize(img: np.ndarray, new_w: int, new_h: int, resample) -> np.ndarray:
    """``Image.resize((new_w, new_h), resample)`` for NEAREST (any dtype),
    BICUBIC (uint8) and BILINEAR (uint8 and float32)."""
    h, w = img.shape[:2]
    if (new_w, new_h) == (w, h):
        return img.copy()
    if resample == NEAREST:
        yi, xi = _nearest_index(h, new_h), _nearest_index(w, new_w)
        if (yi < 0).any() or (yi >= h).any() or (xi < 0).any() or (xi >= w).any():
            raise ValueError("nearest resize index out of range")
        return img[yi[:, None], xi[None, :]]
    if (resample == BICUBIC and img.dtype == np.uint8
            or resample == BILINEAR and img.dtype in (np.uint8, np.float32)):
        return _resize_separable(img, new_w, new_h, resample)
    raise NotImplementedError(f"resize with resample {resample} of {img.dtype}")


def resize_shorter(img: np.ndarray, size_: int, resample) -> np.ndarray:
    """torchvision ``T.Resize(int)``: the shorter side to ``size_``, aspect
    kept."""
    w, h = size(img)
    if h <= w:
        new_h, new_w = size_, max(1, round(size_ * w / h))
    else:
        new_w, new_h = size_, max(1, round(size_ * h / w))
    return resize(img, new_w, new_h, resample)


# ------------------------------------------------------------------ colour
def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: ITU-R 601-2 luma in 16-bit fixed point."""
    c = rgb.astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def _blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)`` on uint8: float32 arithmetic,
    truncated; clipped to [0, 255] when alpha is outside [0, 1]."""
    a = np.float32(alpha)
    if a == 0.0:
        return np.broadcast_to(im1, im2.shape).copy()
    if a == 1.0:
        return im2.copy()
    in1 = np.broadcast_to(im1, im2.shape).astype(np.int32)
    diff = (im2.astype(np.int32) - in1).astype(np.float32)
    v = in1.astype(np.float32) + a * diff
    if 0 <= a <= 1.0:
        return v.astype(np.uint8)
    return np.where(v <= 0.0, 0, np.where(v >= 255.0, 255, np.clip(v, 0, 255))).astype(np.uint8)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(np.zeros((), np.uint8), img, factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    luma = _luma(img)
    mean = int(int(luma.sum(dtype=np.int64)) / luma.size + 0.5)
    return _blend(np.full((), mean, np.uint8), img, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(_luma(img)[..., None], img, factor)


def color_jitter(img: np.ndarray, brightness: float, contrast: float, saturation: float,
                 rng: random.Random) -> np.ndarray:
    """torchvision ``T.ColorJitter``: random factors, random op order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im, f=f: adjust_brightness(im, f))
    if contrast > 0:
        f = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im, f=f: adjust_contrast(im, f))
    if saturation > 0:
        f = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im, f=f: adjust_saturation(im, f))
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


# ------------------------------------------------------------------ arrays
def rgb_to_normalized_array(img: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (H, W, 3), /255, ImageNet-normalized."""
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def depth_to_array(img: np.ndarray) -> np.ndarray:
    """(H, W) float32 depth -> (H, W, 1)."""
    return np.asarray(img, np.float32)[..., None]


def sparse_sample(dep: np.ndarray, num_sample: int, rng: random.Random) -> np.ndarray:
    """Random sparse-depth subsampling: keep ``num_sample`` of the valid
    points, drawn with ``rng.sample``."""
    flat = dep.reshape(-1)
    nnz = np.nonzero(flat > 0.0001)[0]
    if num_sample <= 0 or len(nnz) == 0:
        return np.zeros_like(dep)
    count = min(num_sample, len(nnz))
    chosen = np.asarray(rng.sample(range(len(nnz)), count))
    mask = np.zeros_like(flat)
    mask[nnz[chosen]] = 1.0
    return (flat * mask).reshape(dep.shape)
