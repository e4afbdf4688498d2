"""Scanline depth completion and the sparse-depth noise filters
(port of ``diffusiondepth_tpu/data/depth_completion.py``).

``simple_depth_completion`` fills each empty (== 0) pixel from its
nearest valid neighbours, 4-directional propagation with distance
records:

  pass 1: per column, a downward then an upward sweep;
  pass 2: per row (on pass-1 output), a rightward then a leftward sweep.

Each sweep carries (prev_depth, prev_distance); empty pixels take the
carried value, non-empty pixels are replaced when the carried distance
beats their recorded distance. It runs in the port's C++ engine
(``native/depthops.cpp``, built at first use); without a C++ compiler it
raises. ``simple_depth_completion_numpy`` is the same algorithm in numpy,
called only by name.
"""

from __future__ import annotations

import numpy as np

from ..native import depthops

INF = 1e8


def _sweep(canvas: np.ndarray, dist: np.ndarray, axis: int, reverse: bool):
    """One directional sweep, vectorised across the non-sweep axis, in place."""
    n = canvas.shape[axis]
    idxs = range(n - 1, -1, -1) if reverse else range(n)
    take = (lambda a, i: a[i, :]) if axis == 0 else (lambda a, i: a[:, i])

    first = True
    prev_depth = None
    prev_dist = None
    for i in idxs:
        cur = take(canvas, i)
        cur_d = take(dist, i)
        if first:
            prev_depth = np.zeros_like(cur)
            prev_dist = np.full_like(cur_d, INF)
            first = False
        empty = cur == 0
        new_depth = np.where(empty, prev_depth, cur)
        new_dist = np.where(empty, prev_dist, cur_d)
        better = (~empty) & (cur_d > prev_dist)
        new_depth = np.where(better, prev_depth, new_depth)
        new_dist = np.where(better, prev_dist, new_dist)
        if axis == 0:
            canvas[i, :] = new_depth
            dist[i, :] = new_dist
        else:
            canvas[:, i] = new_depth
            dist[:, i] = new_dist
        prev_depth = new_depth
        prev_dist = new_dist + 1.0


def simple_depth_completion_numpy(depth: np.ndarray):
    """The completion in numpy, sweeps vectorised across the other axis."""
    canvas = depth.astype(np.float32).copy()
    dist = np.zeros_like(canvas)
    # pass 1: columns - down then up (order matters, reference :46-48)
    _sweep(canvas, dist, axis=0, reverse=False)
    _sweep(canvas, dist, axis=0, reverse=True)
    # pass 2: rows - right then left
    _sweep(canvas, dist, axis=1, reverse=False)
    _sweep(canvas, dist, axis=1, reverse=True)
    return canvas, dist


def simple_depth_completion(depth: np.ndarray):
    """Fill empty (==0) pixels from nearest valid neighbours, in the C++
    engine. Returns (filled_depth, distance_record)."""
    return depthops.simple_depth_completion(depth)


# --------------------------------------------------------------- noise filters
# The sparse-LiDAR noise filters. Each densifies the sparse map first, then
# invalidates (sets to -1) sparse returns that sit behind the local
# foreground surface when scanning each column top-to-bottom: LiDAR points
# seen through a nearer object are noise. No pipeline calls them; they are
# kept for capability parity. Sequential along the row axis, vectorised
# across columns (the columns are independent).


def simple_noise_filter(
    sparse_depth_map: np.ndarray,
    lambda_: float = 1.5,
    max_age_ratio: float = 60,
    max_depth: float = 1e9,
) -> np.ndarray:
    """Age-based occlusion noise filter (reference :82-101).

    Top-to-bottom per column: track the foreground depth ``pre``; a pixel
    whose densified depth exceeds ``pre * lambda_`` is occluded — its sparse
    return (if any) is dropped and an age counter ticks; once the age exceeds
    a depth-scaled budget the tracker resets so a genuinely new far surface
    can take over.
    """
    sparse = sparse_depth_map.astype(np.float32).copy()
    dense, _ = simple_depth_completion(sparse)
    rows, cols = sparse.shape
    pre = np.full((cols,), max_depth, np.float32)
    age = np.zeros((cols,), np.float32)
    for r in range(rows):
        d = dense[r]
        keep = d <= pre * lambda_
        has_return = sparse[r] >= 0
        drop = (~keep) & has_return
        # max_age = max(1, max_age_ratio / max(d, 1)) — nearer occluders
        # get a longer budget before the tracker resets.
        max_age = np.maximum(1.0, max_age_ratio / np.maximum(d, 1.0))
        sparse[r] = np.where(drop, -1.0, sparse[r])
        age = np.where(drop, age + 1, np.where(keep, 0.0, age))
        reset = drop & (age >= max_age)
        pre = np.where(keep, d, pre)
        pre = np.where(reset, max_depth, pre)
        age = np.where(reset, 0.0, age)
    return sparse


def simple_noise_filter_0(sparse_depth_map: np.ndarray) -> np.ndarray:
    """Strict monotone filter (reference :55-66): drop any pixel whose
    densified depth exceeds the running column minimum above it."""
    sparse = sparse_depth_map.astype(np.float32).copy()
    dense, _ = simple_depth_completion(sparse)
    # pre only updates on d <= pre, so pre == running column minimum.
    runmin = np.minimum.accumulate(dense, axis=0)
    sparse[1:] = np.where(dense[1:] > runmin[:-1], -1.0, sparse[1:])
    return sparse


def simple_noise_filter_2(
    sparse_depth_map: np.ndarray, thresh: float = 0.6
) -> np.ndarray:
    """Thresholded monotone filter (reference :68-79): like filter_0 but the
    tracker follows any step within ``thresh`` (so it can move backwards)."""
    sparse = sparse_depth_map.astype(np.float32).copy()
    dense, _ = simple_depth_completion(sparse)
    rows, _ = sparse.shape
    pre = dense[0].copy()
    for r in range(1, rows):
        follow = dense[r] <= pre + thresh
        sparse[r] = np.where(follow, sparse[r], -1.0)
        pre = np.where(follow, dense[r], pre)
    return sparse


def _erode_vertical(img: np.ndarray, size: int, border: float) -> np.ndarray:
    """cv2.erode with a MORPH_RECT (width 1, height ``size``) kernel and a
    constant border: per-pixel min over the vertical footprint, anchor at
    ``size // 2``, out-of-bounds rows contributing ``border``."""
    rows = img.shape[0]
    anchor = size // 2
    out = img.copy()
    for k in range(size):
        off = k - anchor
        shifted = np.full_like(img, border)
        if off >= 0:
            if off < rows:
                shifted[: rows - off] = img[off:]
        else:
            if -off < rows:
                shifted[-off:] = img[: rows + off]
        out = np.minimum(out, shifted)
    return out


def simple_noise_filter_3(
    sparse_depth_map: np.ndarray, size: int = 3, thresh: float = 1.5
) -> np.ndarray:
    """Morphological filter (reference :103-113): drop sparse returns more
    than ``thresh`` behind a vertical min-filtered (eroded) dense map."""
    sparse = sparse_depth_map.astype(np.float32).copy()
    dense, _ = simple_depth_completion(sparse)
    eroded = _erode_vertical(dense, size, border=-1.0)
    drop = (sparse >= 0) & (sparse > eroded + thresh)
    return np.where(drop, -1.0, sparse)
