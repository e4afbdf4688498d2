"""Depth colour maps for the summaries, without matplotlib (port of
``diffusiondepth_tpu/ops/vis.py``; host-side numpy).

``color_depth``: log-scaled reversed jet, near red and far blue, over the
fixed [1 m, 115 m] log range. ``colormap_255``: plasma on uint8 levels.
Both give matplotlib's values: its float32 normalisation, its 256-entry
tables (``colormaps.py``) and its under/over/bad entries.
"""

from __future__ import annotations

import numpy as np

from .colormaps import JET, PLASMA

_N = 256
# matplotlib's lookup table: the 256 colours, then under (the first),
# over (the last) and bad (zero)
_JET_LUT = np.asarray(JET + (JET[0], JET[-1], (0.0, 0.0, 0.0)), np.float64)
_PLASMA = np.asarray(PLASMA, np.float64)


def color_depth(depth: np.ndarray, vmin: float = 0, vmax: float = 200) -> np.ndarray:
    """(H, W) metric depth -> (H, W, 3) uint8 colour image. ``vmin`` and
    ``vmax`` are unused, as in the reference."""
    x = -np.log(np.asarray(depth, np.float32) + 3.0)
    lo, hi = float(-np.log(115.0)), float(-np.log(1.0))
    # matplotlib's Normalize: float64 arithmetic stored back into float32
    with np.errstate(invalid="ignore"):
        r = (x.astype(np.float64) - lo).astype(np.float32)
        r = (r.astype(np.float64) / (hi - lo)).astype(np.float32)
        r *= _N
        r[r == _N] = _N - 1
        under, over, bad = r < 0, r >= _N, np.isnan(r)
        idx = r.astype(np.int64)
    idx[under], idx[over], idx[bad] = _N, _N + 1, _N + 2
    return (_JET_LUT.take(idx, axis=0, mode="clip") * 255).astype(np.uint8)


def colormap_255(img_255: np.ndarray, cmap: str = "plasma") -> np.ndarray:
    """(H, W) levels -> (H, W, 3) float64 in [0, 1]: the plasma colour of
    each level cast to uint8."""
    if cmap != "plasma":
        raise ValueError(f"colormap {cmap!r}: the port carries plasma only")
    return _PLASMA[np.asarray(img_255).astype(np.uint8)]
