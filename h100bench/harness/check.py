"""What every kind's check shares: the plain reference built from the seed,
and the verdict over the numbers a driver read (``drivers/<kind>.py`` says
what those numbers are)."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from reference import model as R
from reference.weights import draw_weights


def build_reference(spec: dict, seed: int, device) -> R.DiffusionDepth:
    """The reference model, made on ``device`` and filled from ``seed``."""
    with torch.device(device):
        ref = R.build(spec)
    draw_weights(ref, seed)
    return ref.eval()


def judge(readings: List[Dict[str, float]], limits: Dict[str, float]):
    """(checks, failed): each number's worst reading beside its limit, and
    how many checked items broke a limit. A reading that is not finite
    breaks it."""
    checks, failed = {}, 0
    for r in readings:
        if any(not math.isfinite(r[k]) or r[k] > limits[k] for k in limits):
            failed += 1
    for k, lim in limits.items():
        vals = [r[k] for r in readings]
        worst = max(vals, key=lambda v: v if math.isfinite(v) else math.inf, default=None)
        checks[k] = {"value": worst, "limit": lim}
    return checks, failed
