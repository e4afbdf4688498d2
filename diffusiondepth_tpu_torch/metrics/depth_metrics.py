"""Depth evaluation metrics (port of ``diffusiondepth_tpu/metrics/depth_metrics.py``):
8 metrics over valid pixels (gt > 1e-4), as masked reductions over the batch.
"""

from __future__ import annotations

from typing import Dict

import torch

METRIC_NAMES = ["RMSE", "MAE", "iRMSE", "iMAE", "REL", "D^1", "D^2", "D^3"]

T_VALID = 1e-4


def evaluate_depth_metrics(sample: Dict, output: Dict) -> torch.Tensor:
    """Returns a (1, 8) f32 row in the order of ``METRIC_NAMES``."""
    pred = output["pred"].float()
    gt = sample["gt"].float()

    m = (gt > T_VALID).float()
    denom = m.sum() + 1e-8

    zero = torch.zeros((), device=pred.device)
    pred_inv = torch.where(pred > T_VALID, 1.0 / (pred + 1e-8), zero)
    gt_inv = torch.where(gt > T_VALID, 1.0 / (gt + 1e-8), zero)

    diff = (pred - gt) * m
    rmse = torch.sqrt((diff * diff).sum() / denom)
    mae = diff.abs().sum() / denom

    diff_inv = (pred_inv - gt_inv) * m
    irmse = torch.sqrt((diff_inv * diff_inv).sum() / denom)
    imae = diff_inv.abs().sum() / denom

    rel = (diff.abs() / (gt + 1e-8) * m).sum() / denom

    ratio = torch.maximum(gt / (pred + 1e-8), pred / (gt + 1e-8))
    d1 = ((ratio < 1.25).float() * m).sum() / denom
    d2 = ((ratio < 1.25 ** 2).float() * m).sum() / denom
    d3 = ((ratio < 1.25 ** 3).float() * m).sum() / denom

    return torch.stack([rmse, mae, irmse, imae, rel, d1, d2, d3])[None]
