"""The AdaBins bins chamfer loss (port of
``diffusiondepth_tpu/losses/chamfer.py``): for 1-D point sets (bin centres
against the valid ground-truth depths) the chamfer distance is a masked
nearest-neighbour squared distance over one (B, P, T) pairwise matrix."""

from __future__ import annotations

import torch


def bins_chamfer_loss(bins: torch.Tensor, target_depth: torch.Tensor,
                      loss_weight: float = 1.0, valid_threshold: float = 1e-3) -> torch.Tensor:
    """bins (B, P + 1) bin edges; target_depth (B, ...) depth maps. The
    mean over the batch of (mean over centres of the nearest valid depth's
    d^2 + mean over valid depths of the nearest centre's d^2)."""
    centers = 0.5 * (bins[:, 1:] + bins[:, :-1])
    b = centers.shape[0]
    target = target_depth.reshape(b, -1).float()
    valid = target >= valid_threshold
    d2 = torch.square(centers[:, :, None] - target[:, None, :])
    min_x = torch.where(valid[:, None, :], d2, torch.full_like(d2, 1e30)).min(dim=2).values
    any_valid = valid.any(dim=1)
    cham_x = torch.where(any_valid[:, None], min_x, torch.zeros_like(min_x)).mean(dim=1)
    min_y = d2.min(dim=1).values
    n_valid = valid.sum(dim=1).clamp_min(1)
    cham_y = torch.where(valid, min_y, torch.zeros_like(min_y)).sum(dim=1) / n_valid
    return loss_weight * (cham_x + cham_y).mean()
