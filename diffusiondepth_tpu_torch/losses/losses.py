"""Loss framework (port of ``diffusiondepth_tpu/losses/losses.py``).

The ``w1*NAME+w2*NAME`` spec, ``LossComputer`` returning ``(loss_sum,
per-term row)``, the masked L1/L2 (per-sample masked mean, summed over the
batch), the AdaBins scale-invariant log loss, the DDIM term that the
head computes (``output['ddim_loss']``) and the BIN term, the sum of
``output['bin_losses']``. All in f32.

Under an active data-parallel mesh (``parallel/mesh.py``) each rank
returns its share of the global batch's loss, the shares summing over the
ranks to the value JAX computes on the global batch: L1 and L2 are sums of
per-sample terms, so a rank's share is its own sum; Sig is computed over
every valid pixel of the global batch (n, sum g and sum (g - mean)^2
all-reduced) and DDIM is the mean over the rank's rows, each times the
rank's share of the rows; the BIN terms are either such means or global
masked means (``refine_losses.py``), times the same share.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import all_reduce_sum, local_share

T_VALID = 1e-4


def _masked_per_sample(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    axes = tuple(range(1, d.ndim))
    return (d * mask).sum(axes) / (mask.sum(axes) + 1e-8)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor, max_depth: float) -> torch.Tensor:
    gt_c = gt.clamp(0.0, max_depth).float()
    pred_c = pred.clamp(0.0, max_depth).float()
    mask = (gt_c > T_VALID).float()
    return _masked_per_sample((pred_c - gt_c).abs(), mask).sum()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor, max_depth: float) -> torch.Tensor:
    gt_c = gt.clamp(0.0, max_depth).float()
    pred_c = pred.clamp(0.0, max_depth).float()
    mask = (gt_c > T_VALID).float()
    return _masked_per_sample((pred_c - gt_c).square(), mask).sum()


def sig_loss(pred: torch.Tensor, gt: torch.Tensor, max_depth: Optional[float] = None,
             loss_weight: float = 2.0, eps: float = 0.001) -> torch.Tensor:
    """Scale-invariant log loss over the valid pixels: Dg = var(g) (the
    unbiased estimator) + 0.15 mean(g)^2; over the global batch's pixels
    under an active mesh."""
    pred = pred.float()
    gt = gt.float()
    mask = gt > 0
    if max_depth is not None:
        mask = mask & (gt <= max_depth)
    m = mask.float()
    g = (torch.log(pred.clamp_min(0.0) + eps) - torch.log(gt.clamp_min(0.0) + eps)) * m
    sums = all_reduce_sum(torch.stack([m.sum(), g.sum()]))
    n = sums[0] + 1e-8
    mean_g = sums[1] / n
    var_g = (all_reduce_sum((g - mean_g * m).square().sum())
             / torch.clamp_min(n - 1.0, 1.0))
    return loss_weight * torch.sqrt(var_g + 0.15 * mean_g.square())


class LossComputer:
    """Parses ``args.loss`` and computes ``(loss_sum, loss_val)``;
    ``loss_val`` is a (1, n_terms + 1) row of the weighted terms with the
    total appended."""

    def __init__(self, args):
        self.args = args
        self.terms: List[Tuple[str, float]] = []
        for item in args.loss.split("+"):
            weight, loss_type = item.split("*")
            self.terms.append((loss_type, float(weight)))
        self.loss_name = [t for t, _ in self.terms]

    def __call__(self, sample: Dict, output: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        pred = output["pred"]
        gt = sample["gt"]
        share = local_share()  # of a batch-level term: 1 with no active mesh
        vals = []
        for loss_type, weight in self.terms:
            if loss_type == "L1":
                v = l1_loss(pred, gt, self.args.max_depth)
            elif loss_type == "L2":
                v = l2_loss(pred, gt, self.args.max_depth)
            elif loss_type == "Sig":
                v = share * sig_loss(pred, gt)
            elif loss_type == "DDIM":
                v = output["ddim_loss"]
                v = torch.zeros((), device=pred.device) if v is None else share * v
            elif loss_type == "BIN":
                v = share * sum(output["bin_losses"].values())
            else:
                raise NotImplementedError(loss_type)
            vals.append(weight * v)
        loss_vec = torch.stack(vals)
        loss_sum = loss_vec.sum()
        return loss_sum, torch.cat([loss_vec, loss_sum[None]])[None]


def get_loss_names(args) -> List[str]:
    """Term names + 'Total', the layout of the ``loss_val`` row."""
    return [item.split("*")[1] for item in args.loss.split("+")] + ["Total"]


def get_loss(args):
    """Factory: a callable that builds the ``LossComputer`` of ``args``
    (NLSPN and Diffusion_DCbase_ share the masked L1/L2 machinery)."""
    return lambda a=args: LossComputer(a)
