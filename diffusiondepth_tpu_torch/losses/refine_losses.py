"""Head-level refine losses (port of
``diffusiondepth_tpu/losses/refine_losses.py``): masked L1, edge-aware
smoothness stopped at instance edges, and the 3D-box shape regulariser,
with a cfg-driven dispatch. Static shapes: masked means, no boolean
gathers.

Under an active data-parallel mesh the masked means (``l1_depth_loss``,
``shape_reg_loss``) take their numerator and denominator over the global
batch; ``depth_smooth_loss`` is a plain mean over equal-sized rows on
every rank, which the loss's share turns into the global mean."""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.geometry import convert_depth_map_to_points
from ..parallel.mesh import all_reduce_sum
from ..ops.resize import adaptive_max_pool2d, resize_bilinear, resize_nearest


def l1_depth_loss(pred_depth: torch.Tensor, gt_depth: torch.Tensor, weight: float = 1.0,
                  weight_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    assert gt_depth.shape == pred_depth.shape
    gt_mask = (gt_depth >= 1e-4).float()
    loss = (pred_depth - gt_depth).abs() * gt_mask
    if weight_map is not None:
        loss = loss * weight_map
    num, den = all_reduce_sum(torch.stack([loss.sum(), gt_mask.sum()]))
    return weight * num / den.clamp_min(1.0)


def depth_smooth_loss(pred_depth: torch.Tensor, image: torch.Tensor,
                      instance_masks: Optional[torch.Tensor] = None,
                      weight: float = 1.0) -> torch.Tensor:
    """NHWC: pred (B, H, W, 1), image (B, Hi, Wi, 3), instance_masks
    (B, Hm, Wm, 1) of integer ids; no depth gradient across an instance
    edge."""
    h, w = pred_depth.shape[1:3]
    img = resize_bilinear(image, (h, w))
    pred = pred_depth[..., 0]
    if instance_masks is not None:
        m = instance_masks.float().permute(0, 3, 1, 2)
        max_id = F.max_pool2d(m, 3, 1, 1)
        min_id = -F.max_pool2d(-m, 3, 1, 1)
        edge = (max_id != min_id).float().permute(0, 2, 3, 1)
        edge = adaptive_max_pool2d(edge, (h, w))[..., 0]
        pred = pred * (1.0 - edge) + pred.detach() * edge
    gdx = (pred[:, :, :-1] - pred[:, :, 1:]).abs()
    gdy = (pred[:, :-1, :] - pred[:, 1:, :]).abs()
    gix = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(-1)
    giy = (img[:, :-1, :] - img[:, 1:, :]).abs().mean(-1)
    return weight * ((gdx * torch.exp(-gix)).mean() + (gdy * torch.exp(-giy)).mean())


def shape_reg_loss(pred_depth: torch.Tensor, foreground_masks: torch.Tensor,
                   gt_boxes: torch.Tensor, box_valid: torch.Tensor, rots: torch.Tensor,
                   trans: torch.Tensor, intrins: torch.Tensor, post_rots: torch.Tensor,
                   post_trans: torch.Tensor, input_size: Tuple[int, int], downsample: int,
                   weight: float = 1.0) -> torch.Tensor:
    """Back-project the foreground pixels, rotate them into each ground-
    truth box's frame and penalise the smallest (over the boxes) mean ReLU
    excess outside the box's extents. pred_depth (B, H, W, 1); gt_boxes
    (B, M, 7) [cx cy cz dx dy dz yaw], padded to M with ``box_valid``."""
    b, h, w, _ = pred_depth.shape
    depth = pred_depth[..., 0].reshape(b, 1, 1, h, w)
    xyz = convert_depth_map_to_points(depth, input_size, downsample, rots, trans, intrins,
                                      post_rots, post_trans).reshape(b, h * w, 3)
    fg = resize_nearest(foreground_masks.float(), (h, w))
    fg = (fg[..., 0] > 0.5).float().reshape(b, h * w)
    yaw = gt_boxes[..., 6]
    cos_t, sin_t = torch.cos(yaw), torch.sin(yaw)
    zeros, ones = torch.zeros_like(cos_t), torch.ones_like(cos_t)
    rot = torch.stack([cos_t, -sin_t, zeros, sin_t, cos_t, zeros, zeros, zeros, ones],
                      dim=-1).reshape(*yaw.shape, 3, 3)
    centers = torch.cat([gt_boxes[..., :2], gt_boxes[..., 2:3] + gt_boxes[..., 5:6] / 2.0], -1)
    sizes = gt_boxes[..., 3:6]
    rel = xyz[:, :, None, :] - centers[:, None, :, :]
    rel = torch.einsum("bpmi,bmji->bpmj", rel, rot)
    excess = F.relu(rel.abs() - sizes[:, None]).mean(-1)
    excess = torch.where(box_valid[:, None, :], excess, torch.full_like(excess, float("inf")))
    per_pt = excess.min(dim=-1).values
    per_pt = torch.where(torch.isfinite(per_pt), per_pt, torch.zeros_like(per_pt))
    num, den = all_reduce_sum(torch.stack([(per_pt * fg).sum(), fg.sum()]))
    return weight * num / den.clamp_min(1.0)


depth_loss_dict: Dict[str, object] = {
    "l1_depth_loss": l1_depth_loss,
    "depth_smooth_loss": depth_smooth_loss,
    "shape_reg_loss": shape_reg_loss,
}


def compute_refine_losses(loss_cfgs, pred_depth, gt_depth, **kwargs):
    """Each cfg is ``{'loss_func': name, 'name': key, 'weight': w, ...}``;
    a loss_func not in ``depth_loss_dict`` is skipped. A function gets the
    keyword arguments (and cfg entries) it takes."""
    loss_dict = {}
    for cfg in loss_cfgs:
        fn = depth_loss_dict.get(cfg.get("loss_func"))
        if fn is None:
            continue
        params = inspect.signature(fn).parameters
        extra = {k: v for k, v in cfg.items() if k not in ("loss_func", "name")}
        call_kwargs = {k: v for k, v in dict(kwargs, **extra).items() if k in params}
        if "gt_depth" in params:
            call_kwargs["gt_depth"] = gt_depth
        loss_dict[cfg["name"]] = fn(pred_depth=pred_depth, **call_kwargs)
    return loss_dict
