from .chamfer import bins_chamfer_loss
from .losses import LossComputer, get_loss, get_loss_names, l1_loss, l2_loss, sig_loss
from .refine_losses import (
    compute_refine_losses, depth_loss_dict, depth_smooth_loss, l1_depth_loss, shape_reg_loss,
)

__all__ = [
    "LossComputer",
    "get_loss",
    "get_loss_names",
    "l1_loss",
    "l2_loss",
    "sig_loss",
    "bins_chamfer_loss",
    "compute_refine_losses",
    "depth_loss_dict",
    "depth_smooth_loss",
    "l1_depth_loss",
    "shape_reg_loss",
]
