from .losses import LossComputer, get_loss, get_loss_names, l1_loss, l2_loss, sig_loss

__all__ = ["LossComputer", "get_loss", "get_loss_names", "l1_loss", "l2_loss", "sig_loss"]
