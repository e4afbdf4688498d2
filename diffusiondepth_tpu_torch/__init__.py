"""PyTorch/CUDA port of diffusiondepth_tpu for NVIDIA Hopper.

The eval and training paths of the flagship configuration (Swin-L + HAHI
+ DDIM head): ``build_model(cfg)`` -> ``make_eval_step(model)`` ->
``eval_step(batch)``, and ``build_model(cfg)`` -> ``make_train_step(model,
LossComputer(cfg), make_optimizer(cfg, steps_per_epoch, model),
accum_steps)`` -> ``train_step(batch, generator)``.
Entry points run on the card unless the caller passes ``device="cpu"``;
there every kernel wrapper runs its plain PyTorch version. The port imports
nothing of the JAX package.
"""

from .config import Config
from .losses import LossComputer
from .models.diffusion_model import build_model
from .ops.native import LAUNCHES, reset_launch_counts
from .training.optim import make_optimizer
from .training.steps import make_eval_step, make_train_step

__all__ = ["Config", "build_model", "make_eval_step", "make_train_step", "make_optimizer",
           "LossComputer", "LAUNCHES", "reset_launch_counts"]
