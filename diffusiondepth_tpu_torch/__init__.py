"""PyTorch/CUDA port of diffusiondepth_tpu for NVIDIA Hopper.

The eval path of the flagship configuration (Swin-L + HAHI + DDIM head):
``build_model(cfg)`` -> ``make_eval_step(model)`` -> ``eval_step(batch)``.
Entry points run on the card unless the caller passes ``device="cpu"``;
there every kernel wrapper runs its plain PyTorch version. The port imports
nothing of the JAX package.
"""

from .config import Config
from .models.diffusion_model import build_model
from .ops.native import LAUNCHES, reset_launch_counts
from .training.steps import make_eval_step

__all__ = ["Config", "build_model", "make_eval_step", "LAUNCHES", "reset_launch_counts"]
