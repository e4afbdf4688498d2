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

import importlib

# name -> module; each is imported at first use, so that importing one
# module of the package (the serving tool imports the operators, the PNG
# codec and the checkpoint reader) does not build the model code
_EXPORTS = {
    "Config": ".config",
    "LossComputer": ".losses",
    "build_model": ".models.diffusion_model",
    "LAUNCHES": ".ops.native",
    "reset_launch_counts": ".ops.native",
    "make_optimizer": ".training.optim",
    "make_eval_step": ".training.steps",
    "make_train_step": ".training.steps",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
