"""Optimizers and the learning-rate schedule (port of
``diffusiondepth_tpu/training/optim.py``, which builds them in optax).

* SGD (momentum trace), Adam (bias-corrected moments, eps outside the
  square root) and RMSprop (decay 0.9, eps inside the square root, no bias
  correction), each with weight decay added to the gradient (the torch
  convention, not decoupled AdamW); the update arithmetic is optax's.
* The ``LRFactor`` table: during (1-based) epoch e the factor is the first
  ``gamma[i]`` with ``e - 1 < decay[i]``.
* Linear warm-up over epoch 1: lr = base * (step + 1) / (steps_per_epoch + 1).
* ``split_backbone_training``: ``depth_backbone.*`` parameters at 0.1x lr.

The schedule is read at the optimizer's own step count before it is
incremented, as optax's ``scale_by_learning_rate`` does. Every update is
elementwise, so under tensor parallelism (``parallel/tensor.py``) it runs
on a parameter's shard, with moments of the shard's shape.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List

import torch

from ..config import Config, convert_str_to_num


def lr_factor(epoch_0based: int, decay: List[int], gamma: List[float]) -> float:
    for d, g in zip(decay, gamma):
        if epoch_0based < d:
            return g
    return gamma[-1]


def make_lr_schedule(cfg: Config, steps_per_epoch: int) -> Callable[[int], float]:
    """Global step (0-based) -> lr."""
    decay = convert_str_to_num(cfg.decay, "int")
    gamma = convert_str_to_num(cfg.gamma, "float")
    if len(decay) != len(gamma):
        raise ValueError("decay and gamma must have the same length")

    def schedule(count: int) -> float:
        epoch_1based = count // steps_per_epoch + 1
        if cfg.warm_up and epoch_1based == 1:
            return cfg.lr * (count % steps_per_epoch + 1.0) / (steps_per_epoch + 1.0)
        return cfg.lr * lr_factor(epoch_1based - 1, decay, gamma)

    return schedule


class Optimizer(torch.optim.Optimizer):
    """One of SGD / ADAM / RMSprop with optax's update rules; each group
    carries an ``lr_scale`` on the shared schedule."""

    def __init__(self, groups: Iterable[Dict], cfg: Config, schedule: Callable[[int], float]):
        if cfg.optimizer not in ("SGD", "ADAM", "RMSprop"):
            raise NotImplementedError(cfg.optimizer)
        super().__init__(list(groups), dict(lr_scale=1.0))
        self.kind = cfg.optimizer
        self.cfg = cfg
        self.schedule = schedule
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        cfg = self.cfg
        lr = self.schedule(self.count)
        t = self.count + 1
        b1, b2 = cfg.betas
        for group in self.param_groups:
            scale = -lr * group["lr_scale"]
            for p in group["params"]:
                # a parameter the loss does not reach has a zero gradient in
                # JAX, and weight decay and momentum still apply to it
                g = torch.zeros_like(p) if p.grad is None else p.grad.float()
                if cfg.weight_decay:
                    g = g + cfg.weight_decay * p
                st = self.state[p]
                if self.kind == "SGD":
                    tr = st.get("trace")
                    u = g if tr is None else g + cfg.momentum * tr
                    st["trace"] = u
                elif self.kind == "ADAM":
                    if not st:
                        st["mu"] = torch.zeros_like(p, dtype=torch.float32)
                        st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                    mu = (1 - b1) * g + b1 * st["mu"]
                    nu = (1 - b2) * g.square() + b2 * st["nu"]
                    st["mu"], st["nu"] = mu, nu
                    mu_hat = mu / (1 - b1 ** t)
                    nu_hat = nu / (1 - b2 ** t)
                    u = mu_hat / (torch.sqrt(nu_hat) + cfg.epsilon)
                else:
                    nu = (1 - 0.9) * g.square() + 0.9 * st.get("nu", torch.zeros_like(g))
                    st["nu"] = nu
                    u = g * torch.rsqrt(nu + cfg.epsilon)
                p.add_(scale * u)
        self.count += 1


def make_optimizer(cfg: Config, steps_per_epoch: int, model: torch.nn.Module) -> Optimizer:
    """The optimizer over ``model``'s parameters. With
    ``cfg.split_backbone_training`` the ``depth_backbone.*`` parameters
    train at 0.1x the scheduled lr."""
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    named = list(model.named_parameters())
    if not cfg.split_backbone_training:
        return Optimizer([{"params": [p for _, p in named]}], cfg, schedule)
    bb = [p for n, p in named if n.startswith("depth_backbone.")]
    rest = [p for n, p in named if not n.startswith("depth_backbone.")]
    return Optimizer([{"params": rest}, {"params": bb, "lr_scale": 0.1}], cfg, schedule)
