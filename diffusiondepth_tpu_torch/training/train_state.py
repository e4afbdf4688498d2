"""Train state: the model (parameters and BatchNorm statistics) and its
optimizer (moments and step count). The flax ``TrainState`` pytree has no
torch counterpart beyond this holder: PyTorch updates the model and the
optimizer in place."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch

from ..config import Config
from .optim import Optimizer, make_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    # steps taken before the optimizer's own count began: a checkpoint
    # restored without its optimizer state keeps its step, as in JAX, while
    # the optimizer (and its schedule) starts afresh
    step_offset: int = 0
    # seconds by phase, filled by main's loops (main.py)
    timings: Dict[str, List[float]] = field(default_factory=dict)

    @property
    def step(self) -> int:
        """Optimizer steps taken (the flax state's ``step``)."""
        return self.step_offset + self.optimizer.count


def create_train_state(model: torch.nn.Module, cfg: Config,
                       steps_per_epoch: int) -> TrainState:
    return TrainState(model, make_optimizer(cfg, steps_per_epoch, model))
