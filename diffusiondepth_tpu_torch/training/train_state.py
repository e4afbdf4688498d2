"""Train state: the model (parameters and BatchNorm statistics) and its
optimizer (moments and step count). The flax ``TrainState`` pytree has no
torch counterpart beyond this holder: PyTorch updates the model and the
optimizer in place."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import Config
from .optim import Optimizer, make_optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer

    @property
    def step(self) -> int:
        """Optimizer steps taken (the flax state's ``step``)."""
        return self.optimizer.count


def create_train_state(model: torch.nn.Module, cfg: Config,
                       steps_per_epoch: int) -> TrainState:
    return TrainState(model, make_optimizer(cfg, steps_per_epoch, model))
