"""Configuration of the port's eval path.

A copy of the fields of ``diffusiondepth_tpu.config.Config`` that the
serving path reads, with the same names and defaults, so that one set of
flags describes a model in both packages. The port keeps its own copy: it
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Config:
    seed: int = 7240

    model_name: str = "NLSPN"
    backbone_module: str = "mmbev_resnet"
    backbone_name: str = "mmbev_res18"
    head_specify: Optional[str] = None

    inference_steps: int = 20
    num_train_timesteps: int = 1000
    # 'uniform' (scheduling_ddim) | 'biased' (scheduling_ddim_si SI table)
    timestep_schedule: str = "uniform"

    opt_level: str = "O0"  # O0 = float32; O1/O2/O3 = bfloat16 compute
    dtype: Optional[str] = None  # compute dtype override: float32|bfloat16
    # comma-separated pyramid channels overriding the head's spec
    head_in_channels: Optional[str] = None

    def finalize(self) -> "Config":
        if self.dtype is None:
            self.dtype = "float32" if self.opt_level == "O0" else "bfloat16"
        return self

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.dtype or "float32"]
