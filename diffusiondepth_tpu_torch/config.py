"""Configuration of the port's eval and training paths.

A copy of the fields of ``diffusiondepth_tpu.config.Config`` that the
serving and training paths read, with the same names and defaults, so that
one set of flags describes a model and its training in both packages. The
port keeps its own copy: it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch


@dataclass
class Config:
    patch_height: int = 228
    patch_width: int = 304

    seed: int = 7240

    model_name: str = "NLSPN"
    backbone_module: str = "mmbev_resnet"
    backbone_name: str = "mmbev_res18"
    head_specify: Optional[str] = None

    inference_steps: int = 20
    num_train_timesteps: int = 1000
    # 'uniform' (scheduling_ddim) | 'biased' (scheduling_ddim_si SI table)
    timestep_schedule: str = "uniform"

    # ---- training ----
    loss: str = "1.0*L1+1.0*L2+1.0*DDIM"
    opt_level: str = "O0"  # O0 = float32; O1/O2/O3 = bfloat16 compute
    batch_size: int = 12
    max_depth: float = 88.0

    # ---- optimizer ----
    lr: float = 0.001
    decay: str = "10,15,20"
    gamma: str = "1.0,0.2,0.04"
    optimizer: str = "ADAM"
    momentum: float = 0.9
    betas: Tuple[float, float] = (0.9, 0.999)
    epsilon: float = 1e-8
    weight_decay: float = 0.0
    warm_up: bool = True
    split_backbone_training: bool = False

    dtype: Optional[str] = None  # compute dtype override: float32|bfloat16
    # gradient accumulation: micro-batches per optimizer step
    accum_steps: int = 1
    # comma-separated pyramid channels overriding the head's spec
    head_in_channels: Optional[str] = None
    tta_flip: bool = False  # flip-ensemble TTA (leaderboard protocol)
    # Swin window attention: use_pallas runs the split q/k/v kernel (K8) at
    # eval and the einsum path in training; fused_window_attention=False
    # takes the einsum path everywhere; otherwise WindowAttentionQKV (K4/K7)
    use_pallas: bool = False
    fused_window_attention: bool = True
    # rematerialise each Swin block in the training backward
    remat_backbone: bool = True
    # the denoiser takes the fused conv chain (K1/K5) where its guard holds
    # ('upsample_add', bf16, latent height % 8 == 0)
    fused_denoiser: bool = True

    def finalize(self) -> "Config":
        if self.dtype is None:
            self.dtype = "float32" if self.opt_level == "O0" else "bfloat16"
        return self

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.dtype or "float32"]


def convert_str_to_num(val: str, t: str) -> List:
    """'10,15,20' -> [10, 15, 20] (``t`` is 'int' or 'float')."""
    cast = {"int": int, "float": float}[t]
    return [cast(v) for v in val.replace("'", "").replace('"', "").split(",")]
