"""Composed DiffusionDepth model, backbone + DDIM head (port of
``diffusiondepth_tpu/models/diffusion_model.py`` for ``Diffusion_DCbase_``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..device import resolve_device
from ..registry import BACKBONES, HEADS
from .backbones import swin  # noqa: F401  (registers the Swin backbones)
from .heads import ddim_head  # noqa: F401  (registers the heads)

_DEFAULT_HEAD = {"swin": "DDIMDepthEstimate_Swin_ADDHAHI"}


class Diffusion_DCbase_Model(nn.Module):
    def __init__(self, backbone_name: str,
                 head_name: str = "DDIMDepthEstimate_Swin_ADDHAHI",
                 inference_steps: int = 20, num_train_timesteps: int = 1000,
                 timestep_schedule: str = "uniform",
                 head_in_channels: Optional[Sequence[int]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.depth_backbone = BACKBONES.get(backbone_name)(dtype=dtype)
        self.depth_head = HEADS.get(head_name)(
            in_channels=head_in_channels, inference_steps=inference_steps,
            num_train_timesteps=num_train_timesteps,
            timestep_schedule=timestep_schedule, dtype=dtype)

    def forward(self, sample: Dict[str, torch.Tensor],
                init_latent: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """sample keys (NHWC): rgb (B, H, W, 3), gt (B, H, W, 1); the other
        keys of the reference contract (dep, depth_map, depth_mask) are not
        read by this model."""
        if self.training:
            raise NotImplementedError(
                "the port runs the eval path only; training is the next slice "
                "(ROADMAP Queue 1, M10)")
        fp = self.depth_backbone(sample["rgb"])
        return self.depth_head(fp, gt_depth_map=sample.get("gt"),
                               init_latent=init_latent, generator=generator)


def build_model(cfg, device: Union[str, torch.device, None] = None) -> Diffusion_DCbase_Model:
    """The model of ``cfg`` with weights drawn from ``cfg.seed``, on the
    card unless ``device="cpu"``; in eval mode."""
    dev = resolve_device(device)
    if cfg.model_name != "Diffusion_DCbase_":
        raise NotImplementedError(
            f"model_name {cfg.model_name!r} is not ported yet (ROADMAP Queue 1)")
    if cfg.backbone_module not in _DEFAULT_HEAD:
        raise NotImplementedError(
            f"backbone_module {cfg.backbone_module!r} is not ported yet (ROADMAP Queue 1)")
    head = cfg.head_specify or _DEFAULT_HEAD[cfg.backbone_module]
    hic = cfg.head_in_channels
    if isinstance(hic, str):
        hic = tuple(int(c) for c in hic.split(","))
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(cfg.seed)
        model = Diffusion_DCbase_Model(
            backbone_name=cfg.backbone_name,
            head_name=head,
            inference_steps=cfg.inference_steps,
            num_train_timesteps=cfg.num_train_timesteps,
            timestep_schedule=cfg.timestep_schedule,
            head_in_channels=hic,
            dtype=cfg.compute_dtype if cfg.dtype == "bfloat16" else None,
        )
    return model.eval()
