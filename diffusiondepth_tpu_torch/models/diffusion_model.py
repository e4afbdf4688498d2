"""Composed DiffusionDepth model, backbone + DDIM head, and the model
factory (port of ``diffusiondepth_tpu/models/diffusion_model.py`` for
``Diffusion_DCbase_``, ``Diffusion_DCx4base_`` and ``NLSPN``).
``Diffusion_DCx4base_`` is the same composition with the X4 depth
transform: a quarter-resolution latent.

Three backbone families are ported: ``mmbev_resnet`` (``mmbev_res18/50/101``,
default head ``DDIMDepthEstimate_Res``), ``swin`` (every Swin name, default
``DDIMDepthEstimate_Swin_ADDHAHI``) and ``mpvit`` (``mpvit_tiny`` ..
``mpvit_base``, default ``DDIMDepthEstimate_MPVIT_ADDHAHI``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..device import resolve_device
from ..registry import BACKBONES, HEADS
from ..trace import span
from .backbones import mmbev_resnet, mpvit, swin  # noqa: F401  (register the backbones)
from .heads import ddim_head  # noqa: F401  (registers the heads)
from .nlspn import NLSPNModel

# the depth transform of Diffusion_DCx4base_
X4_DEPTH_TRANSFORM = dict(type="DeepDepthTransformWithUpsamplingX4", hidden=16, eps=1e-6)
# the default head of each backbone module when head_specify is not given
_DEFAULT_HEAD = {
    "mmbev_resnet": "DDIMDepthEstimate_Res",
    "swin": "DDIMDepthEstimate_Swin_ADDHAHI",
    "mpvit": "DDIMDepthEstimate_MPVIT_ADDHAHI",
}


class Diffusion_DCbase_Model(nn.Module):
    def __init__(self, backbone_name: str = "mmbev_res18",
                 backbone_module: str = "mmbev_resnet",
                 head_name: str = "DDIMDepthEstimate_Res",
                 inference_steps: int = 20, num_train_timesteps: int = 1000,
                 timestep_schedule: str = "uniform",
                 head_in_channels: Optional[Sequence[int]] = None,
                 use_pallas: bool = False, fused_window_attention: bool = True,
                 remat_backbone: bool = True, use_fused_denoiser: bool = True,
                 depth_transform_cfg: Optional[Dict[str, Any]] = None,
                 dtype: Optional[torch.dtype] = None):
        """The backbone is ``backbone_name``'s (a ``KeyError`` names an
        unknown one); ``backbone_module`` only says whether it is a Swin,
        which alone takes ``use_pallas``, ``fused_window_attention`` and
        ``remat_backbone``, as in JAX. ``depth_transform_cfg`` goes to the
        head (None: its default)."""
        super().__init__()
        bb_kwargs = {}
        if backbone_module == "swin":
            bb_kwargs = dict(use_pallas=use_pallas, remat=remat_backbone,
                             fused_qkv_attention=fused_window_attention)
        self.depth_backbone = BACKBONES.get(backbone_name)(dtype=dtype, **bb_kwargs)
        self.depth_head = HEADS.get(head_name)(
            in_channels=head_in_channels, inference_steps=inference_steps,
            num_train_timesteps=num_train_timesteps,
            timestep_schedule=timestep_schedule, use_fused_denoiser=use_fused_denoiser,
            depth_transform_cfg=depth_transform_cfg, dtype=dtype)

    def forward(self, sample: Dict[str, torch.Tensor],
                init_latent: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """sample keys (NHWC): rgb (B, H, W, 3), gt (B, H, W, 1); the other
        keys of the reference contract (dep, depth_map, depth_mask) are not
        read by this model. In training mode (``model.train()``) BatchNorm
        uses batch statistics, the backbone draws its drop-path masks and
        the head its ddim_loss draws from ``generator``, and the output
        holds ``ddim_loss``."""
        with span("backbone"):
            fp = self.depth_backbone(sample["rgb"], generator=generator)
        return self.depth_head(fp, gt_depth_map=sample.get("gt"),
                               init_latent=init_latent, generator=generator)


def construct_model(cfg) -> nn.Module:
    """The model of ``cfg`` as ``build_model`` makes it, with weights drawn
    from the global generator on the current default device; build_model
    seeds it. ``Diffusion_DCbase_``:
    ``cfg.use_pallas``, ``cfg.fused_window_attention`` and
    ``cfg.remat_backbone`` choose the Swin backbone's attention route and
    block rematerialisation; ``cfg.fused_denoiser`` lets the denoiser take
    the fused chain where its guard holds. ``Diffusion_DCx4base_``: the
    same with the X4 depth transform. ``NLSPN``: ``NLSPNModel`` with
    ``cfg.network``, the affinity options and ``cfg.prop_stencil_radius``.
    ``--opt_level`` O1-O3 compute in bf16. Raises as JAX's ``build_model``
    does: ``ValueError`` for another ``model_name``, ``KeyError`` for a
    ``backbone_module`` without a default head when ``head_specify`` is
    not given, and for an unknown backbone or head name."""
    dtype = cfg.compute_dtype if cfg.dtype == "bfloat16" else None
    if cfg.model_name == "NLSPN":
        return NLSPNModel(cfg, dtype=dtype)
    if cfg.model_name not in ("Diffusion_DCbase_", "Diffusion_DCx4base_"):
        raise ValueError(f"unknown model_name {cfg.model_name!r}")
    head = cfg.head_specify or _DEFAULT_HEAD[cfg.backbone_module]
    hic = cfg.head_in_channels
    if isinstance(hic, str):
        hic = tuple(int(c) for c in hic.split(","))
    return Diffusion_DCbase_Model(
        backbone_name=cfg.backbone_name,
        backbone_module=cfg.backbone_module,
        head_name=head,
        inference_steps=cfg.inference_steps,
        num_train_timesteps=cfg.num_train_timesteps,
        timestep_schedule=cfg.timestep_schedule,
        head_in_channels=hic,
        use_pallas=cfg.use_pallas and cfg.backbone_module == "swin",
        fused_window_attention=cfg.fused_window_attention,
        remat_backbone=cfg.remat_backbone,
        use_fused_denoiser=cfg.fused_denoiser,
        depth_transform_cfg=(X4_DEPTH_TRANSFORM if cfg.model_name == "Diffusion_DCx4base_"
                             else None),
        dtype=dtype,
    )


def build_model(cfg, device: Union[str, torch.device, None] = None) -> nn.Module:
    """The model of ``cfg`` (``construct_model``) with weights drawn from
    ``cfg.seed``, on the card unless ``device="cpu"``; in eval mode."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []), dev:
        torch.manual_seed(cfg.seed)
        model = construct_model(cfg)
    return model.eval()
