"""DDIM depth-estimation head, eval path (port of
``diffusiondepth_tpu/models/heads/ddim_head.py``).

1. (optional) HAHI neck over the backbone pyramid;
2. FPN top-down collapse into one ``fpn_dim``-channel condition map;
3. the depth transform ``t(gt)`` sizes the 16-channel half-resolution latent;
4. DDIM sampling: one Python loop over the steps, tables on the device and
   no host synchronisation per step;
5. ``inv_t`` decodes the latent to metric depth.

Under the bf16 policy each step is the fused denoiser chain (six
conv-link kernels) and one DDIM-step kernel, the counterpart of the JAX
eval path's grouped-flat branch. In f32 each step is the module denoiser
and ``DDIMSchedule.step_from_alphas``, the JAX jnp path. The latent and
all scheduler math stay f32.

The self-diffusion ``ddim_loss`` is a training term and is not computed at
eval (training is the next slice).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from ...diffusion.ddim import DDIMSchedule
from ...ops.fused_denoiser import ddim_step, denoiser_chain
from ...ops.resize import adaptive_avg_pool2d
from ...registry import HEADS
from ..common import ConvBNAct, DeconvBNAct
from ..depth_transform import DeepDepthTransformWithUpsampling
from .denoiser import ScheduledCNNRefine


class DDIMDepthEstimateHead(nn.Module):
    """The Swin heads' shared body: Swin-L pyramid channels by default,
    'upsample_add' denoiser fusion, ``DeepDepthTransformWithUpsampling``."""

    use_hahi: bool = False

    def __init__(self, in_channels: Optional[Sequence[int]] = None, fpn_dim: int = 256,
                 depth_feature_dim: int = 16, inference_steps: int = 20,
                 num_train_timesteps: int = 1000, hahi_embedding_dim: int = 512,
                 timestep_schedule: str = "uniform", dtype: Optional[torch.dtype] = None):
        super().__init__()
        in_channels = tuple(in_channels or (192, 384, 768, 1536))
        self.depth_feature_dim = depth_feature_dim
        self.inference_steps = inference_steps
        self.timestep_schedule = timestep_schedule
        self.dtype = dtype
        self.depth_transform = DeepDepthTransformWithUpsampling(
            hidden=depth_feature_dim, eps=1e-6, dtype=dtype)
        self.model = ScheduledCNNRefine(fpn_dim, depth_feature_dim, dtype=dtype)
        self.schedule = DDIMSchedule(num_train_timesteps=num_train_timesteps,
                                     clip_sample=False)
        if self.use_hahi:
            from ..necks.hahi import HAHIHeteroNeck

            self.hahineck = HAHIHeteroNeck(in_channels, in_channels,
                                           hahi_embedding_dim, dtype=dtype)
        self.conv_lateral = nn.ModuleList([
            ConvBNAct(c, fpn_dim, 3, 1, 1, act="relu", dtype=dtype) for c in in_channels])
        self.conv_up = nn.ModuleList([
            DeconvBNAct(fpn_dim, fpn_dim, dtype=dtype) for _ in range(len(in_channels) - 1)])

    def fpn_condition(self, fp: Sequence[torch.Tensor]) -> torch.Tensor:
        n = len(fp)
        x = None
        for i in range(n):
            j = n - i - 1
            lat = self.conv_lateral[j](fp[j])
            if i > 0:
                up = self.conv_up[j](x)
                lat = lat + adaptive_avg_pool2d(up, (lat.shape[1], lat.shape[2]))
            x = lat
        return x

    def _sample(self, cond_latent: torch.Tensor, latent_shape,
                generator: Optional[torch.Generator] = None,
                init_latent: Optional[torch.Tensor] = None) -> torch.Tensor:
        dev = cond_latent.device
        ts = (self.schedule.biased_timesteps(self.inference_steps)
              if self.timestep_schedule == "biased" else None)
        tables = self.schedule.inference_tables(self.inference_steps, ts)
        timesteps = torch.from_numpy(tables.timesteps).to(dev)
        if init_latent is not None:
            x = init_latent.to(device=dev, dtype=torch.float32).contiguous()
        else:
            x = torch.randn(latent_shape, generator=generator, device=dev,
                            dtype=torch.float32)

        if self.model.fused_active():  # epsilon prediction, no clipping
            sched = torch.from_numpy(tables.sched()).to(dev)
            params = self.model.chain_params()
            cond = cond_latent.to(torch.bfloat16).contiguous()
            te_all = self.model.time_embed(timesteps)  # (steps, C) bf16
            b = x.shape[0]
            for i in range(len(tables.timesteps)):
                te_b = te_all[i].expand(b, te_all.shape[-1]).contiguous()
                u6, a3, b3 = denoiser_chain(params, x.to(torch.bfloat16), cond, te_b)
                x = ddim_step(u6, a3, b3, x, sched[i])
            return x

        a_t = torch.from_numpy(tables.alpha_prod_t).to(dev)
        a_prev = torch.from_numpy(tables.alpha_prod_prev).to(dev)
        for i in range(len(tables.timesteps)):
            eps = self.model(x, timesteps[i], cond_latent).float()
            x, _ = self.schedule.step_from_alphas(eps, x, a_t[i], a_prev[i], eta=0.0,
                                                  use_clipped_model_output=True)
        return x

    def forward(self, fp: Sequence[torch.Tensor], gt_depth_map: torch.Tensor,
                init_latent: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        if gt_depth_map is None:
            raise ValueError("gt_depth_map sizes the sampling latent (reference quirk); "
                             "pass zeros at pure inference")
        gt_map_t = self.depth_transform.t(gt_depth_map)
        if self.use_hahi:
            fp = self.hahineck(fp)
        cond = self.fpn_condition(fp)
        cond_latent = self.model.upsample_condition(cond, gt_map_t.shape[1:3])
        latent_shape = (gt_map_t.shape[0], gt_map_t.shape[1], gt_map_t.shape[2],
                        self.depth_feature_dim)
        refined = self._sample(cond_latent, latent_shape, generator, init_latent)
        return {
            "pred": self.depth_transform.inv_t(refined),
            "pred_init": gt_map_t,
            "blur_depth_t": gt_map_t,
            "ddim_loss": None,
            "gt_map_t": gt_map_t,
            "pred_uncertainty": None,
            "pred_inter": None,
            "weight_map": None,
            "guidance": None,
            "offset": None,
            "aff": None,
            "gamma": None,
            "confidence": None,
        }


@HEADS.register()
class DDIMDepthEstimate_Swin_ADD(DDIMDepthEstimateHead):
    """Swin-L pyramid; upsample-add fusion."""


@HEADS.register()
class DDIMDepthEstimate_Swin_ADDHAHI(DDIMDepthEstimate_Swin_ADD):
    """Swin-L + HAHI neck (conv path)."""

    use_hahi = True
