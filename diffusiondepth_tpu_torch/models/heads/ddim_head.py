"""DDIM depth-estimation head (port of
``diffusiondepth_tpu/models/heads/ddim_head.py``).

1. (optional) HAHI neck over the backbone pyramid;
2. FPN top-down collapse into one ``fpn_dim``-channel condition map;
3. the depth transform ``t(gt)`` sizes the 16-channel latent (half
   resolution under the default transform, a quarter under the X4 one);
4. DDIM sampling: one Python loop over the steps, tables on the device and
   no host synchronisation per step;
5. ``inv_t`` decodes the latent to metric depth.

Where the denoiser's ``fused_active`` holds (the 'upsample_add' and 'add'
heads under the bf16 policy) each eval step is the fused denoiser chain
(six conv-link kernels for 'upsample_add', four for 'add') and one
DDIM-step kernel, the counterpart of the JAX eval path's grouped-flat
branch; each training step is one ``FusedSamplerStep`` on the (f32, bf16)
latent pair, the counterpart of the JAX training branch
(``fused_sampler_step``), and gradients flow back through all steps. JAX
runs 'add' on its jnp path; the port's chain is its own design there.
Elsewhere (f32, the 'upsample_concat' heads, ``use_fused_denoiser`` off, a
latent height not a multiple of 8) each step is the module denoiser and
``DDIMSchedule.step_from_alphas``, the JAX jnp path. The latent and all
scheduler math stay f32.

The ``vis`` heads also return ``pred_inter`` (steps, B, H, W, 1): every
step's latent decoded by ``inv_t`` in one batched call, with the running
BatchNorm statistics, as the JAX head decodes them.

In training mode the head also computes the self-diffusion ``ddim_loss``:
noise added to its own refined latent at a random timestep per sample,
regressed by one denoiser call.

Under an active data-parallel mesh the starting latent, the noise and the
timesteps are drawn at the global batch's shape and each rank keeps its
rows (``parallel/mesh.py::draw_rows``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ...diffusion.ddim import DDIMSchedule
from ...ops.fused_denoiser import FusedSamplerStep, ddim_step, denoiser_chain
from ...ops.resize import adaptive_avg_pool2d
from ...parallel.mesh import draw_rows
from ...registry import HEADS
from ...trace import span
from ..common import ConvBNAct, DeconvBNAct
from ..depth_transform import build_depth_transform
from .denoiser import ScheduledCNNRefine

DEFAULT_DEPTH_TRANSFORM = dict(type="DeepDepthTransformWithUpsampling", hidden=16, eps=1e-6)


class DDIMDepthEstimateHead(nn.Module):
    """The heads' shared body; each registered head sets its pyramid
    channels, denoiser fusion, HAHI neck and ``vis``. The defaults are the
    JAX head's: the ResNet pyramid and 'add'. ``depth_transform_cfg``
    names the depth transform (``DEFAULT_DEPTH_TRANSFORM`` when None); the
    head builds it with its compute dtype. ``hahi_self_att``,
    ``hahi_cross_att`` and ``hahi_num_points`` switch on the HAHI neck's
    deformable attentions (off in every shipped head, and reached only by
    building the head with them, as in JAX)."""

    in_channels: Sequence[int] = (64, 128, 256, 512)
    fuse: str = "add"
    use_hahi: bool = False
    vis: bool = False

    def __init__(self, in_channels: Optional[Sequence[int]] = None, fpn_dim: int = 256,
                 depth_feature_dim: int = 16, inference_steps: int = 20,
                 num_train_timesteps: int = 1000, hahi_embedding_dim: int = 512,
                 timestep_schedule: str = "uniform", use_fused_denoiser: bool = True,
                 depth_transform_cfg: Optional[Dict[str, Any]] = None,
                 hahi_self_att: bool = False, hahi_cross_att: bool = False,
                 hahi_num_points: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        in_channels = tuple(in_channels or self.in_channels)
        self.depth_feature_dim = depth_feature_dim
        self.inference_steps = inference_steps
        self.timestep_schedule = timestep_schedule
        self.dtype = dtype
        self.depth_transform = build_depth_transform(
            dict(depth_transform_cfg or DEFAULT_DEPTH_TRANSFORM, dtype=dtype))
        self.model = ScheduledCNNRefine(fpn_dim, depth_feature_dim, fuse=self.fuse,
                                        use_fused=use_fused_denoiser, dtype=dtype)
        self.schedule = DDIMSchedule(num_train_timesteps=num_train_timesteps,
                                     clip_sample=False)
        if self.use_hahi:
            from ..necks.hahi import HAHIHeteroNeck

            self.hahineck = HAHIHeteroNeck(in_channels, in_channels, hahi_embedding_dim,
                                           self_att=hahi_self_att, cross_att=hahi_cross_att,
                                           num_points=hahi_num_points, dtype=dtype)
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
                init_latent: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """The refined latent and, for a ``vis`` head, each step's latent."""
        with span("sampler"):
            dev = cond_latent.device
            traj = [] if self.vis else None
            fused = self.model.fused_active(latent_shape[1])
            with span("sampler.tables"):  # the tables, the time embeddings, the latent
                n = self.inference_steps
                seq = "biased" if self.timestep_schedule == "biased" else None
                timesteps = self.schedule.table_on(dev, "timesteps", n, seq)
                if init_latent is not None:
                    x = init_latent.to(device=dev, dtype=torch.float32).contiguous()
                else:
                    x = draw_rows(torch.randn, latent_shape, generator=generator, device=dev,
                                  dtype=torch.float32)
                if fused:
                    sched = self.schedule.table_on(dev, "sched", n, seq)
                    cond = cond_latent.to(torch.bfloat16).contiguous()
                    te_all = self.model.time_embed(timesteps)  # (steps, C) bf16
                else:
                    a_t = self.schedule.table_on(dev, "alpha_prod_t", n, seq)
                    a_prev = self.schedule.table_on(dev, "alpha_prod_prev", n, seq)

            if fused:  # epsilon prediction, no clipping
                b = x.shape[0]
                if self.training:  # the (f32, bf16) latent pair, differentiable
                    flat = self.model.chain_flat()
                    xb = x.to(torch.bfloat16)
                    for i in range(timesteps.shape[0]):
                        te_b = te_all[i].expand(b, te_all.shape[-1]).contiguous()
                        x, xb = FusedSamplerStep.apply(x, xb, cond, te_b, sched[i], *flat)
                        if traj is not None:
                            traj.append(x)
                    return x, traj
                params = self.model.chain_params()
                for i in range(timesteps.shape[0]):
                    with span("sampler.step"):
                        with span("sampler.denoise"):
                            te_b = te_all[i].expand(b, te_all.shape[-1]).contiguous()
                            u6, a3, b3 = denoiser_chain(params, x.to(torch.bfloat16), cond, te_b)
                        with span("sampler.update"):
                            x = ddim_step(u6, a3, b3, x, sched[i])
                    if traj is not None:
                        traj.append(x)
                return x, traj

            for i in range(timesteps.shape[0]):
                with span("sampler.step"):
                    with span("sampler.denoise"):
                        eps = self.model(x, timesteps[i], cond_latent).float()
                    with span("sampler.update"):
                        x, _ = self.schedule.step_from_alphas(eps, x, a_t[i], a_prev[i], eta=0.0,
                                                              use_clipped_model_output=True)
                if traj is not None:
                    traj.append(x)
            return x, traj

    def _ddim_loss(self, refined_latent: torch.Tensor, cond_latent: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self-diffusion noise-regression loss. ``noise`` and
        ``timesteps`` (one per sample) are drawn from ``generator`` unless
        given (the tests hand both packages the same draws)."""
        b, dev = refined_latent.shape[0], refined_latent.device
        if noise is None:
            noise = draw_rows(torch.randn, refined_latent.shape, generator=generator,
                              device=dev, dtype=refined_latent.dtype)
        if timesteps is None:
            timesteps = draw_rows(functools.partial(torch.randint, 0,
                                                    self.schedule.num_train_timesteps),
                                  (b,), generator=generator, device=dev)
        noisy = self.schedule.add_noise(refined_latent, noise, timesteps)
        noise_pred = self.model(noisy, timesteps, cond_latent)
        return torch.mean(torch.square(noise_pred.float() - noise.float()))

    def forward(self, fp: Sequence[torch.Tensor], gt_depth_map: torch.Tensor,
                init_latent: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        if gt_depth_map is None:
            raise ValueError("gt_depth_map sizes the sampling latent (reference quirk); "
                             "pass zeros at pure inference")
        with span("condition"):
            with span("condition.encode"):
                gt_map_t = self.depth_transform.t(gt_depth_map)
            if self.use_hahi:
                with span("condition.neck"):
                    fp = self.hahineck(fp, generator=generator)
            with span("condition.fpn"):
                cond = self.fpn_condition(fp)
            with span("condition.upsample"):
                cond_latent = self.model.upsample_condition(cond, gt_map_t.shape[1:3])
        latent_shape = (gt_map_t.shape[0], gt_map_t.shape[1], gt_map_t.shape[2],
                        self.depth_feature_dim)
        refined, traj = self._sample(cond_latent, latent_shape, generator, init_latent)
        with span("decode"):
            pred = self.depth_transform.inv_t(refined)
            pred_inter = None
            if traj is not None:  # every step's latent decoded in one batched call
                n, b = len(traj), traj[0].shape[0]
                flat = torch.stack(traj).flatten(0, 1)
                pred_inter = self.depth_transform.inv_t(flat, running=True)
                pred_inter = pred_inter.reshape(n, b, *pred_inter.shape[1:])
        return {
            "pred": pred,
            "pred_init": gt_map_t,
            "blur_depth_t": gt_map_t,
            "ddim_loss": (self._ddim_loss(refined, cond_latent, generator)
                          if self.training else None),
            "gt_map_t": gt_map_t,
            "pred_uncertainty": None,
            "pred_inter": pred_inter,
            "weight_map": None,
            "guidance": None,
            "offset": None,
            "aff": None,
            "gamma": None,
            "confidence": None,
        }


@HEADS.register()
class DDIMDepthEstimate_Res(DDIMDepthEstimateHead):
    """ResNet pyramid; the condition map is at latent resolution, 'add'."""


@HEADS.register()
class DDIMDepthEstimate_ResVis(DDIMDepthEstimate_Res):
    """The Res head returning every step's decoded depth."""

    vis = True


@HEADS.register()
class DDIMDepthEstimate_Swin_ADD(DDIMDepthEstimateHead):
    """Swin-L pyramid; upsample-add fusion."""

    in_channels = (192, 384, 768, 1536)
    fuse = "upsample_add"


@HEADS.register()
class DDIMDepthEstimate_Swin_ADDHAHI(DDIMDepthEstimate_Swin_ADD):
    """Swin-L + HAHI neck (conv path)."""

    use_hahi = True


@HEADS.register()
class DDIMDepthEstimate_Swin_ADDHAHIVis(DDIMDepthEstimate_Swin_ADDHAHI):
    """The Swin-L + HAHI head returning every step's decoded depth."""

    vis = True


@HEADS.register()
class DDIMDepthEstimate_MPVIT_ADDHAHI(DDIMDepthEstimateHead):
    """MPViT-small pyramid + HAHI neck (conv path); upsample-add fusion. The
    pyramid starts at 1/2 resolution, so the neck's first fusion conv and
    its FPN lateral run at the default latent's size. Its backbone records
    ``backbone.stem`` and ``backbone.stage{s}`` with their ``.embed``,
    ``.invres``, ``.mhca`` and ``.aggregate`` children (``mpvit.py``)."""

    in_channels = (128, 216, 288, 288)
    fuse = "upsample_add"
    use_hahi = True


@HEADS.register()
class DDIMDepthEstimate_Swin(DDIMDepthEstimateHead):
    """The 'bins' experiment head: Swin-L pyramid, concat fusion."""

    in_channels = (192, 384, 768, 1536)
    fuse = "upsample_concat"


@HEADS.register()
class DDIMDepthEstimate_Swin_Bins_ADDVis(DDIMDepthEstimate_Swin):
    """The bins head returning every step's decoded depth."""

    vis = True
