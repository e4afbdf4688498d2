"""The conditional denoiser ``ScheduledCNNRefine`` (port of
``diffusiondepth_tpu/models/heads/denoiser.py``).

noise embedding conv(16->64) GN(4) ReLU conv(64->C) GN(4) ReLU; timestep
embedding table Embed(1280, C); 'upsample_add' fusion by two plain 3x3
convs; predictor conv(C->64) GN(4) ReLU conv(64->16) GN(4) ReLU. The
condition map comes in already at latent resolution (``upsample_condition``
runs once, outside the sampling loop).

Under the bf16 policy the six convs run as the fused chain of
``ops/fused_denoiser.py`` (kernel K1 on the card), as the JAX package's
fused Pallas chain does; in f32 the module path below runs, which is the
JAX package's jnp path. Only the 'upsample_add' fusion of the Swin heads
is ported ('add' and 'upsample_concat' wait, ROADMAP M4).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fused_denoiser import denoiser_chain, finish_eps
from ...ops.resize import resize_bilinear
from ..common import conv2d_nhwc, group_norm_nhwc


def _conv_gn_block(cin: int, mid: int, cout: int) -> nn.Sequential:
    """Reference layout Sequential(conv, GN, ReLU, conv, GN, ReLU)."""
    return nn.Sequential(
        nn.Conv2d(cin, mid, 3, 1, 1), nn.GroupNorm(4, mid), nn.ReLU(),
        nn.Conv2d(mid, cout, 3, 1, 1), nn.GroupNorm(4, cout), nn.ReLU())


class _Conv(nn.Module):
    """Holds a conv under the reference name ``conv``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)


class ScheduledCNNRefine(nn.Module):
    def __init__(self, channels_in: int = 256, channels_noise: int = 16,
                 num_timestep_embeds: int = 1280, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.noise_embedding = _conv_gn_block(channels_noise, 64, channels_in)
        self.time_embedding = nn.Embedding(num_timestep_embeds, channels_in)
        self.upsample_add = nn.Module()
        self.upsample_add.convA = _Conv(channels_in)
        self.upsample_add.convB = _Conv(channels_in)
        self.pred = _conv_gn_block(channels_in, 64, channels_noise)

    def fused_active(self) -> bool:
        """True when the denoiser runs as the fused conv chain (bf16)."""
        return self.dtype == torch.bfloat16

    @staticmethod
    def upsample_condition(cond: torch.Tensor, latent_hw) -> torch.Tensor:
        """Bring the condition map to latent resolution once (align_corners)."""
        return resize_bilinear(cond, tuple(latent_hw), align_corners=True)

    def time_embed(self, t) -> torch.Tensor:
        w = self.time_embedding.weight
        te = w[torch.as_tensor(t, device=w.device)]
        return te.to(self.dtype) if self.dtype is not None else te

    def chain_params(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Weights of the six links as ``denoiser_chain`` takes them:
        conv (3, 3, Cin, Cout) bf16 + f32 bias, GroupNorm f32 (scale, bias).
        Made once per sampling call, outside the step loop."""
        def conv(c):
            return (c.weight.detach().permute(2, 3, 1, 0).contiguous().to(torch.bfloat16),
                    c.bias.detach().float().contiguous())

        def gn(g):
            return g.weight.detach().float(), g.bias.detach().float()

        ne, pr = self.noise_embedding, self.pred
        return {
            "ne0": conv(ne[0]), "gn0": gn(ne[1]), "ne1": conv(ne[3]), "gn1": gn(ne[4]),
            "fa": conv(self.upsample_add.convA.conv), "fb": conv(self.upsample_add.convB.conv),
            "pr0": conv(pr[0]), "gn2": gn(pr[1]), "pr1": conv(pr[3]), "gn3": gn(pr[4]),
        }

    def _block(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for conv, gn in ((seq[0], seq[1]), (seq[3], seq[4])):
            x = conv2d_nhwc(x, conv.weight, conv.bias, 1, 1, self.dtype)
            x = F.relu(group_norm_nhwc(x, gn.weight, gn.bias, 4, self.dtype))
        return x

    def forward(self, noisy_latent: torch.Tensor, t, cond_latent: torch.Tensor) -> torch.Tensor:
        """Predict noise. noisy_latent (B, h, w, 16); t a scalar timestep
        (int or 0-d tensor) or (B,); cond_latent (B, h, w, C) at latent
        resolution."""
        te = self.time_embed(t)
        if self.fused_active():
            b = noisy_latent.shape[0]
            te_b = te.expand(b, te.shape[-1]) if te.ndim == 1 else te
            u6, a3, b3 = denoiser_chain(
                self.chain_params(), noisy_latent.to(torch.bfloat16).contiguous(),
                cond_latent.to(torch.bfloat16).contiguous(), te_b.contiguous())
            return finish_eps(u6, a3, b3)
        te = te[None, None, None, :] if te.ndim == 1 else te[:, None, None, :]
        h = cond_latent + te.to(cond_latent.dtype) + self._block(self.noise_embedding, noisy_latent)
        for m in (self.upsample_add.convA.conv, self.upsample_add.convB.conv):
            h = conv2d_nhwc(h, m.weight, m.bias, 1, 1, self.dtype)
        return self._block(self.pred, h)
