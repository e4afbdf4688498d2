"""The conditional denoiser ``ScheduledCNNRefine`` (port of
``diffusiondepth_tpu/models/heads/denoiser.py``).

noise embedding conv(16->64) GN(4) ReLU conv(64->C) GN(4) ReLU; timestep
embedding table Embed(1280, C); the fusion of condition and noise
embedding; predictor conv(C->64) GN(4) ReLU conv(64->16) GN(4) ReLU. The
condition map comes in already at latent resolution (``upsample_condition``
runs once, outside the sampling loop). Three fusions:

* ``'add'`` (the ResNet heads): condition + timestep + noise embedding;
* ``'upsample_add'`` (the Swin and MPViT heads): the same sum through two
  plain 3x3 convs, ``upsample_add.convA/convB``, built only for it;
* ``'upsample_concat'`` (the bins heads): concat(condition + timestep,
  noise embedding) through ``upsample_fuse.convA`` (2C -> C) and
  ``upsample_fuse.convB``.

``fused_active(latent_h)`` holds for ``use_fused``, ``'add'`` or
``'upsample_add'``, the bf16 policy and ``latent_h % 8 == 0``: the JAX
package's guard, which takes 'upsample_add' only (its 'add' runs on XLA,
with no kernel to port), widened to 'add'. There the convs run as the
fused chain of ``ops/fused_denoiser.py``, six links for 'upsample_add' and
four for 'add' (kernel K1 on the card, ``FusedDenoiser``: its backward is
kernel K5). Everywhere else ('upsample_concat', f32, ``use_fused`` off) the
module path below runs, the JAX package's jnp path: on the card its
convolutions are cuDNN's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fused_denoiser import (
    CONV_KEYS, FusedDenoiser, chain_keys, chain_params_from_flat,
)
from ...ops.native import to_device
from ...ops.resize import resize_bilinear
from ...parallel.tensor import whole
from ..common import conv2d_nhwc, group_norm_nhwc


def _conv_gn_block(cin: int, mid: int, cout: int) -> nn.Sequential:
    """Reference layout Sequential(conv, GN, ReLU, conv, GN, ReLU)."""
    return nn.Sequential(
        nn.Conv2d(cin, mid, 3, 1, 1), nn.GroupNorm(4, mid), nn.ReLU(),
        nn.Conv2d(mid, cout, 3, 1, 1), nn.GroupNorm(4, cout), nn.ReLU())


class _Conv(nn.Module):
    """Holds a conv under the reference name ``conv``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, 1, 1)


FUSES = ("add", "upsample_add", "upsample_concat")


class ScheduledCNNRefine(nn.Module):
    def __init__(self, channels_in: int = 256, channels_noise: int = 16,
                 fuse: str = "upsample_add", num_timestep_embeds: int = 1280,
                 use_fused: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if fuse not in FUSES:
            raise ValueError(f"fuse {fuse!r} is not ported; ported: {FUSES}")
        self.fuse = fuse
        self.use_fused = use_fused
        self.dtype = dtype
        self.noise_embedding = _conv_gn_block(channels_noise, 64, channels_in)
        self.time_embedding = nn.Embedding(num_timestep_embeds, channels_in)
        if fuse != "add":
            fusion = nn.Module()
            fusion.convA = _Conv(channels_in * (2 if fuse == "upsample_concat" else 1),
                                 channels_in)
            fusion.convB = _Conv(channels_in, channels_in)
            setattr(self, "upsample_add" if fuse == "upsample_add" else "upsample_fuse", fusion)
        self.pred = _conv_gn_block(channels_in, 64, channels_noise)

    def fused_active(self, latent_h: int) -> bool:
        """True when a call on a latent of height ``latent_h`` runs as the
        fused conv chain: the JAX package's guard without its TPU term,
        with 'add' beside 'upsample_add'."""
        return (self.use_fused and self.fuse in ("add", "upsample_add")
                and self.dtype == torch.bfloat16 and latent_h % 8 == 0)

    def upsample_condition(self, cond: torch.Tensor, latent_hw) -> torch.Tensor:
        """Bring the condition map to latent resolution once (align_corners).
        ``'add'`` takes it as it is where it already has that size."""
        if self.fuse == "add" and tuple(cond.shape[1:3]) == tuple(latent_hw):
            return cond
        return resize_bilinear(cond, tuple(latent_hw), align_corners=True)

    def time_embed(self, t) -> torch.Tensor:
        """The embedding rows of timestep(s) ``t``. A gather, not ``w[t]``:
        indexing with a 0-d tensor reads its value on the host (a sync per
        step on the card, a data-dependent size under ``torch.export``)."""
        w = whole(self.time_embedding.weight)
        idx = to_device(t, w.device)
        te = w.index_select(0, idx.reshape(-1))
        te = te[0] if idx.ndim == 0 else te
        return te.to(self.dtype) if self.dtype is not None else te

    def chain_flat(self) -> List[torch.Tensor]:
        """The chain's f32 parameters in ``chain_keys`` order, (weight,
        bias) each, conv weights as (3, 3, Cin, Cout): the leaves the
        autograd Functions take, with the fusion convs fa and fb where the
        module has them ('upsample_add'). A weight cut over 'model' is
        gathered whole (``parallel.whole``): K1 and K5 take whole channel
        sets."""
        if self.fuse == "upsample_concat":
            raise ValueError("the 'upsample_concat' denoiser has no fused chain")
        ne, pr = self.noise_embedding, self.pred
        mods = {"ne0": ne[0], "gn0": ne[1], "ne1": ne[3], "gn1": ne[4],
                "pr0": pr[0], "gn2": pr[1], "pr1": pr[3], "gn3": pr[4]}
        if hasattr(self, "upsample_add"):
            mods.update(fa=self.upsample_add.convA.conv, fb=self.upsample_add.convB.conv)
        flat = []
        for k in chain_keys(2 * len(mods)):
            m = mods[k]
            w = whole(m.weight)
            w = w.permute(2, 3, 1, 0).contiguous() if k in CONV_KEYS else w
            flat += [w, m.bias]
        return flat

    def chain_params(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Weights of the chain's links as ``denoiser_chain`` takes them:
        conv (3, 3, Cin, Cout) bf16 + f32 bias, GroupNorm f32 (scale, bias).
        They stay in the autograd graph of the f32 parameters. Made once
        per sampling call, outside the step loop."""
        return chain_params_from_flat(self.chain_flat())

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
        if self.fused_active(noisy_latent.shape[1]):
            b = noisy_latent.shape[0]
            te_b = te.expand(b, te.shape[-1]) if te.ndim == 1 else te
            return FusedDenoiser.apply(
                noisy_latent.to(torch.bfloat16).contiguous(),
                cond_latent.to(torch.bfloat16).contiguous(), te_b.contiguous(),
                *self.chain_flat())
        te = te[None, None, None, :] if te.ndim == 1 else te[:, None, None, :]
        feat = cond_latent + te.to(cond_latent.dtype)
        ne = self._block(self.noise_embedding, noisy_latent)
        concat = self.fuse == "upsample_concat"
        h = torch.cat([feat, ne], dim=-1) if concat else feat + ne
        if self.fuse != "add":
            fusion = self.upsample_fuse if concat else self.upsample_add
            for m in (fusion.convA.conv, fusion.convB.conv):
                h = conv2d_nhwc(h, m.weight, m.bias, 1, 1, self.dtype)
        return self._block(self.pred, h)
