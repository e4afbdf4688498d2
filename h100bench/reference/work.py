"""The work a layer needs, counted once over the reference for a
configuration file's frozen numbers (``sampler``, ``mhca``, ``flops``), per
frame. FLOPs are ``FlopCounterMode``'s: two a multiply-add of every
convolution and matrix product, nothing for the elementwise work. Bytes are
what the layer has to move at the least, each input read once and each
output written once, in the configuration's precision (bf16, f32 for the
sampler's latent).

* ``sampler_work``: the DDIM sampler of ``reference/model.py``, counted over
  ``DDIMHead.sample`` on the meta device (shapes only).
* ``mhca_work``: MPViT's path encoders (``backbones/mpvit.py``), in closed
  form. Per block of N tokens, C channels, heads of Ch channels and MLP
  ratio r: the position encoding's depthwise 3x3 (18 N C), QKV, the
  projection and the MLP ((8 + 4 r) N C^2), K^T V and Q (K^T V) (4 N C Ch)
  and the CRPE's depthwise convs (2 N Ch sum(heads x window^2)). Bytes:
  each block reads its bf16 token tensor twice and writes it once (the
  global K^T V needs every token before any output), and each encoder's
  weights are read once in bf16.
* ``forward_flops``: the whole reference model, for the benchmark's own
  count beside the program's frozen ``forward_per_frame``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.utils.flop_counter

from . import model as R
from .backbones.mpvit import CRPE_WINDOWS


def counted_flops(fn, *args) -> int:
    """FLOPs of ``fn(*args)`` as ``FlopCounterMode`` counts them."""
    counter = torch.utils.flop_counter.FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args)
    return counter.get_total_flops()


def latent_hw(spec: dict, h: int, w: int) -> Tuple[int, int]:
    s = spec["latent_stride"]
    return h // s, w // s


def sampler_work(spec: dict, h: int, w: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one frame's sampler at an ``h`` x ``w`` input: every
    step reads the f32 latent and the bf16 condition once and writes the
    f32 latent once."""
    lh, lw = latent_hw(spec, h, w)
    lc, fpn = spec["latent_channels"], spec["fpn_dim"]
    with torch.device("meta"):
        head = R.DDIMHead([fpn], spec["fuse"], False, spec["inference_steps"], fpn, lc)
        flops = counted_flops(head.sample, torch.empty(1, fpn, lh, lw),
                              torch.empty(1, lc, lh, lw))
    return flops, spec["inference_steps"] * lh * lw * (4 * lc + 2 * fpn + 4 * lc)


def mhca_work(spec: dict, h: int, w: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one frame's MPViT path encoders at an ``h`` x ``w``
    input (module docstring). The stem keeps the input's size and each
    stage's first patch embed is a stride-2 3x3 conv (pad 1)."""
    flops = nbytes = 0
    for c, heads, r, paths, layers in zip(spec["embed_dims"], spec["num_heads"],
                                          spec["mlp_ratios"], spec["num_path"],
                                          spec["num_layers"]):
        h, w = (h + 1) // 2, (w + 1) // 2
        n, ch = h * w, c // heads
        block = n * (18 * c + (8 + 4 * r) * c * c + 4 * c * ch
                     + 2 * ch * sum(k * k * g for k, g in CRPE_WINDOWS.items()))
        weights = (10 * c                                       # position encoding
                   + sum((k * k + 1) * g * ch for k, g in CRPE_WINDOWS.items())  # CRPE
                   + layers * ((4 + 2 * r) * c * c + (9 + r) * c))  # blocks
        flops += paths * layers * block
        nbytes += paths * (layers * 3 * 2 * n * c + 2 * weights)
    return flops, nbytes


def forward_flops(spec: dict, h: int, w: int) -> int:
    """FLOPs of the reference model on one ``h`` x ``w`` frame."""
    lh, lw = latent_hw(spec, h, w)
    with torch.device("meta"):
        ref = R.build(spec)
        return counted_flops(ref, torch.empty(1, h, w, 3), torch.empty(1, h, w, 1),
                             torch.empty(1, lh, lw, spec["latent_channels"]))
