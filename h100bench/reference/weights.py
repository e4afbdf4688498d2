"""Weights of the reference model drawn from a seed, on the model's device,
in one call: a single normal draw of every parameter and buffer at once,
then each tensor scaled by the rule of its kind. The program loads the same
state dict, so both sides start from one set of numbers.

Rules (std of a normal draw unless said): a conv or linear weight
1/sqrt(fan in); their biases 0.02; a norm's scale 1 + 0.1 n and shift 0.1 n;
BatchNorm running mean 0.1 n and running variance 1 + 0.1 |n|; the
relative-position bias table 0.02; the timestep embedding 1.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _kind(module: nn.Module, leaf: str) -> str:
    if leaf in ("running_mean", "running_var"):
        return leaf
    if leaf == "relative_position_bias_table":
        return "small"
    if isinstance(module, nn.Embedding):
        return "unit"
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        return "fan_in" if leaf == "weight" else "small"
    return "scale" if leaf == "weight" else "shift"  # the norms


def _fan_in(module: nn.Module) -> int:
    w = module.weight
    if isinstance(module, nn.ConvTranspose2d):  # each output sees in * k^2 / stride^2 inputs
        return max(1, w.shape[0] * w.shape[2] * w.shape[3] // (module.stride[0] * module.stride[1]))
    return w[0].numel()


@torch.no_grad()
def draw_weights(model: nn.Module, seed: int) -> None:
    """Fill every parameter and buffer of ``model`` (already on its device,
    possibly uninitialised) from ``seed``."""
    leaves = []
    for mname, module in model.named_modules():
        for leaf, t in list(module.named_parameters(recurse=False)) + \
                list(module.named_buffers(recurse=False)):
            if t.is_floating_point():
                leaves.append((module, leaf, t))
    dev = leaves[0][2].device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    total = sum(t.numel() for _, _, t in leaves)
    draw = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    off = 0
    for module, leaf, t in leaves:
        n = draw[off:off + t.numel()].view(t.shape)
        off += t.numel()
        kind = _kind(module, leaf)
        if kind == "fan_in":
            t.copy_(n * _fan_in(module) ** -0.5)
        elif kind == "small":
            t.copy_(n * 0.02)
        elif kind == "unit":
            t.copy_(n)
        elif kind == "scale":
            t.copy_(1.0 + 0.1 * n)
        elif kind == "running_var":
            t.copy_(1.0 + 0.1 * n.abs())
        else:  # shift, running_mean
            t.copy_(0.1 * n)
