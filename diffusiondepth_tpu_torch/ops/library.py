"""The kernels of the serving path as ``torch.library`` operators.

``torch.export`` traces a model with FakeTensors, and a launch through
``ctypes`` (K1, K4, K8) or a Triton module loaded at first use (K3) cannot
be traced. So the four kernels that an exported predict step runs are
operators of the ``diffusiondepth`` namespace, the port's counterpart of
the JAX package's Pallas custom calls inside a StableHLO artifact:

* ``diffusiondepth::conv_link`` - K1 (``fused_denoiser.conv_link``);
* ``diffusiondepth::ddim_step`` - K3 (``fused_denoiser.ddim_step``);
* ``diffusiondepth::window_attention`` - K4 (``window_attention.window_attention``);
* ``diffusiondepth::window_attention_split`` - K8
  (``window_attention.window_attention_split``).

Each has three implementations: CUDA, the kernel's launch
(``*_cuda`` beside the wrapper, which counts the launch in
``native.LAUNCHES``); CPU, the plain PyTorch version; and a fake rule that
gives the outputs' shapes and types only. Each has a formula for
``torch.utils.flop_counter.FlopCounterMode``: the multiply-adds of its
products, counted twice (K3 has none). A custom operator cannot return
None, so K1 returns an empty tensor in place of the partials it was not
asked for; its wrapper maps that back to None.

The operators are registered with ``torch.library.Library`` define/impl,
which dispatches with less work per call than ``torch.library.custom_op``.
Importing ``diffusiondepth_tpu_torch.ops`` imports this module; nothing
here builds a kernel or imports triton: the CUDA implementations do that
at their first launch. An exported artifact names the operators, so a
process loads this module before ``torch.export.load``.

The training kernels (K2, K5, K6, K7) and the opt-in LayerNorm (K9, K10)
are direct wrappers, not operators: nothing exports them.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from . import fused_denoiser as fd
from . import window_attention as wa

NAMESPACE = "diffusiondepth"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("conv_link(Tensor x, Tensor w, Tensor bias, Tensor? aeff, Tensor? beff, bool relu, "
            "Tensor? add, Tensor? te, bool stats) -> (Tensor, Tensor)")
_LIB.define("ddim_step(Tensor u6, Tensor aeff, Tensor beff, Tensor x, Tensor sched) -> Tensor")
_LIB.define("window_attention(Tensor qkv, Tensor bias, Tensor? mask, float scale, "
            "int num_heads) -> Tensor")
_LIB.define("window_attention_split(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? mask, "
            "float scale) -> Tensor")


def _no_partials(x: torch.Tensor) -> torch.Tensor:
    return torch.empty((0,), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------- K1


def _conv_link_cpu(x, w, bias, aeff, beff, relu, add, te, stats):
    y, ps = fd.conv_link_plain(x, w, bias, aeff, beff, relu, add, te, stats)
    return y, ps if stats else _no_partials(x)


def _conv_link_cuda(x, w, bias, aeff, beff, relu, add, te, stats):
    y, ps = fd.conv_link_cuda(x, w, bias, aeff, beff, relu, add, te, stats)
    return y, ps if stats else _no_partials(x)


def _conv_link_fake(x, w, bias, aeff, beff, relu, add, te, stats):
    B, H, W, _ = x.shape
    cout = w.shape[3]
    y = x.new_empty((B, H, W, cout), dtype=fd.BF16)
    if not stats:
        return y, _no_partials(x)
    return y, x.new_empty(fd.conv_link_partials_shape(B, H, W, cout, x.device.type),
                          dtype=torch.float32)


_LIB.impl("conv_link", _conv_link_cpu, "CPU")
_LIB.impl("conv_link", _conv_link_cuda, "CUDA")
torch.library.register_fake(f"{NAMESPACE}::conv_link", _conv_link_fake, lib=_LIB)


@register_flop_formula(torch.ops.diffusiondepth.conv_link)
def _conv_link_flop(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """A 3x3 convolution: 2 B H W 9 Cin Cout."""
    B, H, W, cin = x_shape
    return 2 * B * H * W * 9 * cin * w_shape[3]


# ---------------------------------------------------------------- K3


_LIB.impl("ddim_step", fd.ddim_step_plain, "CPU")
_LIB.impl("ddim_step", fd.ddim_step_cuda, "CUDA")


def _ddim_step_fake(u6, aeff, beff, x, sched):
    return torch.empty_like(x)


torch.library.register_fake(f"{NAMESPACE}::ddim_step", _ddim_step_fake, lib=_LIB)


@register_flop_formula(torch.ops.diffusiondepth.ddim_step)
def _ddim_step_flop(*args, out_shape=None, **kwargs) -> int:
    """An elementwise update: no products."""
    return 0


# ---------------------------------------------------------------- K4, K8


def _window_attention_fake(qkv, bias, mask, scale, num_heads):
    b, nw, n, c3 = qkv.shape
    return qkv.new_empty((b, nw, n, c3 // 3))


_LIB.impl("window_attention", wa.window_attention_plain, "CPU")
_LIB.impl("window_attention", wa.window_attention_cuda, "CUDA")
torch.library.register_fake(f"{NAMESPACE}::window_attention", _window_attention_fake, lib=_LIB)


@register_flop_formula(torch.ops.diffusiondepth.window_attention)
def _window_attention_flop(qkv_shape, bias_shape, mask_shape, scale, num_heads,
                           out_shape=None, **kwargs) -> int:
    """q k^T and P v: 4 B nW heads N^2 d."""
    b, nw, n, c3 = qkv_shape
    return 4 * b * nw * n * n * (c3 // 3)


def _window_attention_split_fake(q, k, v, bias, mask, scale):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


_LIB.impl("window_attention_split", wa.window_attention_split_plain, "CPU")
_LIB.impl("window_attention_split", wa.window_attention_split_cuda, "CUDA")
torch.library.register_fake(f"{NAMESPACE}::window_attention_split", _window_attention_split_fake,
                            lib=_LIB)


@register_flop_formula(torch.ops.diffusiondepth.window_attention_split)
def _window_attention_split_flop(q_shape, *args, out_shape=None, **kwargs) -> int:
    """q k^T and P v: 4 B nW heads N^2 d."""
    b, nw, h, n, d = q_shape
    return 4 * b * nw * h * n * n * d
