"""The denoiser conv chain and the eval DDIM update (port of the forward
of ``diffusiondepth_tpu/ops/fused_denoiser.py``).

``ScheduledCNNRefine`` for ``fuse='upsample_add'`` under the bf16 policy is
six 3x3 conv links with GroupNorm(4) + ReLU between them. Each link runs as
one pass of ``conv_link`` (kernel K1, ``csrc/conv_link.cu``): it reads the
previous link's raw conv output, applies the previous GroupNorm as a
per-(batch, channel) affine, the ReLU and the condition add, convolves,
adds the bias, and emits per-block (sum y, sum y^2) partials from which
``gn_affine_from_partials`` builds the next affine. ``ddim_step`` (kernel
K3, ``csrc/ddim_step.py``) finishes the last GroupNorm + ReLU and applies
the DDIM update in f32.

Every wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (``*_plain``) for a CPU tensor. Layouts are unpadded NHWC.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
import os
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import native

BF16 = torch.bfloat16
_F_GN, _F_RELU, _F_ADD, _F_TE, _F_STATS = 1, 2, 4, 8, 16


def _rb(t: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back."""
    return t.to(BF16).float()


def _link_input_plain(x, aeff, beff, relu, add, te):
    v = x.float()
    if aeff is not None:
        v = _rb(_rb(v * _rb(aeff)[:, None, None, :]) + _rb(beff)[:, None, None, :])
    if relu:
        v = v.clamp_min(0.0)
    if add is not None:
        t = add.float()
        if te is not None:
            t = _rb(t + te.float()[:, None, None, :])
        v = _rb(v + t)
    return v


def conv_link_plain(x, w, bias, aeff=None, beff=None, relu=False, add=None,
                    te=None, stats=False):
    """K1's arithmetic in plain PyTorch: the transform of the input with
    bf16 rounding after each operation, zero padding of the transformed
    map, f32 products of bf16 values with f32 accumulation, + bias; y in
    bf16 and (B, 1, 2, Cout) f32 partials of the f32 accumulator."""
    v = _link_input_plain(x, aeff, beff, relu, add, te)
    acc = F.conv2d(v.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    acc = acc + bias.float()
    partials = None
    if stats:
        partials = torch.stack([acc.sum((1, 2)), (acc * acc).sum((1, 2))], 1)[:, None]
    return acc.to(BF16), partials


@functools.lru_cache(maxsize=None)
def _conv_link_lib():
    """(launch function, output pixels per block) of csrc/conv_link.cu."""
    lib = native.load("conv_link")
    fn = lib.conv_link_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lib.conv_link_block_pixels()


def conv_link(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              aeff: Optional[torch.Tensor] = None,
              beff: Optional[torch.Tensor] = None, relu: bool = False,
              add: Optional[torch.Tensor] = None,
              te: Optional[torch.Tensor] = None, stats: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One chain link, y = conv3x3(T(x)) + bias with
    T(x) = [relu]([x * aeff + beff]) [+ (add [+ te])], zero outside the image.

    x, add: (B, H, W, Cin) bf16; w: (3, 3, Cin, Cout) bf16; bias: (Cout,)
    f32; aeff, beff: (B, Cin) f32; te: (B, Cin) bf16. Returns y (B, H, W,
    Cout) bf16 and, with ``stats``, (B, n_blocks, 2, Cout) f32 partial sums.
    """
    if x.device.type == "cpu":
        return conv_link_plain(x, w, bias, aeff, beff, relu, add, te, stats)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, H, W, cin = x.shape
    cout = w.shape[3]
    if (aeff is None) != (beff is None) or (te is not None and add is None):
        raise ValueError("aeff and beff go together; te requires add")
    if cin % 16 or not (cout == 16 or cout % 64 == 0):
        raise ValueError(f"the kernel takes Cin % 16 == 0 and Cout in 16 or 64k: {cin}->{cout}")
    expect = [(x, (B, H, W, cin), BF16), (w, (3, 3, cin, cout), BF16),
              (bias, (cout,), torch.float32)]
    if aeff is not None:
        expect += [(aeff, (B, cin), torch.float32), (beff, (B, cin), torch.float32)]
    if add is not None:
        expect.append((add, (B, H, W, cin), BF16))
    if te is not None:
        expect.append((te, (B, cin), BF16))
    for t, shape, dt in expect:
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("conv_link inputs must be contiguous on one device")
    lib_fn, bm = _conv_link_lib()
    n_blocks = H * ((W + bm - 1) // bm)
    y = torch.empty((B, H, W, cout), dtype=BF16, device=x.device)
    partials = (torch.empty((B, n_blocks, 2, cout), dtype=torch.float32,
                            device=x.device) if stats else None)
    flags = ((_F_GN if aeff is not None else 0) | (_F_RELU if relu else 0)
             | (_F_ADD if add is not None else 0) | (_F_TE if te is not None else 0)
             | (_F_STATS if stats else 0))

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib_fn(ptr(x), ptr(w), ptr(bias), ptr(aeff), ptr(beff), ptr(add),
                     ptr(te), ptr(y), ptr(partials), B, H, W, cin, cout, flags,
                     torch.cuda.current_stream(x.device).cuda_stream)
    native.check(err, "conv_link")
    native.LAUNCHES["conv_link"] += 1
    return y, partials


def gn_affine_from_partials(ps: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, num_groups: int,
                            n_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, 2, C) partial sums -> per-(batch, channel) f32 affine
    (aeff, beff) with gn(x) == x * aeff + beff."""
    B, _, _, c = ps.shape
    cg = c // num_groups
    s = ps[:, :, 0].sum(1).reshape(B, num_groups, cg).sum(-1)
    q = ps[:, :, 1].sum(1).reshape(B, num_groups, cg).sum(-1)
    mean = s / n_valid
    var = torch.clamp_min(q / n_valid - mean * mean, 0.0)
    inv = torch.rsqrt(var + 1e-5)
    meanc = mean.repeat_interleave(cg, dim=-1)
    invc = inv.repeat_interleave(cg, dim=-1)
    aeff = scale.float()[None, :] * invc
    beff = bias.float()[None, :] - meanc * aeff
    return aeff.contiguous(), beff.contiguous()


def denoiser_chain(p: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                   x: torch.Tensor, cond: torch.Tensor, te: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The six links of ScheduledCNNRefine(fuse='upsample_add').

    p: ``{ne0, ne1, fa, fb, pr0, pr1: (w (3,3,Cin,Cout) bf16, bias f32),
    gn0..gn3: (scale f32, bias f32)}``; x (B, H, W, 16) bf16 noisy latent;
    cond (B, H, W, C) bf16 condition; te (B, C) bf16 timestep embedding.
    Returns the raw last conv output u6 and GroupNorm-3's affine; the noise
    prediction is ``finish_eps(u6, aeff, beff)``.
    """
    B, H, W, _ = x.shape

    def affine(ps, gn):
        return gn_affine_from_partials(ps, *gn, 4, H * W * (ps.shape[-1] // 4))

    u1, ps1 = conv_link(x, *p["ne0"], stats=True)
    a0, b0 = affine(ps1, p["gn0"])
    u2, ps2 = conv_link(u1, *p["ne1"], aeff=a0, beff=b0, relu=True, stats=True)
    a1, b1 = affine(ps2, p["gn1"])
    u3, _ = conv_link(u2, *p["fa"], aeff=a1, beff=b1, relu=True, add=cond, te=te)
    u4, _ = conv_link(u3, *p["fb"])
    u5, ps5 = conv_link(u4, *p["pr0"], stats=True)
    a2, b2 = affine(ps5, p["gn2"])
    u6, ps6 = conv_link(u5, *p["pr1"], aeff=a2, beff=b2, relu=True, stats=True)
    a3, b3 = affine(ps6, p["gn3"])
    return u6, a3, b3


def finish_eps(u6: torch.Tensor, aeff: torch.Tensor, beff: torch.Tensor) -> torch.Tensor:
    """eps = relu(u6 * aeff + beff) in bf16 arithmetic (GroupNorm-3 + ReLU)."""
    return torch.clamp_min(u6 * aeff.to(BF16)[:, None, None, :]
                           + beff.to(BF16)[:, None, None, :], 0.0)


def ddim_step_plain(u6, aeff, beff, x, sched):
    """K3's arithmetic in plain PyTorch: the bf16 eps, then the f32 update
    of ``DDIMSchedule.step_from_alphas`` (epsilon prediction, eta 0,
    re-derived epsilon) with sched = [sa, sb, sp, sq]."""
    eps = finish_eps(u6, aeff, beff).float()
    sa, sb, sp, sq = sched[0], sched[1], sched[2], sched[3]
    x0 = (x - sb * eps) / sa
    eps2 = (x - sa * x0) / sb
    return sp * x0 + sq * eps2


@functools.lru_cache(maxsize=None)
def _ddim_step_module():
    # Triton's compiled kernels go beside the CUDA builds, inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(native.BUILD_DIR / "triton"))
    path = native.CSRC_DIR / "ddim_step.py"
    spec = importlib.util.spec_from_file_location("_ddim_step_triton", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ddim_step(u6: torch.Tensor, aeff: torch.Tensor, beff: torch.Tensor,
              x: torch.Tensor, sched: torch.Tensor) -> torch.Tensor:
    """x' = DDIM update of the f32 latent x with eps = relu(gn3(u6)).

    u6 (B, H, W, C) bf16; aeff, beff (B, C) f32; x (B, H, W, C) f32;
    sched (4,) f32 on x's device."""
    if x.device.type == "cpu":
        return ddim_step_plain(u6, aeff, beff, x, sched)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, H, W, C = x.shape
    for t, shape, dt in ((u6, (B, H, W, C), BF16), (x, (B, H, W, C), torch.float32),
                         (aeff, (B, C), torch.float32), (beff, (B, C), torch.float32),
                         (sched, (4,), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("ddim_step inputs must be contiguous on one device")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _ddim_step_module().launch(u6, x, aeff, beff, sched, out)
    native.LAUNCHES["ddim_step"] += 1
    return out
