"""The denoiser conv chain, the DDIM updates and their backward (port of
``diffusiondepth_tpu/ops/fused_denoiser.py``).

``ScheduledCNNRefine`` for ``fuse='upsample_add'`` under the bf16 policy is
six 3x3 conv links with GroupNorm(4) + ReLU between them. Each link runs as
one pass of ``conv_link`` (kernel K1, ``csrc/conv_link.cu``): it reads the
previous link's raw conv output, applies the previous GroupNorm as a
per-(batch, channel) affine, the ReLU and the condition add, convolves,
adds the bias, and emits per-block (sum y, sum y^2) partials from which
``gn_affine_from_partials`` builds the next affine. ``ddim_step`` (kernel
K3, ``csrc/ddim_step.py``) finishes the last GroupNorm + ReLU and applies
the DDIM update in f32 (eval).

Training:

* ``sched_step`` (K2, ``csrc/ddim_step.py``) is K3's arithmetic writing the
  new latent in f32 and in bf16: the (f32, bf16) pair the sampler carries.
* ``conv_link_bwd`` (K5, ``csrc/conv_link_bwd.cu``) is the backward of one
  link; ``gn_bwd_glue`` turns its (sum t, sum t*xhat) partials into the
  coefficients of the next link up and the GroupNorm's parameter grads.
* ``sched_bwd`` (K6, ``csrc/sched_bwd.py``) is the closed-form transpose of
  the DDIM update fused with the GroupNorm-3/ReLU backward.
* ``FusedDenoiser`` (the ``ddim_loss`` call) and ``FusedSamplerStep`` (one
  sampler step) are the ``torch.autograd.Function``s around them: the
  forward runs the kernels, the backward recomputes the chain and runs the
  backward kernels. Only the bf16 latent (and the inputs) are saved per
  step; the JAX package's u4/u5 residual gates exist for the v5e's 16 GB
  and are not ported.

Every wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (``*_plain``) for a CPU tensor; it raises when grad mode is
on and an input requires grad (``native.no_autograd``). ``conv_link`` and
``ddim_step`` do so through ``torch.library`` operators (``ops/library.py``,
whose CUDA implementations are ``conv_link_cuda`` and ``ddim_step_cuda``),
so that ``torch.export`` can trace the eval path; the training Functions
call ``conv_link_direct``, which skips the operator's dispatch. Layouts are
unpadded NHWC.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import native

BF16 = torch.bfloat16
_F_GN, _F_RELU, _F_ADD, _F_TE, _F_STATS = 1, 2, 4, 8, 16
_B_GN_NEXT, _B_GN_IN, _B_ADD, _B_TE = 1, 2, 4, 8

CHAIN_KEYS = ("ne0", "gn0", "ne1", "gn1", "fa", "fb", "pr0", "gn2", "pr1", "gn3")
CONV_KEYS = ("ne0", "ne1", "fa", "fb", "pr0", "pr1")

Params = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _rb(t: torch.Tensor) -> torch.Tensor:
    """Round f32 values to bf16 and back."""
    return t.to(BF16).float()


def _ptr(t):
    return t.data_ptr() if t is not None else None


# ---------------------------------------------------------------------------
# K1: one forward link
# ---------------------------------------------------------------------------


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
    """The launch function of csrc/conv_link.cu; raises if the library's
    block differs from ``CONV_LINK_BLOCK_PIXELS``."""
    lib = native.load("conv_link")
    if lib.conv_link_block_pixels() != CONV_LINK_BLOCK_PIXELS:
        raise RuntimeError(f"conv_link.cu blocks {lib.conv_link_block_pixels()} pixels, "
                           f"CONV_LINK_BLOCK_PIXELS is {CONV_LINK_BLOCK_PIXELS}")
    fn = lib.conv_link_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the output pixels per block of csrc/conv_link.cu (``Conv3x3::BM``): one
# (sum y, sum y^2) partial each. The op's fake rule sizes the partials with
# it; ``_conv_link_lib`` checks it against the built library.
CONV_LINK_BLOCK_PIXELS = 128


def conv_link_partials_shape(B: int, H: int, W: int, cout: int, device_type: str):
    """Shape of K1's partials: one per block of ``CONV_LINK_BLOCK_PIXELS``
    pixels of an image row on the card, one per image from the plain version."""
    n = H * -(-W // CONV_LINK_BLOCK_PIXELS) if device_type == "cuda" else 1
    return (B, n, 2, cout)


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
    Runs the operator ``diffusiondepth::conv_link`` (``ops/library.py``):
    the kernel on the card, the plain version on the CPU, a shape rule
    under ``torch.export``.
    """
    native.no_autograd("conv_link", x, w, bias, aeff, beff, add, te)
    native.check_device(x)
    y, partials = torch.ops.diffusiondepth.conv_link.default(
        x, w, bias, aeff, beff, relu, add, te, stats)
    return y, partials if stats else None


def conv_link_direct(x, w, bias, aeff=None, beff=None, relu=False, add=None, te=None,
                     stats=False):
    """``conv_link`` without the operator's dispatch: the plain version for
    a CPU tensor, the launch otherwise. The training Functions take it (a
    step makes hundreds of links)."""
    if x.device.type == "cpu":
        return conv_link_plain(x, w, bias, aeff, beff, relu, add, te, stats)
    return conv_link_cuda(x, w, bias, aeff, beff, relu, add, te, stats)


def conv_link_cuda(x, w, bias, aeff, beff, relu, add, te, stats):
    """K1's launch on CUDA tensors (the operator's CUDA implementation):
    checks, output allocation, one launch, one count."""
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
    native.check_tensors("conv_link", expect, x.device)
    native.check_aligned("conv_link", x, w)
    lib_fn = _conv_link_lib()
    y = torch.empty((B, H, W, cout), dtype=BF16, device=x.device)
    partials = (torch.empty(conv_link_partials_shape(B, H, W, cout, "cuda"),
                            dtype=torch.float32, device=x.device) if stats else None)
    flags = ((_F_GN if aeff is not None else 0) | (_F_RELU if relu else 0)
             | (_F_ADD if add is not None else 0) | (_F_TE if te is not None else 0)
             | (_F_STATS if stats else 0))
    # the kernel reads the weights with K (Cin) contiguous: (3, 3, Cout, Cin)
    wk = w.transpose(2, 3).contiguous()
    with torch.cuda.device(x.device):  # the launch goes to the current device
        err = lib_fn(_ptr(x), _ptr(wk), _ptr(bias), _ptr(aeff), _ptr(beff), _ptr(add),
                     _ptr(te), _ptr(y), _ptr(partials), B, H, W, cin, cout, flags,
                     torch.cuda.current_stream(x.device).cuda_stream)
    native.check(err, "conv_link")
    native.LAUNCHES["conv_link"] += 1
    return y, partials


def gn_affine_from_partials(ps: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, num_groups: int, n_valid: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, T, 2, C) partial sums -> per-(batch, channel) f32 affine
    (aeff, beff) with gn(x) == x * aeff + beff, and the per-channel
    inverse std and mean the backward needs."""
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
    return aeff.contiguous(), beff.contiguous(), invc.contiguous(), meanc.contiguous()


def chain_forward(p: Params, x: torch.Tensor, cond: torch.Tensor, te: torch.Tensor,
                  link=conv_link) -> Dict[str, object]:
    """The six links of ScheduledCNNRefine(fuse='upsample_add'), keeping
    the raw conv outputs u1..u6 and the GroupNorm statistics g0..g3
    (aeff, beff, inv, mean) that the backward needs.

    p: ``{ne0, ne1, fa, fb, pr0, pr1: (w (3,3,Cin,Cout) bf16, bias f32),
    gn0..gn3: (scale f32, bias f32)}``; x (B, H, W, 16) bf16 noisy latent;
    cond (B, H, W, C) bf16 condition; te (B, C) bf16 timestep embedding.
    ``link`` runs each link: ``conv_link`` (the operator) or
    ``conv_link_direct``.
    """
    B, H, W, _ = x.shape

    def affine(ps, gn):
        return gn_affine_from_partials(ps, *gn, 4, H * W * (ps.shape[-1] // 4))

    u1, ps1 = link(x, *p["ne0"], stats=True)
    g0 = affine(ps1, p["gn0"])
    u2, ps2 = link(u1, *p["ne1"], aeff=g0[0], beff=g0[1], relu=True, stats=True)
    g1 = affine(ps2, p["gn1"])
    u3, _ = link(u2, *p["fa"], aeff=g1[0], beff=g1[1], relu=True, add=cond, te=te)
    u4, _ = link(u3, *p["fb"])
    u5, ps5 = link(u4, *p["pr0"], stats=True)
    g2 = affine(ps5, p["gn2"])
    u6, ps6 = link(u5, *p["pr1"], aeff=g2[0], beff=g2[1], relu=True, stats=True)
    g3 = affine(ps6, p["gn3"])
    return dict(x=x, cond=cond, te=te, u1=u1, u2=u2, u3=u3, u4=u4, u5=u5, u6=u6,
                g0=g0, g1=g1, g2=g2, g3=g3)


def denoiser_chain(p: Params, x: torch.Tensor, cond: torch.Tensor, te: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``chain_forward`` returning the raw last conv output u6 and
    GroupNorm-3's affine; the noise prediction is ``finish_eps(u6, aeff, beff)``."""
    it = chain_forward(p, x, cond, te)
    return it["u6"], it["g3"][0], it["g3"][1]


def finish_eps(u6: torch.Tensor, aeff: torch.Tensor, beff: torch.Tensor) -> torch.Tensor:
    """eps = relu(u6 * aeff + beff) in bf16 arithmetic (GroupNorm-3 + ReLU)."""
    return torch.clamp_min(u6 * aeff.to(BF16)[:, None, None, :]
                           + beff.to(BF16)[:, None, None, :], 0.0)


# ---------------------------------------------------------------------------
# K3 (eval) and K2 (training): the DDIM update
# ---------------------------------------------------------------------------


def ddim_step_plain(u6, aeff, beff, x, sched):
    """K3's arithmetic in plain PyTorch: the bf16 eps, then the f32 update
    of ``DDIMSchedule.step_from_alphas`` (epsilon prediction, eta 0,
    re-derived epsilon) with sched = [sa, sb, sp, sq]."""
    eps = finish_eps(u6, aeff, beff).float()
    sa, sb, sp, sq = sched[0], sched[1], sched[2], sched[3]
    x0 = (x - sb * eps) / sa
    eps2 = (x - sa * x0) / sb
    return sp * x0 + sq * eps2


def _check_step(name, u6, aeff, beff, x, sched):
    B, H, W, C = x.shape
    native.check_tensors(name, ((u6, (B, H, W, C), BF16), (x, (B, H, W, C), torch.float32),
                  (aeff, (B, C), torch.float32), (beff, (B, C), torch.float32),
                  (sched, (4,), torch.float32)), x.device)


def ddim_step(u6: torch.Tensor, aeff: torch.Tensor, beff: torch.Tensor,
              x: torch.Tensor, sched: torch.Tensor) -> torch.Tensor:
    """x' = DDIM update of the f32 latent x with eps = relu(gn3(u6)).

    u6 (B, H, W, C) bf16; aeff, beff (B, C) f32; x (B, H, W, C) f32;
    sched (4,) f32 on x's device. Runs the operator
    ``diffusiondepth::ddim_step`` (``ops/library.py``)."""
    native.no_autograd("ddim_step", u6, aeff, beff, x)
    native.check_device(x)
    return torch.ops.diffusiondepth.ddim_step.default(u6, aeff, beff, x, sched)


def ddim_step_cuda(u6, aeff, beff, x, sched):
    """K3's launch on CUDA tensors (the operator's CUDA implementation)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_step("ddim_step", u6, aeff, beff, x, sched)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        native.triton_module("ddim_step").launch(u6, x, aeff, beff, sched, out)
    native.LAUNCHES["ddim_step"] += 1
    return out


def sched_step_plain(u6, aeff, beff, x, sched):
    """K2's arithmetic: K3's update, returned in f32 and rounded to bf16."""
    xp = ddim_step_plain(u6, aeff, beff, x, sched)
    return xp, xp.to(BF16)


def sched_step(u6: torch.Tensor, aeff: torch.Tensor, beff: torch.Tensor,
               x: torch.Tensor, sched: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training sampler's DDIM update: ``ddim_step``'s x' written as
    the (f32, bf16) pair in one pass (the bf16 copy feeds the next step's
    chain). Arguments as ``ddim_step``."""
    native.no_autograd("sched_step", u6, aeff, beff, x)
    if x.device.type == "cpu":
        return sched_step_plain(u6, aeff, beff, x, sched)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_step("sched_step", u6, aeff, beff, x, sched)
    out = torch.empty_like(x)
    out_b = torch.empty(x.shape, dtype=BF16, device=x.device)
    with torch.cuda.device(x.device):
        native.triton_module("ddim_step").launch(u6, x, aeff, beff, sched, out, out_b)
    native.LAUNCHES["sched_step"] += 1
    return out, out_b


# ---------------------------------------------------------------------------
# K6: the DDIM transpose fused with the GroupNorm-3/ReLU backward
# ---------------------------------------------------------------------------


def sched_bwd_plain(dxp, dxpb, u6, coefs, sched):
    """K6's arithmetic in plain PyTorch.

    dxp (B, H, W, 16) f32 and dxpb bf16 (or None) are the cotangents of
    the two latent copies; coefs (B, 8, 16) f32 [aeff, beff, inv, mean,
    scale, 0, 0, 0] of GroupNorm-3; sched [sa, sb, sp, sq]. Returns dx =
    dxp * sp / sa (f32), the t-form cotangent of u6,
    t6 = relu'(pre) * bf16(deps) * scale with deps = dxp (sq - sp sb / sa),
    in bf16 arithmetic, and (B, 1, 2, 16) partials (sum t6, sum t6 * xhat).
    The partials sum the bf16-rounded t6 and the bf16-rounded products
    t6 * xhat, the values K5 sums; the JAX kernel sums unrounded ones
    (about 0.3% apart)."""
    d = dxp if dxpb is None else dxp + dxpb.float()
    sa, sb, sp, sq = sched[0], sched[1], sched[2], sched[3]
    dx = d * (sp / sa)
    deps = d * (sq - sp * sb / sa)
    u = u6.float()
    a, b, inv, mean, scale = (_rb(coefs[:, i])[:, None, None, :] for i in range(5))
    pre = _rb(_rb(u * a) + b)
    t6 = torch.where(pre > 0, _rb(_rb(deps) * scale), torch.zeros_like(u))
    xh = _rb(_rb(u - mean) * inv)
    ps = torch.stack([t6.sum((1, 2)), _rb(t6 * xh).sum((1, 2))], 1)[:, None]
    return dx, t6.to(BF16), ps


def sched_bwd(dxp: torch.Tensor, dxpb: Optional[torch.Tensor], u6: torch.Tensor,
              coefs: torch.Tensor, sched: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx f32, t6 bf16, (B, T, 2, 16) f32 partials); see ``sched_bwd_plain``."""
    native.no_autograd("sched_bwd", dxp, dxpb, u6, coefs)
    if u6.device.type == "cpu":
        return sched_bwd_plain(dxp, dxpb, u6, coefs, sched)
    if u6.device.type != "cuda":
        raise ValueError(f"unsupported device {u6.device}")
    B, H, W, C = u6.shape
    expect = [(dxp, (B, H, W, C), torch.float32), (u6, (B, H, W, C), BF16),
              (coefs, (B, 8, C), torch.float32), (sched, (4,), torch.float32)]
    if dxpb is not None:
        expect.append((dxpb, (B, H, W, C), BF16))
    native.check_tensors("sched_bwd", expect, u6.device)
    mod = native.triton_module("sched_bwd")
    dx = torch.empty_like(dxp)
    t6 = torch.empty_like(u6)
    ps = torch.empty((B, mod.n_blocks(H * W), 2, C), dtype=torch.float32, device=u6.device)
    with torch.cuda.device(u6.device):
        mod.launch(dxp, dxpb, u6, coefs, sched, dx, t6, ps)
    native.LAUNCHES["sched_bwd"] += 1
    return dx, t6, ps


# ---------------------------------------------------------------------------
# K5: the backward of one link
# ---------------------------------------------------------------------------


def conv_link_bwd_plain(r, w, u_in, u_next=None, coef_next=None, coef_in=None,
                        add=None, te=None):
    """K5's arithmetic in plain PyTorch: the backward of one link
    u_out = conv3x3(T(u_in)) + bias, T as in ``conv_link``.

    r (B, H, W, Cout) bf16 is the raw cotangent of u_out: t-form
    (dy * scale) when a GroupNorm consumes u_out, in which case u_next
    (= u_out) and coef_next (B, 8, Cout) [inv, mean, m1, m2, ...] give
    du = (r - m1 - xhat m2) inv; plain du = r otherwise. coef_in
    (B, 8, Cin) [aeff, beff, inv, mean, scale, ...] when the link applies
    GroupNorm + ReLU to its input; add (the condition) and te as in the
    forward. Rounding as the TPU kernel: xhat and du in bf16 arithmetic,
    bf16 x bf16 products accumulated in f32, dv in f32 then bf16.

    Returns (t_in bf16 (B, H, W, Cin): t-form when coef_in is given, with
    (B, 1, 2, Cin) f32 partials (sum t, sum t * xhat_in); dW (3, 3, Cin,
    Cout) f32; dbias (Cout,) f32; partials or None; d(add) bf16 or None).
    """
    B, H, W, _ = r.shape
    du = r.float()
    if u_next is not None:
        inv, mean, m1, m2 = (_rb(coef_next[:, i])[:, None, None, :] for i in range(4))
        xh = _rb(_rb(u_next.float() - mean) * inv)
        du = _rb(_rb(_rb(du - m1) - _rb(xh * m2)) * inv)
    db = du.sum((0, 1, 2))
    u = u_in.float()
    v = u
    if coef_in is not None:
        ain, bin_, inv_i, mean_i, scale = (_rb(coef_in[:, i])[:, None, None, :] for i in range(5))
        pre = _rb(_rb(u * ain) + bin_)
        v = pre.clamp_min(0.0)
    if add is not None:  # the JAX backward kernel's order: (v + add) + te
        v = _rb(v + add.float())
        if te is not None:
            v = _rb(v + te.float()[:, None, None, :])
    # dW[dr, dc] = sum over pixels of v[h + dr - 1, w + dc - 1] (x) du[h, w]
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    dw = torch.stack([torch.stack([
        torch.einsum("bhwi,bhwo->io", vp[:, dr:dr + H, dc:dc + W], du)
        for dc in range(3)]) for dr in range(3)])
    dv = F.conv_transpose2d(du.permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                            padding=1).permute(0, 2, 3, 1)
    da = dv.to(BF16) if add is not None else None
    if coef_in is None:
        return dv.to(BF16), dw, db, None, da
    tl = torch.where(pre > 0, _rb(_rb(dv) * scale), torch.zeros_like(dv))
    xh_in = _rb(_rb(u - mean_i) * inv_i)
    ps = torch.stack([tl.sum((1, 2)), _rb(tl * xh_in).sum((1, 2))], 1)[:, None]
    return tl.to(BF16), dw, db, ps, da


@functools.lru_cache(maxsize=None)
def _conv_link_bwd_lib():
    """(launch function, output pixels per data-gradient block, the
    weight-gradient pass's number of pixel ranges as a function of
    (B, H, W, Cin, Cout)) of csrc/conv_link_bwd.cu."""
    lib = native.load("conv_link_bwd")
    fn = lib.conv_link_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    splits = lib.conv_link_bwd_splits
    splits.argtypes = [ctypes.c_int] * 5
    splits.restype = ctypes.c_int
    return fn, lib.conv_link_bwd_block_pixels(), splits


def conv_link_bwd(r: torch.Tensor, w: torch.Tensor, u_in: torch.Tensor,
                  u_next: Optional[torch.Tensor] = None,
                  coef_next: Optional[torch.Tensor] = None,
                  coef_in: Optional[torch.Tensor] = None,
                  add: Optional[torch.Tensor] = None,
                  te: Optional[torch.Tensor] = None):
    """The backward of one link (kernel K5 on the card); arguments and
    results as ``conv_link_bwd_plain``, the partials (B, n_blocks, 2, Cin).
    Deterministic: no float atomics; dW and dbias are reduced from
    per-range partials in a fixed order."""
    native.no_autograd("conv_link_bwd", r, w, u_in, u_next, coef_next, coef_in, add, te)
    if r.device.type == "cpu":
        return conv_link_bwd_plain(r, w, u_in, u_next, coef_next, coef_in, add, te)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    B, H, W, cout = r.shape
    cin = u_in.shape[3]
    if (u_next is None) != (coef_next is None) or (te is not None and add is None):
        raise ValueError("u_next and coef_next go together; te requires add")
    if not all(c == 16 or c % 64 == 0 for c in (cin, cout)) or cin == cout == 16:
        raise ValueError(f"the kernel takes channels 16 or 64k, not both 16: {cin}->{cout}")
    expect = [(r, (B, H, W, cout), BF16), (w, (3, 3, cin, cout), BF16),
              (u_in, (B, H, W, cin), BF16)]
    if u_next is not None:
        expect += [(u_next, (B, H, W, cout), BF16), (coef_next, (B, 8, cout), torch.float32)]
    if coef_in is not None:
        expect.append((coef_in, (B, 8, cin), torch.float32))
    if add is not None:
        expect.append((add, (B, H, W, cin), BF16))
    if te is not None:
        expect.append((te, (B, cin), BF16))
    native.check_tensors("conv_link_bwd", expect, r.device)
    native.check_aligned("conv_link_bwd", r, w, u_in)
    lib_fn, bm, splits = _conv_link_bwd_lib()
    dev = r.device
    n_split = splits(B, H, W, cin, cout)
    t_in = torch.empty((B, H, W, cin), dtype=BF16, device=dev)
    da = torch.empty_like(t_in) if add is not None else None
    ps = (torch.empty((B, H * ((W + bm - 1) // bm), 2, cin), dtype=torch.float32, device=dev)
          if coef_in is not None else None)
    # T(u_in) and du as the weight-gradient pass reads them, where they are
    # not u_in and r themselves
    v = torch.empty_like(t_in) if (coef_in is not None or add is not None) else None
    du = torch.empty_like(r) if u_next is not None else None
    dwp = torch.empty((n_split, 9, cin, cout), dtype=torch.float32, device=dev)
    dbp = torch.empty((n_split, cout), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=dev)
    db = torch.empty((cout,), dtype=torch.float32, device=dev)
    flags = ((_B_GN_NEXT if u_next is not None else 0) | (_B_GN_IN if coef_in is not None else 0)
             | (_B_ADD if add is not None else 0) | (_B_TE if te is not None else 0))
    with torch.cuda.device(dev):
        err = lib_fn(_ptr(r), _ptr(w), _ptr(u_in), _ptr(u_next), _ptr(coef_next),
                     _ptr(coef_in), _ptr(add), _ptr(te), _ptr(t_in), _ptr(da), _ptr(v),
                     _ptr(du), _ptr(ps), _ptr(dwp), _ptr(dbp), _ptr(dw), _ptr(db),
                     B, H, W, cin, cout, n_split, flags,
                     torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "conv_link_bwd")
    native.LAUNCHES["conv_link_bwd"] += 1
    return t_in, dw, db, ps, da


def gn_bwd_glue(ps: torch.Tensor, scale: torch.Tensor, invc: torch.Tensor,
                meanc: torch.Tensor, num_groups: int, n_group: int):
    """(sum t, sum t * xhat) per (batch, channel) -> the (B, 8, C)
    coefficients [inv, mean, m1, m2, 0, 0, 0, 0] with which the next link
    up assembles du, and this GroupNorm's (dscale, dbias). t = dy * scale,
    so dscale = sum_b p2 / scale and dbias = sum_b p1 / scale. ``ps`` is
    (B, T, 2, C) from a kernel or (B, 2, C) already combined."""
    if ps.ndim == 4:
        p1, p2 = ps[:, :, 0].sum(1), ps[:, :, 1].sum(1)
    else:
        p1, p2 = ps[:, 0], ps[:, 1]
    B, c = p1.shape
    cg = c // num_groups
    m1 = (p1.reshape(B, num_groups, cg).sum(-1) / n_group).repeat_interleave(cg, -1)
    m2 = (p2.reshape(B, num_groups, cg).sum(-1) / n_group).repeat_interleave(cg, -1)
    scale = scale.float()
    safe = torch.where(scale.abs() < 1e-8, torch.ones_like(scale), scale)
    z = torch.zeros_like(m1)
    coefs = torch.stack([invc, meanc, m1, m2, z, z, z, z], 1).contiguous()
    return coefs, p2.sum(0) / safe, p1.sum(0) / safe


def _coefs(g, scale) -> torch.Tensor:
    """(B, 8, C) [aeff, beff, inv, mean, scale, 0, 0, 0] of one GroupNorm."""
    aeff, beff, inv, mean = g
    z = torch.zeros_like(aeff)
    return torch.stack([aeff, beff, inv, mean, scale.float()[None].expand_as(inv),
                        z, z, z], 1).contiguous()


def chain_bwd_links(p: Params, it: Dict[str, object], t6: torch.Tensor,
                    coefs6: torch.Tensor, dgn3: Tuple[torch.Tensor, torch.Tensor]):
    """Six K5 launches, links 6..1, with ``gn_bwd_glue`` between them,
    given the t-form cotangent t6 of u6 and its coefficients (virtual link
    7). Returns (grads ``{key: (dW or dscale, dbias)}`` in ``p``'s layout,
    d(latent) bf16, d(cond) bf16)."""
    B, H, W, c16 = it["u6"].shape
    c64 = it["u1"].shape[-1]
    c256 = it["u2"].shape[-1]
    n64, n256 = H * W * (c64 // 4), H * W * (c256 // 4)
    g0, g1, g2 = it["g0"], it["g1"], it["g2"]
    grads = {"gn3": dgn3}

    t5, *grads["pr1"], ps5, _ = conv_link_bwd(
        t6, p["pr1"][0], it["u5"], u_next=it["u6"], coef_next=coefs6,
        coef_in=_coefs(g2, p["gn2"][0]))
    coefs5, *grads["gn2"] = gn_bwd_glue(ps5, p["gn2"][0], g2[2], g2[3], 4, n64)
    t4, *grads["pr0"], _, _ = conv_link_bwd(
        t5, p["pr0"][0], it["u4"], u_next=it["u5"], coef_next=coefs5)
    t3, *grads["fb"], _, _ = conv_link_bwd(t4, p["fb"][0], it["u3"])
    t2, *grads["fa"], ps2, dcond = conv_link_bwd(
        t3, p["fa"][0], it["u2"], coef_in=_coefs(g1, p["gn1"][0]), add=it["cond"], te=it["te"])
    coefs2, *grads["gn1"] = gn_bwd_glue(ps2, p["gn1"][0], g1[2], g1[3], 4, n256)
    t1, *grads["ne1"], ps1, _ = conv_link_bwd(
        t2, p["ne1"][0], it["u1"], u_next=it["u2"], coef_next=coefs2,
        coef_in=_coefs(g0, p["gn0"][0]))
    coefs1, *grads["gn0"] = gn_bwd_glue(ps1, p["gn0"][0], g0[2], g0[3], 4, n64)
    t0, *grads["ne0"], _, _ = conv_link_bwd(
        t1, p["ne0"][0], it["x"], u_next=it["u1"], coef_next=coefs1)
    return grads, t0, dcond


def _vlink7(it, scale3, ct):
    """The backward of out = relu(gn3(u6)) in plain PyTorch (16 channels),
    as the JAX package does it in jnp: t6 = relu'(out) * ct * scale in bf16
    arithmetic, its partials, and the glue."""
    u6 = it["u6"]
    B, H, W, c16 = u6.shape
    a6, b6, inv6, mean6 = it["g3"]
    live = finish_eps(u6, a6, b6) > 0
    t6 = torch.where(live, _rb(_rb(ct.float()) * _rb(scale3.float())), torch.zeros_like(u6.float()))
    xh6 = _rb(_rb(u6.float() - _rb(mean6)[:, None, None, :]) * _rb(inv6)[:, None, None, :])
    p6 = torch.stack([t6.sum((1, 2)), _rb(t6 * xh6).sum((1, 2))], 1)
    coefs6, *dgn3 = gn_bwd_glue(p6, scale3, inv6, mean6, 4, H * W * (c16 // 4))
    return t6.to(BF16), coefs6, tuple(dgn3)


# ---------------------------------------------------------------------------
# autograd: the ddim_loss denoiser call and one sampler step
# ---------------------------------------------------------------------------


def chain_params_from_flat(flat) -> Params:
    """f32 leaves in ``CHAIN_KEYS`` order, (weight, bias) each, conv weights
    (3, 3, Cin, Cout) -> the chain's parameters with bf16 conv weights."""
    p = {}
    for i, k in enumerate(CHAIN_KEYS):
        a, b = flat[2 * i], flat[2 * i + 1]
        p[k] = ((a.to(BF16).contiguous(), b.float().contiguous()) if k in CONV_KEYS
                else (a.float(), b.float()))
    return p


def _flat_grads(grads) -> List[torch.Tensor]:
    return [g for k in CHAIN_KEYS for g in grads[k]]


def _dte(dcond: torch.Tensor, te: torch.Tensor) -> torch.Tensor:
    """d(te) is the per-sample spatial sum of d(cond), in f32."""
    return dcond.float().sum((1, 2)).to(te.dtype)


class FusedDenoiser(torch.autograd.Function):
    """eps = ScheduledCNNRefine(lat, cond + te) through the fused chain.

    ``apply(lat, cond, te, *flat)``: lat (B, H, W, 16), cond (B, H, W, C)
    bf16; te (B, C) bf16, one timestep embedding per sample; ``flat`` the
    f32 parameters in ``CHAIN_KEYS`` order. Forward: six K1 launches.
    Backward: the chain recomputed, virtual link 7 in plain PyTorch, six
    K5 launches."""

    @staticmethod
    def forward(ctx, lat, cond, te, *flat):
        it = chain_forward(chain_params_from_flat(flat), lat, cond, te, conv_link_direct)
        ctx.save_for_backward(lat, cond, te, *flat)
        return finish_eps(it["u6"], *it["g3"][:2])

    @staticmethod
    def backward(ctx, ct):
        lat, cond, te, *flat = ctx.saved_tensors
        p = chain_params_from_flat(flat)
        it = chain_forward(p, lat, cond, te, conv_link_direct)
        t6, coefs6, dgn3 = _vlink7(it, p["gn3"][0], ct)
        grads, dlat, dcond = chain_bwd_links(p, it, t6, coefs6, dgn3)
        return (dlat, dcond, _dte(dcond, te), *_flat_grads(grads))


class FusedSamplerStep(torch.autograd.Function):
    """One DDIM sampler step, denoiser chain + update:
    (x_f32, x_bf16) -> (x'_f32, x'_bf16).

    ``apply(x_f32, x_bf16, cond, te, sched, *flat)``; sched (4,) f32
    [sa, sb, sp, sq]; the rest as ``FusedDenoiser``. Valid for epsilon
    prediction without clipping, eta 0. Forward: six K1 launches and K2.
    Backward: the chain recomputed from the saved bf16 latent, K6, the
    glue and six K5 launches. The gradient reaches both latent copies:
    dx_f32 from K6, link 1's d(latent) to the bf16 copy."""

    @staticmethod
    def forward(ctx, x_f32, x_bf16, cond, te, sched, *flat):
        p = chain_params_from_flat(flat)
        it = chain_forward(p, x_bf16, cond, te, conv_link_direct)
        ctx.save_for_backward(x_bf16, cond, te, sched, *flat)
        return sched_step(it["u6"], it["g3"][0], it["g3"][1], x_f32, sched)

    @staticmethod
    def backward(ctx, dxp, dxpb):
        x_bf16, cond, te, sched, *flat = ctx.saved_tensors
        p = chain_params_from_flat(flat)
        it = chain_forward(p, x_bf16, cond, te, conv_link_direct)
        if dxp is None:
            dxp = torch.zeros(x_bf16.shape, dtype=torch.float32, device=x_bf16.device)
        g3 = it["g3"]
        dx, t6, ps6 = sched_bwd(dxp.contiguous(), None if dxpb is None else dxpb.contiguous(),
                                it["u6"], _coefs(g3, p["gn3"][0]), sched)
        B, H, W, c16 = x_bf16.shape
        coefs6, *dgn3 = gn_bwd_glue(ps6, p["gn3"][0], g3[2], g3[3], 4, H * W * (c16 // 4))
        grads, dlat, dcond = chain_bwd_links(p, it, t6, coefs6, tuple(dgn3))
        return (dx, dlat, dcond, _dte(dcond, te), None, *_flat_grads(grads))
