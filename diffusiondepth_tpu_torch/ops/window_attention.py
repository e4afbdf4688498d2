"""Swin window attention fed straight from the qkv Dense output, and its
backward.

Port of the fused-input attention of ``diffusiondepth_tpu/ops/window_attention.py``
(``window_attention_qkv_pallas``, kernels ``_qkv_kernel_masked/_nomask``,
and ``window_attention_qkv_bwd_pallas``, kernels
``_qkv_bwd_kernel_masked/_nomask``). ``window_attention`` launches the CUDA
kernel ``csrc/window_attention.cu`` (K4) and ``window_attention_bwd`` the
kernel ``csrc/window_attention_bwd.cu`` (K7) on a CUDA tensor; both run
their plain versions on a CPU tensor. In bf16 both run on the tensor-core
core of ``csrc/window_attention_sm90.cuh``; in f32 on FMA kernels exact to
f32 summation order. ``WindowAttentionQKV`` is the
``torch.autograd.Function`` the Swin blocks call.

``window_attention_split`` is the port of the v2 attention on split q/k/v
(``window_attention_pallas``, kernels ``_kernel_masked/_kernel_nomask``):
the CUDA kernel ``csrc/window_attention_split.cu`` (K8) on the card, its
plain version on the CPU. The Swin blocks take it with ``use_pallas`` at
eval.

``window_attention`` and ``window_attention_split`` run through
``torch.library`` operators (``ops/library.py``, CUDA implementations
``window_attention_cuda`` and ``window_attention_split_cuda``), so that
``torch.export`` can trace the Swin blocks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import native
from .native import to_device

HEAD_DIM = 32
MAX_TOKENS = 64
# K7's bf16 grid: the H100 SXM's SMs times the blocks its __launch_bounds__
# keeps resident on each. Constants, not the card's answer, so that the
# dbias partition is a pure function of the shapes.
BWD_SMS = 132
BWD_BLOCKS_PER_SM = 4


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], scale: float,
                           num_heads: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.

    qkv (B, nW, N, 3C), channel order [q|k|v] x [head] x [d]; bias (H, N, N)
    and mask (nW, N, N) in f32. ``q * scale`` is rounded to the input type
    (scale too), logits and softmax are f32, the probabilities are rounded to
    the input type before P.v, and P.v accumulates in f32. This is
    ``window_attention_qkv_reference`` with f32 logits, as the TPU kernel
    computes them.
    """
    b, nw, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dt = qkv.dtype
    q6 = qkv.reshape(b, nw, n, 3, num_heads, d)
    sc = to_device(scale, qkv.device, dt)
    q = (q6[..., 0, :, :] * sc).float()
    k = q6[..., 1, :, :].float()
    v = q6[..., 2, :, :].float()
    attn = torch.einsum("bwqhd,bwkhd->bwhqk", q, k)
    attn = attn + bias.float()[None, None]
    if mask is not None:
        attn = attn + mask.float()[None, :, None]
    attn = torch.softmax(attn, dim=-1).to(dt).float()
    out = torch.einsum("bwhqk,bwkhd->bwqhd", attn, v)
    return out.reshape(b, nw, n, c).to(dt)


def window_attention_einsum(qkv: torch.Tensor, bias: torch.Tensor,
                            mask: Optional[torch.Tensor], scale: float,
                            num_heads: int, keep: Optional[torch.Tensor] = None,
                            rate: float = 0.0) -> torch.Tensor:
    """The JAX ``WindowMSA`` einsum path (``use_pallas`` training,
    ``fused_qkv_attention=False``, attention dropout), differentiable, in
    plain PyTorch: no kernel, as JAX leaves it to XLA. qkv (B, nW, N, 3C)
    -> (B, nW, N, C). Its rounding points are not K4's: ``q * scale``, the
    logits and the bias and mask adds are in the input type, the softmax in
    f32, and the probabilities go back to the input type before P.v.
    ``keep`` (B, nW, heads, N, N) bool: attention dropout at ``rate``, the
    kept probabilities scaled by 1 / (1 - rate) in the input type, as
    flax's ``Dropout``."""
    b, nw, n, c3 = qkv.shape
    c = c3 // 3
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, nw, n, 3, num_heads, c // num_heads).unbind(3)
    q = q * to_device(scale, qkv.device, dt)
    attn = torch.einsum("bwqhd,bwkhd->bwhqk", q, k) + bias.to(dt)[None, None]
    if mask is not None:
        attn = attn + mask.to(dt)[None, :, None]
    attn = torch.softmax(attn.float(), dim=-1).to(dt)
    if keep is not None:
        attn = torch.where(keep, attn / (1.0 - rate), torch.zeros_like(attn))
    return torch.einsum("bwhqk,bwkhd->bwqhd", attn, v).reshape(b, nw, n, c)


def _check(qkv, bias, mask, num_heads, dout=None):
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    b, nw, n, c3 = qkv.shape
    c = c3 // 3
    if c3 % 3 or c != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}: C={c}, heads={num_heads}")
    if n > MAX_TOKENS:
        raise ValueError(f"the kernel takes at most {MAX_TOKENS} tokens per window, got {n}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if bias.shape != (num_heads, n, n) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be f32 {(num_heads, n, n)}, got {bias.dtype} {tuple(bias.shape)}")
    if mask is not None and (mask.shape != (nw, n, n) or mask.dtype != torch.float32):
        raise ValueError(f"mask must be f32 {(nw, n, n)}, got {mask.dtype} {tuple(mask.shape)}")
    if dout is not None and (dout.shape != (b, nw, n, c) or dout.dtype != qkv.dtype):
        raise ValueError(f"dout must be {qkv.dtype} {(b, nw, n, c)}, got {dout.dtype} "
                         f"{tuple(dout.shape)}")
    for t in (qkv, bias, mask, dout):
        if t is not None and (not t.is_contiguous() or t.device != qkv.device):
            raise ValueError("qkv, bias, mask and dout must be contiguous on one device")
    if qkv.dtype == torch.bfloat16:  # the tensor-core kernels' 16-byte cp.async rows
        native.check_aligned("window attention", *(t for t in (qkv, dout) if t is not None))


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = native.load("window_attention").window_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], scale: float,
                     num_heads: int) -> torch.Tensor:
    """qkv (B, nW, N, 3C) -> (B, nW, N, C) through the operator
    ``diffusiondepth::window_attention`` (``ops/library.py``): the CUDA
    kernel on the card, the plain version for a CPU tensor."""
    native.no_autograd("window_attention", qkv, bias, mask)
    native.check_device(qkv)
    return torch.ops.diffusiondepth.window_attention.default(qkv, bias, mask, float(scale),
                                                             int(num_heads))


def window_attention_cuda(qkv, bias, mask, scale, num_heads):
    """K4's launch on CUDA tensors (the operator's CUDA implementation)."""
    _check(qkv, bias, mask, num_heads)
    b, nw, n, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, nw, n, c), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):  # the launch goes to the current device
        err = _launch_fn()(qkv.data_ptr(), bias.data_ptr(),
                           mask.data_ptr() if mask is not None else None, out.data_ptr(),
                           b, nw, n, c, num_heads, float(scale),
                           1 if qkv.dtype == torch.bfloat16 else 0,
                           torch.cuda.current_stream(qkv.device).cuda_stream)
    native.check(err, "window_attention")
    native.LAUNCHES["window_attention"] += 1
    return out


def window_attention_bwd_plain(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor], dout: torch.Tensor,
                               scale: float, num_heads: int):
    """The backward kernel's arithmetic in plain PyTorch, following the JAX
    kernel's ``_qkv_bwd_core``: P recomputed in f32 as the forward does
    (q * scale rounded to the input type), then dV = P^ dO with P^ = P in
    the input type, dP = dO V^T, dS = P (dP - rowsum(dP P)) in f32,
    dQ = S^ K scale and dK = S^T Q scale with S^ = dS in the input type,
    all products accumulated in f32. Returns dqkv (B, nW, N, 3C) in the
    input type and dbias (H, N, N) f32, the sum of dS over batch and
    windows. The mask gets no gradient."""
    b, nw, n, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dt = qkv.dtype
    q6 = qkv.reshape(b, nw, n, 3, num_heads, d)
    sc = to_device(scale, qkv.device, dt)
    qs = (q6[..., 0, :, :] * sc).float()
    q, k, v = (q6[..., i, :, :].float() for i in range(3))
    attn = torch.einsum("bwqhd,bwkhd->bwhqk", qs, k) + bias.float()[None, None]
    if mask is not None:
        attn = attn + mask.float()[None, :, None]
    p = torch.softmax(attn, dim=-1)
    p_lo = p.to(dt).float()
    do = dout.reshape(b, nw, n, num_heads, d).float()
    dv = torch.einsum("bwhqk,bwqhd->bwkhd", p_lo, do)
    dp = torch.einsum("bwqhd,bwkhd->bwhqk", do, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds_lo = ds.to(dt).float()
    dq = torch.einsum("bwhqk,bwkhd->bwqhd", ds_lo, k) * scale
    dk = torch.einsum("bwhqk,bwqhd->bwkhd", ds_lo, q) * scale
    dqkv = torch.stack([dq, dk, dv], dim=3).reshape(b, nw, n, c3).to(dt)
    return dqkv, ds.sum((0, 1))


def window_attention_bwd_splits(b: int, nw: int, heads: int) -> int:
    """Blocks per head of K7's bf16 kernel, and so its dbias partials: enough
    blocks over all heads to fill the card's resident slots once
    (``BWD_SMS * BWD_BLOCKS_PER_SM``), at most one per window. A pure
    function of the shapes: the wrapper sizes ``part`` (splits, heads, N, N)
    with it and passes it to the kernel, whose block s of each head walks
    windows (index b * nW + w) [s n / S, (s + 1) n / S) of the n = b * nW,
    in order, summing dS into its partial s; the partials are then summed
    in the order of s."""
    return max(1, min(b * nw, -(-BWD_SMS * BWD_BLOCKS_PER_SM // heads)))


@functools.lru_cache(maxsize=None)
def _bwd_launch_fn():
    fn = native.load("window_attention_bwd").window_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def window_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor], dout: torch.Tensor,
                         scale: float, num_heads: int):
    """(dqkv, dbias) of ``window_attention``: the CUDA kernel
    ``csrc/window_attention_bwd.cu`` on the card, the plain version for a
    CPU tensor. dbias is reduced from per-block partials (bf16: one per
    ``window_attention_bwd_splits`` block of each head; f32: one per
    window) in a fixed order, so two launches on the same inputs give the
    same bits."""
    native.no_autograd("window_attention_bwd", qkv, bias, mask, dout)
    if qkv.device.type == "cpu":
        return window_attention_bwd_plain(qkv, bias, mask, dout, scale, num_heads)
    _check(qkv, bias, mask, num_heads, dout)
    b, nw, n, c3 = qkv.shape
    dqkv = torch.empty_like(qkv)
    bf16 = qkv.dtype == torch.bfloat16
    splits = window_attention_bwd_splits(b, nw, num_heads) if bf16 else nw
    part = torch.empty((splits, num_heads, n, n), dtype=torch.float32, device=qkv.device)
    dbias = torch.empty((num_heads, n, n), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _bwd_launch_fn()(qkv.data_ptr(), bias.data_ptr(),
                               mask.data_ptr() if mask is not None else None,
                               dout.data_ptr(), dqkv.data_ptr(), part.data_ptr(),
                               dbias.data_ptr(), b, nw, n, c3 // 3, num_heads, splits,
                               float(scale), 1 if bf16 else 0,
                               torch.cuda.current_stream(qkv.device).cuda_stream)
    native.check(err, "window_attention_bwd")
    native.LAUNCHES["window_attention_bwd"] += 1
    return dqkv, dbias


class WindowAttentionQKV(torch.autograd.Function):
    """Differentiable ``window_attention``: forward K4, backward K7. Saves
    qkv (and the bias and mask) only: the probabilities are recomputed in
    the backward. ``apply(qkv, bias, mask, scale, num_heads)``."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, scale, num_heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.scale, ctx.num_heads = scale, num_heads
        return window_attention(qkv, bias, mask, scale, num_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, mask = ctx.saved_tensors
        dqkv, dbias = window_attention_bwd(qkv, bias, mask, dout.contiguous(),
                                           ctx.scale, ctx.num_heads)
        return dqkv, dbias.to(bias.dtype), None, None, None


def window_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor, mask: Optional[torch.Tensor],
                                 scale: float) -> torch.Tensor:
    """K8's arithmetic in plain PyTorch, following the JAX kernel's
    ``_attn_core``: q, k, v (B, nW, H, N, D), bias (H, N, N) f32, mask
    (nW, N, N) f32 or None. ``q * scale`` is rounded to the input type
    (scale too), logits and softmax are f32, the probabilities are rounded
    to the input type before P.v, and P.v accumulates in f32. Returns
    (B, nW, H, N, D) in the input type."""
    dt = q.dtype
    sc = to_device(scale, q.device, dt)
    attn = torch.einsum("bwhnd,bwhmd->bwhnm", (q * sc).float(), k.float())
    attn = attn + bias.float()[None, None]
    if mask is not None:
        attn = attn + mask.float()[None, :, None]
    p = torch.softmax(attn, dim=-1).to(dt).float()
    return torch.einsum("bwhnm,bwhmd->bwhnd", p, v.float()).to(dt)


def _check_split(q, k, v, bias, mask):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, nw, h, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {d}")
    if n > MAX_TOKENS:
        raise ValueError(f"the kernel takes at most {MAX_TOKENS} tokens per window, got {n}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must be {q.dtype} {tuple(q.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError("q, k and v need a unit stride along D, on one device")
    if bias.shape != (h, n, n) or bias.dtype != torch.float32:
        raise ValueError(f"bias must be f32 {(h, n, n)}, got {bias.dtype} {tuple(bias.shape)}")
    if mask is not None and (mask.shape != (nw, n, n) or mask.dtype != torch.float32):
        raise ValueError(f"mask must be f32 {(nw, n, n)}, got {mask.dtype} {tuple(mask.shape)}")
    for t in (bias, mask):
        if t is not None and (not t.is_contiguous() or t.device != q.device):
            raise ValueError("bias and mask must be contiguous on q's device")
    if q.dtype == torch.bfloat16:  # the tensor-core kernel's 16-byte cp.async rows
        native.check_aligned("window_attention_split", q, k, v)
        if any(s % 8 for t in (q, k, v) for s in t.stride()[:4]):
            raise ValueError("bf16 q, k and v need strides that are multiples of 8 elements")


@functools.lru_cache(maxsize=None)
def _split_launch_fn():
    fn = native.load("window_attention_split").window_attention_split_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def window_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: Optional[torch.Tensor],
                           scale: float) -> torch.Tensor:
    """softmax(round(q * scale) k^T + bias [+ mask]) v on q, k, v (B, nW, H,
    N, D), each read with its own strides (unit stride along D), through
    the operator ``diffusiondepth::window_attention_split``
    (``ops/library.py``): the CUDA kernel on the card, the plain version
    for a CPU tensor. Returns a contiguous (B, nW, H, N, D) tensor in the
    input type."""
    native.no_autograd("window_attention_split", q, k, v, bias, mask)
    native.check_device(q)
    return torch.ops.diffusiondepth.window_attention_split.default(q, k, v, bias, mask,
                                                                   float(scale))


def window_attention_split_cuda(q, k, v, bias, mask, scale):
    """K8's launch on CUDA tensors (the operator's CUDA implementation)."""
    _check_split(q, k, v, bias, mask)
    b, nw, h, n, d = q.shape
    out = torch.empty((b, nw, h, n, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:4]]
    with torch.cuda.device(q.device):
        err = _split_launch_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                 mask.data_ptr() if mask is not None else None, out.data_ptr(),
                                 *strides, b, nw, h, n, float(scale),
                                 1 if q.dtype == torch.bfloat16 else 0,
                                 torch.cuda.current_stream(q.device).cuda_stream)
    native.check(err, "window_attention_split")
    native.LAUNCHES["window_attention_split"] += 1
    return out
