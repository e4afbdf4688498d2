"""Swin window attention fed straight from the qkv Dense output.

Port of the fused-input attention of ``diffusiondepth_tpu/ops/window_attention.py``
(``window_attention_qkv_pallas``, kernels ``_qkv_kernel_masked/_nomask``).
``window_attention`` launches the CUDA kernel ``csrc/window_attention.cu``
on a CUDA tensor and runs ``window_attention_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import native

HEAD_DIM = 32
MAX_TOKENS = 64


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
    sc = torch.tensor(scale, dtype=dt, device=qkv.device)
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
    """qkv (B, nW, N, 3C) -> (B, nW, N, C): the CUDA kernel on the card,
    the plain version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, mask, scale, num_heads)
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
    for t in (qkv, bias) + ((mask,) if mask is not None else ()):
        if not t.is_contiguous() or t.device != qkv.device:
            raise ValueError("qkv, bias and mask must be contiguous on one device")
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
