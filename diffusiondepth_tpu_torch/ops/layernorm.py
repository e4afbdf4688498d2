"""Last-dim LayerNorm with bf16 traffic and f32 statistics, and its
backward.

Port of ``diffusiondepth_tpu/ops/layernorm.py``: ``layernorm_fwd`` launches
the Triton kernel K9 (``csrc/layernorm.py``) and ``layernorm_bwd`` the CUDA
kernel K10 (``csrc/layernorm_bwd.cu``, planned by ``layernorm_bwd_plan``)
on a CUDA tensor; both run their plain versions, the JAX package's
``_ln_jnp_fwd`` / ``_ln_jnp_bwd``, on a CPU tensor. ``LayerNormBF16`` is
the counterpart of the ``layernorm_bf16`` custom_vjp: forward K9, backward
K10, with the input and the per-row (mean, inv) as residuals.
``models/common.py::LayerNorm`` calls it under the bf16 policy.

Like JAX's ``layernorm_bf16``, every (M, C) with M, C >= 1 runs on the
kernels: K9 masks any C and loops over the columns of rows wider than it
holds; K10 takes a row pitch of ``ceil8(C)`` (the wrapper stages x and dy
into zero-padded rows when C % 8 != 0) and a second variant for rows wider
than its ring holds. ``LayerNormBF16`` copies an input that does not start
on 16 bytes; the raw ``layernorm_bwd`` refuses one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import native

BF16 = torch.bfloat16

# K10's block (csrc/layernorm_bwd.cu): 8 consumer warps and one producer
# warp; its shared memory: 256 bytes of mbarriers, the ring, the (2, C)
# slots of the block's dscale/dbias fold, 128 bytes of cross-warp row sums
LN_BWD_CONSUMERS = 256
LN_BWD_SMEM_LIMIT = 232448  # the H100's 227 KB per block
_LN_BWD_BAR_BYTES, _LN_BWD_MSUM_BYTES = 256, 128
_LN_BWD_MAX_STAGES = 16
_LN_BWD_STAGE_BYTES = 16384  # a stage holds at least one row per group, else ~16 KB
_LN_BWD_RING_BYTES = 81920  # the ring: ~75 KB of x and dy in flight per SM
LN_BWD_RING_MAX_PITCH = 4096  # a row in at most 4 vectors of 8 on 128 threads
LN_BWD_WIDE_THREADS = 512  # the wide variant's block, all on one row


def layernorm_fwd_plain(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (M, C) -> (y (M, C) in x2's type, mean (M,) f32, inv (M,) f32),
    statistics and normalisation in f32."""
    xf = x2.float()
    c = x2.shape[-1]
    mean = xf.sum(-1) / c
    d = xf - mean[:, None]
    var = (d * d).sum(-1) / c
    inv = torch.rsqrt(var + eps)
    y = d * inv[:, None] * scale.float() + bias.float()
    return y.to(x2.dtype), mean, inv


def layernorm_bwd_plain(x2: torch.Tensor, dy2: torch.Tensor, mean: torch.Tensor,
                        inv: torch.Tensor, scale: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (dx (M, C) in x2's type, dscale (C,) f32, dbias (C,) f32), with
    xhat recomputed from x2, mean and inv."""
    xf = x2.float()
    dyf = dy2.float()
    c = x2.shape[-1]
    xhat = (xf - mean[:, None]) * inv[:, None]
    t = dyf * scale.float()
    m1 = t.sum(-1) / c
    m2 = (t * xhat).sum(-1) / c
    dx = (t - m1[:, None] - xhat * m2[:, None]) * inv[:, None]
    return dx.to(x2.dtype), (dyf * xhat).sum(0), dyf.sum(0)


def _check_size(kernel: str, m: int, c: int) -> None:
    if m < 1 or c < 1:
        raise ValueError(f"{kernel}: needs M >= 1 and C >= 1, got ({m}, {c})")


def layernorm_fwd(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2 (M, C) bf16, scale and bias (C,) f32 -> (y (M, C) bf16, mean (M,)
    f32, inv (M,) f32): kernel K9 on the card (any M, C >= 1), the plain
    version for a CPU tensor."""
    native.no_autograd("layernorm_fwd", x2, scale, bias)
    if x2.device.type == "cpu":
        return layernorm_fwd_plain(x2, scale, bias, eps)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    m, c = x2.shape
    _check_size("layernorm_fwd", m, c)
    native.check_tensors("layernorm_fwd", ((x2, (m, c), BF16), (scale, (c,), torch.float32),
                                           (bias, (c,), torch.float32)), x2.device)
    y = torch.empty_like(x2)
    mean = torch.empty(m, dtype=torch.float32, device=x2.device)
    inv = torch.empty(m, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        native.triton_module("layernorm").fwd_launch(x2, scale, bias, float(eps), y, mean, inv)
    native.LAUNCHES["layernorm_fwd"] += 1
    return y, mean, inv


class LayerNormBwdPlan(NamedTuple):
    """How K10 splits an (M, C) backward. Rows of x, dy and dx lie
    ``pitch`` = ceil8(C) bf16 apart (C itself when C % 8 == 0). Block b
    takes rows ``row_ranges[b]`` (contiguous, in order).

    ``variant`` "ring" (pitch <= ``LN_BWD_RING_MAX_PITCH``):
    ``threads_per_row`` threads (a power of two) share a row, each owning
    ``vectors_per_thread`` 16-byte vectors of 8 columns (``warps_per_row``
    = threads_per_row / 32 warps for a row wider than a warp), so the
    block's 256 consumer threads take 256 / threads_per_row rows at a time.
    The ring has ``stages`` stages of ``rows_per_stage`` rows of x and of
    dy, ``stage_bytes`` each: x at offset 0, dy at ``dy_offset``, then the
    rows' mean and inv, from ``ring_offset`` of the block's ``smem_bytes``
    of shared memory.

    ``variant`` "wide": the block's ``threads_per_row`` =
    ``LN_BWD_WIDE_THREADS`` threads take one row at a time, each
    ``vectors_per_thread`` vectors of it, in two passes from global memory;
    no ring (rows_per_stage 1; stages, offsets and shared-memory bytes 0).

    The workspace of dscale/dbias partials is (ctas, 2, pitch) f32."""

    ctas: int
    row_ranges: Tuple[Tuple[int, int], ...]
    rows_per_stage: int
    stages: int
    threads_per_row: int
    vectors_per_thread: int
    ring_offset: int
    stage_bytes: int
    dy_offset: int
    smem_bytes: int
    pitch: int
    variant: str

    @property
    def warps_per_row(self) -> float:
        return self.threads_per_row / 32


def layernorm_bwd_pitch(c: int) -> int:
    """K10's row pitch for width ``c``: the multiple of 8 bf16 (16 bytes)
    at or above it."""
    return -(-c // 8) * 8


def layernorm_bwd_smem_bytes(r: int, s: int, c: int, tpr: int) -> int:
    """K10's shared memory for ``s`` stages of ``r`` rows of pitch ``c`` at
    ``tpr`` threads per row: mbarriers, the ring (x, dy, then each row's
    mean and inv, padded to 16 bytes), the block's (2, c) fold slots (one
    per row group of 32+ threads, else one per warp) and the cross-warp
    row sums. ``csrc/layernorm_bwd.cu::smem_bytes`` lays it out the same."""
    stage = 4 * r * c + 8 * (-(-r // 4) * 4)
    slots = LN_BWD_CONSUMERS // tpr if tpr >= 32 else LN_BWD_CONSUMERS // 32
    return _LN_BWD_BAR_BYTES + s * stage + slots * 8 * c + _LN_BWD_MSUM_BYTES


@functools.lru_cache(maxsize=256)
def layernorm_bwd_plan(m: int, c: int, sms: int = 132) -> LayerNormBwdPlan:
    """K10's split of an (m, c) backward over ``sms`` SMs: one block per SM
    (at most one per row), each on a contiguous run of rows. Pitch p =
    ceil8(c). Up to p = 4096 the ring: threads per row the power of two
    whose ceil(p / 8 / threads) <= 4 vectors per thread leave the fewest
    columns idle (3 vectors of 8 at every Swin width, none idle); rows per
    stage a multiple of the rows the block takes at a time, at least ~16
    KB; as many stages as fit ~75 KB, at least 2, no more than the largest
    block needs. Wider: the wide variant. Raises ``ValueError`` unless m,
    c >= 1; every such shape has a plan. A pure function of the shapes,
    mirrored by the layout of ``csrc/layernorm_bwd.cu``, which refuses
    another."""
    if m < 1 or c < 1:
        raise ValueError(f"layernorm_bwd: needs M >= 1 and C >= 1, got ({m}, {c})")
    p = layernorm_bwd_pitch(c)
    nv = p // 8
    ctas = min(sms, m)
    q, rem = divmod(m, ctas)
    ranges = tuple((b * q + min(b, rem), (b + 1) * q + min(b + 1, rem)) for b in range(ctas))
    if p > LN_BWD_RING_MAX_PITCH:
        return LayerNormBwdPlan(ctas, ranges, 1, 0, LN_BWD_WIDE_THREADS,
                                -(-nv // LN_BWD_WIDE_THREADS), 0, 0, 0, 0, p, "wide")
    tpr, vpt = min(((t, -(-nv // t)) for t in (1, 2, 4, 8, 16, 32, 64, 128)
                    if -(-nv // t) <= 4), key=lambda tv: (tv[0] * tv[1] - nv, tv[0]))
    groups = LN_BWD_CONSUMERS // tpr
    rows_max = q + (rem > 0)
    per_group = max(1, min(_LN_BWD_STAGE_BYTES // (groups * 4 * p), -(-rows_max // groups)))
    r = groups * per_group
    stage = 4 * r * p + 8 * (-(-r // 4) * 4)
    s = max(2, min(_LN_BWD_MAX_STAGES, _LN_BWD_RING_BYTES // stage, -(-rows_max // r)))
    smem = layernorm_bwd_smem_bytes(r, s, p, tpr)
    # p <= 4096: at most two rows of 16 KB a stage, 64 KB of fold slots
    assert smem <= LN_BWD_SMEM_LIMIT, (m, c, smem)
    return LayerNormBwdPlan(ctas, ranges, r, s, tpr, vpt, _LN_BWD_BAR_BYTES, stage, 2 * r * p,
                            smem, p, "ring")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _bwd_launch_fn():
    fn = native.load("layernorm_bwd").layernorm_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def layernorm_bwd_launch(plan: LayerNormBwdPlan, x2: torch.Tensor, dy2: torch.Tensor,
                         mean: torch.Tensor, inv: torch.Tensor, scale: torch.Tensor, c: int,
                         dx: torch.Tensor, dsdb: torch.Tensor, part: torch.Tensor) -> int:
    """One call of K10's C launch function under ``plan``: x2, dy2 and dx
    (M, pitch) bf16, dsdb (2, pitch) and part (ctas, 2, pitch) f32, on the
    current stream. Returns the CUDA error code."""
    m, p = x2.shape
    return _bwd_launch_fn()(x2.data_ptr(), dy2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                            scale.data_ptr(), dx.data_ptr(), dsdb.data_ptr(),
                            dsdb.data_ptr() + 4 * p, part.data_ptr(), m, c, p,
                            int(plan.variant == "wide"), plan.ctas, plan.rows_per_stage,
                            plan.stages, plan.threads_per_row, plan.smem_bytes,
                            torch.cuda.current_stream().cuda_stream)


def layernorm_bwd(x2: torch.Tensor, dy2: torch.Tensor, mean: torch.Tensor,
                  inv: torch.Tensor, scale: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx (M, C) bf16, dscale (C,) f32, dbias (C,) f32) of ``layernorm_fwd``
    for dy2 (M, C) bf16: kernel K10 on the card (any M, C >= 1), the plain
    version for a CPU tensor. When C % 8 == 0, x2 and dy2 must start on
    16-byte boundaries (K10 reads their rows in place); otherwise they are
    staged into zero-padded rows of ceil8(C), and dx is cut back to C.
    dscale and dbias are reduced from per-block partials in a fixed order,
    so two launches on the same inputs give the same bits."""
    native.no_autograd("layernorm_bwd", x2, dy2, mean, inv, scale)
    if x2.device.type == "cpu":
        return layernorm_bwd_plain(x2, dy2, mean, inv, scale)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    m, c = x2.shape
    _check_size("layernorm_bwd", m, c)
    native.check_tensors("layernorm_bwd", ((x2, (m, c), BF16), (dy2, (m, c), BF16),
                                           (mean, (m,), torch.float32),
                                           (inv, (m,), torch.float32),
                                           (scale, (c,), torch.float32)), x2.device)
    plan = layernorm_bwd_plan(m, c, _sm_count(x2.device.index))
    p = plan.pitch
    if p == c:
        native.check_aligned("layernorm_bwd", x2, dy2)
    else:  # zero columns up to the pitch: dy = 0 there adds nothing
        x2, dy2 = F.pad(x2, (0, p - c)), F.pad(dy2, (0, p - c))
    dx = torch.empty_like(x2)
    dsdb = torch.empty((2, p), dtype=torch.float32, device=x2.device)
    part = torch.empty((plan.ctas, 2, p), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        err = layernorm_bwd_launch(plan, x2, dy2, mean, inv, scale, c, dx, dsdb, part)
    native.check(err, "layernorm_bwd")
    native.LAUNCHES["layernorm_bwd"] += 1
    if p != c:
        dx = dx[:, :c].contiguous()
    ds, db = dsdb[:, :c].unbind(0)
    return dx, ds, db


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), or a copy of it when its data does not start on
    16 bytes, as K10 reads rows of a multiple of 8 columns in place."""
    return t.clone() if t.data_ptr() % 16 else t


class LayerNormBF16(torch.autograd.Function):
    """Differentiable last-dim LayerNorm of a bf16 input: forward K9,
    backward K10, at any shape and storage offset (an input or cotangent
    that does not start on 16 bytes is copied first). Saves the (M, C)
    input, the per-row mean and inv and the scale; the cotangent is cast
    to bf16 before K10, as the JAX custom_vjp does. ``apply(x, scale,
    bias, eps)`` with x bf16 and scale, bias (C,) f32; returns bf16 of x's
    shape."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x2 = _aligned(x.reshape(-1, x.shape[-1]).contiguous())
        y, mean, inv = layernorm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, mean, inv, scale)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, mean, inv, scale = ctx.saved_tensors
        dy2 = _aligned(dy.reshape(x2.shape).to(x2.dtype).contiguous())
        dx, ds, db = layernorm_bwd(x2, dy2, mean, inv, scale)
        return dx.reshape(dy.shape), ds.to(scale.dtype), db.to(scale.dtype), None
