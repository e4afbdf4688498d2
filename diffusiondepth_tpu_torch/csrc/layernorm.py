"""Last-dim LayerNorm with bf16 traffic and f32 statistics as Triton
kernels: K9 (forward) and K10 (backward) of the port.

K9 replaces the TPU kernel diffusiondepth_tpu/ops/layernorm.py
_ln_fwd_kernel (reached through layernorm_fwd_pallas). Per row of x (M, C)
bf16, in f32:

    mean = sum(x) / C,  var = sum((x - mean)^2) / C,  inv = rsqrt(var + eps)
    y    = (x - mean) * inv * scale + bias          (stored as bf16)

and mean, inv (M,) f32 for the backward.

K10 replaces _ln_bwd_kernel (reached through layernorm_bwd_pallas). Per
row, with xhat = (x - mean) * inv recomputed and t = dy * scale:

    dx = (t - mean(t) - xhat * mean(t * xhat)) * inv      (stored as bf16)

and over all rows dscale = sum(dy * xhat), dbias = sum(dy), f32. The TPU
kernel carries those two sums across its sequential grid; Hopper blocks run
in no order, so each program of ``ln_bwd_kernel`` walks a fixed set of row
blocks and writes its own (2, C) partial, and ``ln_reduce_kernel`` sums the
partials in a fixed order: two launches on the same inputs give the same
bits. Neither kernel rounds to bf16 before its stores.

What bounds them on the H100: bytes. K9 reads 2 B and writes 2 B per
element (plus 8 B per row); K10 reads 4 B and writes 2 B per element. At
the Swin-L stage-0 norm of a 352x906 batch of 4, (79904, 192), that is
~61 MB for K9 (~18 us at 3.35 TB/s) and ~92 MB for K10 (~27 us).

What the design does about it: one pass over the rows, each byte once,
with the statistics on registers. A program holds ROWS rows of
BLOCK_C = next_pow2(C) columns (masked past C), so up to C = 3072
(PatchMerging's 4 x 768) a row never leaves the program. K10's programs
are a number fixed by M (at most ``MAX_PROGRAMS``, at least ``MIN_ROWS``
rows each), so its partials stay small and the reduce is short.

Loaded by ``diffusiondepth_tpu_torch.ops.layernorm`` only when it launches
a kernel: it imports triton, which only the machine with the card has.
"""

import triton
import triton.language as tl

MAX_PROGRAMS = 528  # K10 programs: 4 per SM of an H100
MIN_ROWS = 16  # K10 rows per program at least, so the partials stay small


def _shape(c: int, tile: int):
    """(BLOCK_C, ROWS, num_warps) for row blocks of about ``tile`` f32
    elements: 16 per thread and live array."""
    block_c = triton.next_power_of_2(c)
    rows = max(1, tile // block_c)
    return block_c, rows, 8 if rows * block_c >= 4096 else 4


@triton.jit
def ln_fwd_kernel(x_ptr, scale_ptr, bias_ptr, y_ptr, mean_ptr, inv_ptr, M, C, eps,
                  BLOCK_C: tl.constexpr, ROWS: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_C)
    rm = rows < M
    cm = cols < C
    m = rm[:, None] & cm[None, :]
    offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / C
    d = tl.where(m, x - mean[:, None], 0.0)
    var = tl.sum(d * d, axis=1) / C
    inv = tl.rsqrt(var + eps)
    s = tl.load(scale_ptr + cols, mask=cm, other=0.0)
    b = tl.load(bias_ptr + cols, mask=cm, other=0.0)
    y = d * inv[:, None] * s[None, :] + b[None, :]
    tl.store(y_ptr + offs, y.to(tl.bfloat16), mask=m)
    tl.store(mean_ptr + rows, mean, mask=rm)
    tl.store(inv_ptr + rows, inv, mask=rm)


@triton.jit
def ln_bwd_kernel(x_ptr, dy_ptr, mean_ptr, inv_ptr, scale_ptr, dx_ptr, part_ptr, M, C,
                  BLOCK_C: tl.constexpr, ROWS: tl.constexpr):
    pid = tl.program_id(0)
    n_prog = tl.num_programs(0)
    cols = tl.arange(0, BLOCK_C)
    cm = cols < C
    s = tl.load(scale_ptr + cols, mask=cm, other=0.0)
    # per-element sums, reduced across rows once at the end: a reduction
    # across the rows of every block costs a shared-memory round trip
    acc_ds = tl.zeros((ROWS, BLOCK_C), dtype=tl.float32)
    acc_db = tl.zeros((ROWS, BLOCK_C), dtype=tl.float32)
    for blk in range(pid, tl.cdiv(M, ROWS), n_prog):
        rows = blk * ROWS + tl.arange(0, ROWS)
        rm = rows < M
        m = rm[:, None] & cm[None, :]
        offs = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=m, other=0.0).to(tl.float32)
        mean = tl.load(mean_ptr + rows, mask=rm, other=0.0)
        inv = tl.load(inv_ptr + rows, mask=rm, other=0.0)
        xhat = tl.where(m, (x - mean[:, None]) * inv[:, None], 0.0)
        t = dy * s[None, :]
        m1 = tl.sum(t, axis=1) / C
        m2 = tl.sum(t * xhat, axis=1) / C
        dx = (t - m1[:, None] - xhat * m2[:, None]) * inv[:, None]
        tl.store(dx_ptr + offs, dx.to(tl.bfloat16), mask=m)
        acc_ds += dy * xhat
        acc_db += dy
    pb = part_ptr + pid * 2 * C + cols
    tl.store(pb, tl.sum(acc_ds, axis=0), mask=cm)
    tl.store(pb + C, tl.sum(acc_db, axis=0), mask=cm)


@triton.jit
def ln_reduce_kernel(part_ptr, ds_ptr, db_ptr, P, C, BLOCK_P: tl.constexpr,
                     BLOCK_CC: tl.constexpr):
    cols = tl.program_id(0) * BLOCK_CC + tl.arange(0, BLOCK_CC)
    cm = cols < C
    acc_s = tl.zeros((BLOCK_P, BLOCK_CC), dtype=tl.float32)
    acc_b = tl.zeros((BLOCK_P, BLOCK_CC), dtype=tl.float32)
    for p0 in range(0, P, BLOCK_P):
        p = p0 + tl.arange(0, BLOCK_P)
        m = (p < P)[:, None] & cm[None, :]
        offs = (p * 2 * C)[:, None] + cols[None, :]
        acc_s += tl.load(part_ptr + offs, mask=m, other=0.0)
        acc_b += tl.load(part_ptr + offs + C, mask=m, other=0.0)
    tl.store(ds_ptr + cols, tl.sum(acc_s, axis=0), mask=cm)
    tl.store(db_ptr + cols, tl.sum(acc_b, axis=0), mask=cm)


def fwd_launch(x2, scale, bias, eps, y, mean, inv):
    M, C = x2.shape
    block_c, rows, warps = _shape(C, 4096)
    ln_fwd_kernel[(triton.cdiv(M, rows),)](x2, scale, bias, y, mean, inv, M, C, eps,
                                          BLOCK_C=block_c, ROWS=rows, num_warps=warps)


def bwd_programs(m: int) -> int:
    """Programs of ``ln_bwd_kernel``, fixed by the shape: rows of the partials."""
    return min(MAX_PROGRAMS, triton.cdiv(m, MIN_ROWS))


def bwd_launch(x2, dy2, mean, inv, scale, dx, part, ds, db):
    M, C = x2.shape
    block_c, rows, warps = _shape(C, 2048)
    P = part.shape[0]
    ln_bwd_kernel[(P,)](x2, dy2, mean, inv, scale, dx, part, M, C,
                        BLOCK_C=block_c, ROWS=rows, num_warps=warps)
    ln_reduce_kernel[(triton.cdiv(C, 64),)](part, ds, db, P, C, BLOCK_P=64, BLOCK_CC=64,
                                            num_warps=4)
