"""Last-dim LayerNorm forward with bf16 traffic and f32 statistics as a
Triton kernel: K9 of the port. Its backward, K10, is the CUDA kernel
``csrc/layernorm_bwd.cu``.

K9 replaces the TPU kernel diffusiondepth_tpu/ops/layernorm.py
_ln_fwd_kernel (reached through layernorm_fwd_pallas). Per row of x (M, C)
bf16, in f32:

    mean = sum(x) / C,  var = sum((x - mean)^2) / C,  inv = rsqrt(var + eps)
    y    = (x - mean) * inv * scale + bias          (stored as bf16)

and mean, inv (M,) f32 for the backward. Nothing is rounded to bf16
before the store of y. Any M >= 1 and C >= 1, x at any 2-byte offset.

What bounds it on the H100: bytes. It reads 2 B and writes 2 B per element
(plus 8 B per row): at the Swin-L stage-0 norm of a 352x906 batch of 4,
(79904, 192), ~61 MB, ~18 us at 3.35 TB/s.

What the design does about it: one pass over the rows, each byte once,
with the statistics on registers. Up to C = ONE_PASS_MAX_C a program holds
ROWS rows of BLOCK_C = next_pow2(C) columns (masked past C), so a row
never leaves the program (``ln_fwd_kernel``). A wider row would put its
next_pow2(C) f32 values on one program's registers;
``ln_fwd_wide_kernel`` takes one row a program in chunks of WIDE_BLOCK
columns and makes three passes over it, the row's bytes coming back from
L2 in the second and third: the sum to the mean, the sum of (x - mean)^2
to the variance (the same two-pass arithmetic as the one-program kernel,
the plain version and JAX), then the normalised store. The switch at 4096
is measured (``tools/layernorm_bwd_sweep.py``, H100 80GB HBM3 at 700 W,
1024 rows): the one-program row is faster at 3080 columns, the looped
kernel from 4100 up (at 4100 its one-program row is half masked).

Loaded by ``diffusiondepth_tpu_torch.ops.layernorm`` only when it launches
the kernel: it imports triton, which only the machine with the card has.
"""

import triton
import triton.language as tl

ONE_PASS_MAX_C = 4096  # widest row a program holds whole
WIDE_BLOCK = 4096  # columns per chunk of ln_fwd_wide_kernel


def _shape(c: int, tile: int):
    """(BLOCK_C, ROWS, num_warps) for row blocks of about ``tile`` f32
    elements: 16 per thread and live array. BLOCK_C is at least 16, so a
    program of narrow rows still takes 16 columns a row."""
    block_c = max(16, triton.next_power_of_2(c))
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
def ln_fwd_wide_kernel(x_ptr, scale_ptr, bias_ptr, y_ptr, mean_ptr, inv_ptr, C, eps,
                       BLOCK: tl.constexpr):
    row = tl.program_id(0)
    base = row.to(tl.int64) * C
    cols = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for c0 in range(0, C, BLOCK):
        cm = c0 + cols < C
        acc += tl.load(x_ptr + base + c0 + cols, mask=cm, other=0.0).to(tl.float32)
    mean = tl.sum(acc, axis=0) / C
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for c0 in range(0, C, BLOCK):
        cm = c0 + cols < C
        x = tl.load(x_ptr + base + c0 + cols, mask=cm, other=0.0).to(tl.float32)
        d = tl.where(cm, x - mean, 0.0)
        acc += d * d
    var = tl.sum(acc, axis=0) / C
    inv = tl.rsqrt(var + eps)
    for c0 in range(0, C, BLOCK):
        cm = c0 + cols < C
        x = tl.load(x_ptr + base + c0 + cols, mask=cm, other=0.0).to(tl.float32)
        s = tl.load(scale_ptr + c0 + cols, mask=cm, other=0.0)
        b = tl.load(bias_ptr + c0 + cols, mask=cm, other=0.0)
        y = (x - mean) * inv * s + b
        tl.store(y_ptr + base + c0 + cols, y.to(tl.bfloat16), mask=cm)
    tl.store(mean_ptr + row, mean)
    tl.store(inv_ptr + row, inv)


def fwd_launch(x2, scale, bias, eps, y, mean, inv, wide=None):
    """K9 on x2 (M, C) into y, mean, inv: the one-program kernel up to
    ONE_PASS_MAX_C columns, the looped one above (``wide`` forces either,
    for timing the two against each other)."""
    M, C = x2.shape
    if wide is None:
        wide = C > ONE_PASS_MAX_C
    if wide:
        ln_fwd_wide_kernel[(M,)](x2, scale, bias, y, mean, inv, C, eps, BLOCK=WIDE_BLOCK,
                                 num_warps=8)
        return
    block_c, rows, warps = _shape(C, 4096)
    ln_fwd_kernel[(triton.cdiv(M, rows),)](x2, scale, bias, y, mean, inv, M, C, eps,
                                          BLOCK_C=block_c, ROWS=rows, num_warps=warps)
