"""K10's plan (``ops/layernorm.py::layernorm_bwd_plan``): how the CUDA
LayerNorm backward splits an (M, C) problem over the SMs, lays out its
shared-memory ring, pads a row to its pitch and picks the wide variant.
Pure Python; the kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import pytest

from chip_smoke import swin_norm_shapes
from diffusiondepth_tpu_torch.ops.layernorm import (
    LN_BWD_CONSUMERS, LN_BWD_RING_MAX_PITCH, LN_BWD_SMEM_LIMIT, LN_BWD_WIDE_THREADS,
    layernorm_bwd_pitch, layernorm_bwd_plan,
)

# every Swin-L norm of a 352x906 batch of 4 (training) and a 352x1216
# batch of 8 (serving), then small and ragged M at three widths
SWIN = sorted(set(swin_norm_shapes(4, 352, 906)) | set(swin_norm_shapes(8, 352, 1216)))
SHAPES = sorted(set(SWIN) | {(m, c) for m in (1, 37, 131, 133) for c in (192, 768, 3072)})
# widths the ring takes since C % 8 == 0 and C <= 3072 stopped bounding it:
# C < 8, C % 8 != 0, and 3072 < C <= 4096
PADDED = sorted({(m, c) for m in (1, 37, 1001) for c in (1, 4, 7, 12, 100, 3080, 4096)}
                | {(777, 7), (513, 100), (300, 3080), (1001, 1)})
# rows wider than 4096: the wide variant
WIDE = [(129, 4100), (33, 9000), (3, 65536), (1, 4097), (1000, 5000), (20000, 4104)]

# the plan of every Swin-L shape as the kernel took it before the pitch and
# the wide variant existed: (ctas, first rows, last rows, rows_per_stage,
# stages, threads_per_row, vectors_per_thread, ring_offset, stage_bytes,
# dy_offset, smem_bytes)
PINNED = {
    (1276, 1536): (132, (0, 10), (1267, 1276), 4, 3, 64, 3, 256, 24608, 12288, 123360),
    (1276, 3072): (132, (0, 10), (1267, 1276), 2, 3, 128, 3, 256, 24608, 12288, 123360),
    (3344, 1536): (132, (0, 26), (3319, 3344), 4, 3, 64, 3, 256, 24608, 12288, 123360),
    (3344, 3072): (132, (0, 26), (3319, 3344), 2, 3, 128, 3, 256, 24608, 12288, 123360),
    (5016, 768): (132, (0, 38), (4978, 5016), 8, 3, 32, 3, 256, 24640, 12288, 123456),
    (5016, 1536): (132, (0, 38), (4978, 5016), 4, 3, 64, 3, 256, 24608, 12288, 123360),
    (13376, 768): (132, (0, 102), (13275, 13376), 8, 3, 32, 3, 256, 24640, 12288, 123456),
    (13376, 1536): (132, (0, 102), (13275, 13376), 4, 3, 64, 3, 256, 24608, 12288, 123360),
    (20064, 384): (132, (0, 152), (19912, 20064), 16, 3, 16, 3, 256, 24704, 12288, 99072),
    (20064, 768): (132, (0, 152), (19912, 20064), 8, 3, 32, 3, 256, 24640, 12288, 123456),
    (53504, 384): (132, (0, 406), (53099, 53504), 16, 3, 16, 3, 256, 24704, 12288, 99072),
    (53504, 768): (132, (0, 406), (53099, 53504), 8, 3, 32, 3, 256, 24640, 12288, 123456),
    (79904, 192): (132, (0, 606), (79299, 79904), 32, 3, 8, 3, 256, 24832, 12288, 87168),
    (214016, 192): (132, (0, 1622), (212395, 214016), 32, 3, 8, 3, 256, 24832, 12288, 87168),
}


def _check_rows(p, m):
    """Every row lies in exactly one block's range, in order."""
    assert p.ctas == len(p.row_ranges) == min(132, m)
    start = 0
    for lo, hi in p.row_ranges:
        assert lo == start and hi > lo
        start = hi
    assert start == m


def _check_ring(p, c):
    """The ring fits the block's 227 KB; every bulk copy (R rows of x or
    dy at the pitch, or the ragged last stage) has a size and a global and
    shared offset that are multiples of 16 bytes; at least two stages; a
    row's threads own whole 16-byte vectors that cover the pitch, at most
    4 each."""
    w = p.pitch
    assert p.variant == "ring" and w % 8 == 0 and c <= w < c + 8
    assert p.smem_bytes <= LN_BWD_SMEM_LIMIT
    assert p.stages >= 2
    tpr, vpt = p.threads_per_row, p.vectors_per_thread
    assert tpr & (tpr - 1) == 0 and 1 <= vpt <= 4
    assert (vpt - 1) * tpr * 8 < w <= vpt * tpr * 8
    assert p.rows_per_stage % (LN_BWD_CONSUMERS // tpr) == 0
    assert p.warps_per_row == tpr / 32
    assert p.smem_bytes >= p.ring_offset + p.stages * p.stage_bytes
    assert p.dy_offset == p.rows_per_stage * w * 2
    for lo, hi in p.row_ranges:
        for s0 in range(lo, hi, p.rows_per_stage):
            n = min(p.rows_per_stage, hi - s0)
            slot = (s0 - lo) // p.rows_per_stage % p.stages
            size, src = n * w * 2, s0 * w * 2
            for dst in (0, p.dy_offset):
                dst += p.ring_offset + slot * p.stage_bytes
                assert size % 16 == 0 and src % 16 == 0 and dst % 16 == 0


@pytest.mark.parametrize("m,c", SHAPES)
def test_plan_covers_rows_and_fits(m, c):
    """At C % 8 == 0 up to 3072 the pitch is C itself and the ring takes
    the rows (see ``_check_ring``)."""
    p = layernorm_bwd_plan(m, c)
    _check_rows(p, m)
    assert p.pitch == c
    _check_ring(p, c)


@pytest.mark.parametrize("m,c", sorted(PINNED))
def test_swin_plans_pinned(m, c):
    """Every Swin-L shape takes the plan it took before any other width
    was planned: the same launch, so the same bits."""
    p = layernorm_bwd_plan(m, c)
    got = (p.ctas, p.row_ranges[0], p.row_ranges[-1], p.rows_per_stage, p.stages,
           p.threads_per_row, p.vectors_per_thread, p.ring_offset, p.stage_bytes,
           p.dy_offset, p.smem_bytes)
    assert got == PINNED[(m, c)]
    assert (p.pitch, p.variant) == (c, "ring")


@pytest.mark.parametrize("m,c", PADDED)
def test_plan_pitch_layout(m, c):
    """C < 8, C % 8 != 0 and 3072 < C <= 4096 take the ring at pitch
    ceil8(C): every row of the staged x and dy starts on 16 bytes, and
    every bulk copy stays a multiple of 16 bytes."""
    p = layernorm_bwd_plan(m, c)
    assert p.pitch == layernorm_bwd_pitch(c) == -(-c // 8) * 8 <= LN_BWD_RING_MAX_PITCH
    _check_rows(p, m)
    _check_ring(p, c)


@pytest.mark.parametrize("m,c", WIDE)
def test_wide_plan_split(m, c):
    """A pitch above 4096 takes the wide variant: the same contiguous row
    ranges, 512 threads on one row, each owning ceil(pitch / 8 / 512)
    16-byte vectors that together cover the pitch; no ring and no dynamic
    shared memory; the workspace rows (2, pitch) f32 start on 16 bytes."""
    p = layernorm_bwd_plan(m, c)
    _check_rows(p, m)
    w = p.pitch
    assert p.variant == "wide" and w == -(-c // 8) * 8 > LN_BWD_RING_MAX_PITCH
    assert p.threads_per_row == LN_BWD_WIDE_THREADS
    assert (p.vectors_per_thread - 1) * LN_BWD_WIDE_THREADS * 8 < w
    assert w <= p.vectors_per_thread * LN_BWD_WIDE_THREADS * 8
    assert (p.rows_per_stage, p.stages, p.smem_bytes, p.stage_bytes) == (1, 0, 0, 0)
    assert (2 * w * 4) % 16 == 0


@pytest.mark.parametrize("m,c", [(1000, 0), (0, 768), (0, 0)])
def test_plan_refuses_unsupported_widths(m, c):
    """C = 0 or M = 0 raises by name; every other shape has a plan."""
    with pytest.raises(ValueError, match="layernorm_bwd"):
        layernorm_bwd_plan(m, c)
