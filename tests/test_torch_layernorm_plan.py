"""K10's plan (``ops/layernorm.py::layernorm_bwd_plan``): how the CUDA
LayerNorm backward splits an (M, C) problem over the SMs and lays out its
shared-memory ring. Pure Python; the kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``)."""

import pytest

from chip_smoke import swin_norm_shapes
from diffusiondepth_tpu_torch.ops.layernorm import (
    LN_BWD_CONSUMERS, LN_BWD_SMEM_LIMIT, layernorm_bwd_plan,
)

# every Swin-L norm of a 352x906 batch of 4 (training) and a 352x1216
# batch of 8 (serving), then small and ragged M at three widths
SHAPES = sorted(set(swin_norm_shapes(4, 352, 906)) | set(swin_norm_shapes(8, 352, 1216))
                | {(m, c) for m in (1, 37, 131, 133) for c in (192, 768, 3072)})


@pytest.mark.parametrize("m,c", SHAPES)
def test_plan_covers_rows_and_fits(m, c):
    """Every row lies in exactly one block's range, in order; the ring fits
    the block's 227 KB; every bulk copy (R rows of x or dy, or the ragged
    last stage) has a size and a global and shared offset that are
    multiples of 16 bytes; at least two stages; a row's threads own whole
    16-byte vectors that cover C, at most 4 each."""
    p = layernorm_bwd_plan(m, c)
    assert p.ctas == len(p.row_ranges) == min(132, m)
    start = 0
    for lo, hi in p.row_ranges:
        assert lo == start and hi > lo
        start = hi
    assert start == m
    assert p.smem_bytes <= LN_BWD_SMEM_LIMIT
    assert p.stages >= 2
    tpr, vpt = p.threads_per_row, p.vectors_per_thread
    assert tpr & (tpr - 1) == 0 and 1 <= vpt <= 4
    assert (vpt - 1) * tpr * 8 < c <= vpt * tpr * 8
    assert p.rows_per_stage % (LN_BWD_CONSUMERS // tpr) == 0
    assert p.warps_per_row == tpr / 32
    assert p.smem_bytes >= p.ring_offset + p.stages * p.stage_bytes
    assert p.dy_offset == p.rows_per_stage * c * 2
    for lo, hi in p.row_ranges:
        for s0 in range(lo, hi, p.rows_per_stage):
            n = min(p.rows_per_stage, hi - s0)
            slot = (s0 - lo) // p.rows_per_stage % p.stages
            size, src = n * c * 2, s0 * c * 2
            for dst in (0, p.dy_offset):
                dst += p.ring_offset + slot * p.stage_bytes
                assert size % 16 == 0 and src % 16 == 0 and dst % 16 == 0


@pytest.mark.parametrize("c", [4, 12, 100, 3080, 4096, 0])
def test_plan_refuses_unsupported_widths(c):
    """C % 8 != 0 or C > 3072 (or C < 8) raises by name."""
    with pytest.raises(ValueError, match="layernorm_bwd"):
        layernorm_bwd_plan(1000, c)
