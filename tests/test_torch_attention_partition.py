"""The dbias partition of the bf16 window-attention backward (kernel K7):
block s of each head sums dS over a contiguous run of windows, and the
partials are summed in the order of s. No card is needed: the partition is a
pure function of the shapes, and the wrapper sizes the partials with it."""

import pytest

from diffusiondepth_tpu_torch.ops.window_attention import (
    BWD_BLOCKS_PER_SM, BWD_SMS, window_attention_bwd_splits,
)

SWIN_L_HEADS = (6, 12, 24, 48)


def window_attention_bwd_chunks(b, nw, heads):
    """The windows (index b * nW + w) that block s of each head walks, in
    order: the kernel's [s n / S, (s + 1) n / S) with S the splits that
    also size the wrapper's partials."""
    n, splits = b * nw, window_attention_bwd_splits(b, nw, heads)
    return [range(s * n // splits, (s + 1) * n // splits) for s in range(splits)]


def _windows(b, h_img, w_img, stage):
    """B * nW of a Swin-L stage: the patch embedding and each merge round
    up, then the grid is padded to whole 7x7 windows."""
    hh, ww = -(-h_img // (4 << stage)), -(-w_img // (4 << stage))
    return b, -(-hh // 7) * -(-ww // 7)


@pytest.mark.parametrize("b,h_img,w_img", [(8, 352, 1216), (4, 352, 906)],
                         ids=["serve", "train"])
@pytest.mark.parametrize("stage", range(4))
def test_partition_covers_each_window_once_in_order(b, h_img, w_img, stage):
    heads = SWIN_L_HEADS[stage]
    b, nw = _windows(b, h_img, w_img, stage)
    splits = window_attention_bwd_splits(b, nw, heads)
    chunks = window_attention_bwd_chunks(b, nw, heads)
    # one (N, N) partial per block: the count the wrapper allocates
    assert len(chunks) == splits
    assert 1 <= splits <= b * nw
    # at most one resident wave of blocks across the heads
    assert splits * heads <= BWD_SMS * BWD_BLOCKS_PER_SM + heads
    # contiguous runs, in order, covering every (b, w) exactly once
    flat = [win for c in chunks for win in c]
    assert flat == list(range(b * nw))
    assert all(len(c) >= 1 for c in chunks)
    # balanced to one window
    sizes = [len(c) for c in chunks]
    assert max(sizes) - min(sizes) <= 1
    # a pure function: the same partition every time
    assert window_attention_bwd_chunks(b, nw, heads) == chunks


@pytest.mark.parametrize("b,nw,heads", [(1, 1, 1), (1, 3, 48), (3, 9, 48), (1, 600, 1)])
def test_partition_small_and_ragged(b, nw, heads):
    """The card tests' shapes: fewer windows than blocks gives one window a
    block; more gives runs that differ by at most one window."""
    chunks = window_attention_bwd_chunks(b, nw, heads)
    assert [w for c in chunks for w in c] == list(range(b * nw))
    assert len(chunks) == min(b * nw, -(-BWD_SMS * BWD_BLOCKS_PER_SM // heads))
