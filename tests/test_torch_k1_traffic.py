"""The bytes K1's blocks pull from L2, as ``chip_smoke.py``'s kernel phase
reports them beside each link's time (``k1_l2_bytes``): every link of the
six-link and the 'add' chain at the bs8 eval latent (8, 176, 608), whose
5 row segments of 128 pixels a row make 7040 blocks a link."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import ADD_LINKS, LINKS, k1_l2_bytes  # noqa: E402
from diffusiondepth_tpu_torch.ops.fused_denoiser import CONV_LINK_BLOCK_PIXELS  # noqa: E402

# (weight bytes, halo and add-map bytes): a 64-channel chunk's halo is
# 3 x 130 x 64 bf16 = 49,920 bytes a block, a (tap, chunk) weight tile
# Cout x 64 bf16; ne0's 16-channel chunk and pr1's 16 output channels
# make the small tiles
_BS8 = {
    ("six", "ne0"): (7040 * 9 * 64 * 16 * 2, 7040 * 3 * 130 * 16 * 2),
    ("six", "ne1"): (2_076_180_480, 351_436_800),
    ("six", "fa"): (8_304_721_920, 2 * 1_405_747_200),
    ("six", "fb"): (8_304_721_920, 1_405_747_200),
    ("six", "pr0"): (2_076_180_480, 1_405_747_200),
    ("six", "pr1"): (7040 * 9 * 16 * 64 * 2, 351_436_800),
    ("add", "ne0"): (7040 * 9 * 64 * 16 * 2, 7040 * 3 * 130 * 16 * 2),
    ("add", "ne1"): (2_076_180_480, 351_436_800),
    ("add", "pr0"): (2_076_180_480, 2 * 1_405_747_200),
    ("add", "pr1"): (7040 * 9 * 16 * 64 * 2, 351_436_800),
}


@pytest.mark.parametrize("chain,link", sorted(_BS8))
def test_k1_l2_bytes_at_the_serve_latent(chain, link):
    name, cin, cout, _, add, _ = next(l for l in (LINKS if chain == "six" else ADD_LINKS)
                                      if l[0] == link)
    assert k1_l2_bytes(8, 176, 608, cin, cout, add, CONV_LINK_BLOCK_PIXELS) == _BS8[chain, link]
