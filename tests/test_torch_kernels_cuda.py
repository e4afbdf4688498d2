"""The port's CUDA and Triton kernels against their plain versions on the
card, at small shapes with ragged edges. Marked ``cuda``: they skip where
there is no CUDA device. On a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from diffusiondepth_tpu_torch import LAUNCHES
from diffusiondepth_tpu_torch.models.backbones.swin import shifted_window_mask
from diffusiondepth_tpu_torch.ops import fused_denoiser as fd
from diffusiondepth_tpu_torch.ops import window_attention as wa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("cin,cout,gn,add,w", [
    (16, 64, False, False, 130), (64, 256, True, False, 37),
    (256, 64, True, True, 129), (64, 16, True, False, 5)])
def test_conv_link_matches_plain(dev, cin, cout, gn, add, w):
    """y within one bf16 step (1e-2 of the largest value), GroupNorm
    partials summed over blocks to f32 order (1e-4)."""
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B, H = 2, 6
    x = torch.randn(B, H, w, cin, generator=g, device=dev).to(bf)
    wt = (torch.randn(3, 3, cin, cout, generator=g, device=dev) / (9 * cin) ** 0.5).to(bf)
    bias = torch.randn(cout, generator=g, device=dev) * 0.1
    kw = {"stats": True}
    if gn:
        kw.update(aeff=1 + 0.1 * torch.randn(B, cin, generator=g, device=dev),
                  beff=0.1 * torch.randn(B, cin, generator=g, device=dev), relu=True)
    if add:
        kw.update(add=torch.randn(B, H, w, cin, generator=g, device=dev).to(bf),
                  te=(0.1 * torch.randn(B, cin, generator=g, device=dev)).to(bf))
    n0 = LAUNCHES["conv_link"]
    y, ps = fd.conv_link(x, wt, bias, **kw)
    yp, psp = fd.conv_link_plain(x, wt, bias, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["conv_link"] == n0 + 1
    assert (y.float() - yp.float()).abs().max() <= 1e-2 * yp.float().abs().max()
    s, sp = ps.sum(1), psp.sum(1)
    assert (s - sp).abs().max() <= 1e-4 * sp.abs().max()


def test_ddim_step_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    u6 = torch.randn(2, 5, 7, 16, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(2, 5, 7, 16, generator=g, device=dev)
    a = 1 + 0.1 * torch.randn(2, 16, generator=g, device=dev)
    b = 0.1 * torch.randn(2, 16, generator=g, device=dev)
    sched = torch.tensor([0.3, 0.954, 0.5, 0.866], device=dev)
    out = fd.ddim_step(u6, a, b, x, sched)
    ref = fd.ddim_step_plain(u6, a, b, x, sched)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("dtype,masked", [
    (torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)])
def test_window_attention_matches_plain(dev, dtype, masked):
    """bf16 to one output step (2e-2), f32 to summation order (1e-5)."""
    g = torch.Generator(device=dev).manual_seed(2)
    nw, heads = 6, 3
    qkv = torch.randn(2, nw, 49, 3 * 32 * heads, generator=g, device=dev).to(dtype)
    bias = 0.1 * torch.randn(heads, 49, 49, generator=g, device=dev)
    mask = torch.from_numpy(shifted_window_mask(14, 21, 7, 3)).to(dev) if masked else None
    out = wa.window_attention(qkv, bias, mask, 32 ** -0.5, heads)
    ref = wa.window_attention_plain(qkv, bias, mask, 32 ** -0.5, heads)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max() <= tol
