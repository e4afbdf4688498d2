"""The serving path's kernels as ``torch.library`` operators
(``ops/library.py``) on the CPU: each operator's CPU implementation is the
plain version, its fake rule gives the real outputs' shapes and types,
``torch.library.opcheck`` passes, and ``FlopCounterMode`` counts the
operators' formulas as it counts the plain PyTorch routes they replace."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import diffusiondepth_tpu_torch as port
from diffusiondepth_tpu_torch.ops import fused_denoiser as fd
from diffusiondepth_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)
OPS = torch.ops.diffusiondepth


def _cases():
    """name -> (operator, plain version returning the operator's outputs, args)."""
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def r(*s, dtype=torch.float32, scale=1.0):
        return (torch.randn(s, generator=g) * scale).to(dtype)

    x, add = r(2, 4, 6, 16, dtype=bf), r(2, 4, 6, 16, dtype=bf)
    w = r(3, 3, 16, 64, dtype=bf, scale=0.1)
    a, o = 1 + r(2, 16, scale=0.1), r(2, 16, scale=0.1)
    te = r(2, 16, dtype=bf, scale=0.1)
    u6, lat = r(2, 4, 6, 16, dtype=bf), r(2, 4, 6, 16)
    sched = torch.tensor([0.8, 0.6, 0.9, 0.43589])
    qkv, bias, mask = r(1, 2, 49, 96), r(1, 49, 49), r(2, 49, 49)
    q, k, v = (r(1, 2, 1, 49, 32, dtype=bf) for _ in range(3))

    def link(*args):
        y, ps = fd.conv_link_plain(*args)
        return y, ps if ps is not None else torch.empty(0)

    return {
        "conv_link_stats": (OPS.conv_link.default, link, (x, w, r(64), a, o, True, add, te, True)),
        "conv_link_bare": (OPS.conv_link.default, link,
                           (x, w, r(64), None, None, False, None, None, False)),
        "ddim_step": (OPS.ddim_step.default, fd.ddim_step_plain, (u6, a, o, lat, sched)),
        "window_attention": (OPS.window_attention.default, wa.window_attention_plain,
                             (qkv, bias, mask, 0.17, 1)),
        "window_attention_split": (OPS.window_attention_split.default,
                                   wa.window_attention_split_plain, (q, k, v, bias, mask, 0.17)),
    }


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_cpu_implementation_is_the_plain_version(case):
    """Bit for bit, and no launch is counted."""
    op, plain, args = _cases()[case]
    port.reset_launch_counts()
    for got, want in zip(_tuple(op(*args)), _tuple(plain(*args))):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert not any(port.LAUNCHES.values())


@pytest.mark.parametrize("case", sorted(_cases()))
def test_fake_rule_gives_the_real_shapes(case):
    op, _, args = _cases()[case]
    real = _tuple(op(*args))
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
        fake = _tuple(op(*fake_args))
    assert [(t.shape, t.dtype, t.stride()) for t in fake] == \
        [(t.shape, t.dtype, t.stride()) for t in real]


def test_conv_link_fake_partials_follow_the_device():
    """On the card K1 writes one partial per 128-pixel row segment, the
    plain version one per image: the fake rule gives each device's shape."""
    for dev, n in (("cuda", 3 * 2), ("cpu", 1)):
        with FakeTensorMode():  # fake CUDA tensors need no card
            x = torch.empty(2, 3, 130, 16, dtype=torch.bfloat16, device=dev)
            w = torch.empty(3, 3, 16, 64, dtype=torch.bfloat16, device=dev)
            y, ps = OPS.conv_link(x, w, torch.empty(64, device=dev), None, None, False, None,
                                  None, True)
        assert y.device.type == dev and tuple(ps.shape) == (2, n, 2, 64)
    assert fd.conv_link_partials_shape(2, 3, 130, 64, "cuda") == (2, 6, 2, 64)


@pytest.mark.parametrize("case", sorted(_cases()))
def test_opcheck(case):
    op, _, args = _cases()[case]
    torch.library.opcheck(op, args)


def _count(model, batch, lat):
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(batch, init_latent=lat)
    return counter.get_total_flops()


def _micro(**kw):
    cfg = port.Config(model_name="Diffusion_DCbase_", backbone_module="swin",
                      backbone_name="swin_micro", inference_steps=2, opt_level="O1",
                      head_in_channels="32,64,128,256", **kw).finalize()
    return port.build_model(cfg, device="cpu")


@pytest.mark.parametrize("route", ["module_denoiser", "einsum_attention"])
def test_flop_formulas_count_as_the_routes_they_replace(route):
    """A swin_micro flagship eval under the bf16 policy (2 steps, 64x96)
    counts the same FLOPs through the operators as with the module
    denoiser in place of K1 and K3 (``fused_denoiser`` off), or with the
    einsum attention in place of K4 (``fused_window_attention`` off); K1
    counts exactly 2 B H W 9 Cin Cout per link, K3 nothing."""
    g = torch.Generator().manual_seed(0)
    batch = {"rgb": torch.randn(1, 64, 96, 3, generator=g),
             "gt": torch.rand(1, 64, 96, 1, generator=g) * 5 + 1}
    lat = torch.randn(1, 32, 48, 16, generator=g)
    ops = _micro()
    assert ops.depth_head.model.fused_active(32)
    other = _micro(**{"module_denoiser": {"fused_denoiser": False},
                      "einsum_attention": {"fused_window_attention": False}}[route])
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        ops(batch, init_latent=lat)
    assert counter.get_total_flops() == _count(other, batch, lat) > 0
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"].items()}
    links = [(16, 64), (64, 256), (256, 256), (256, 256), (256, 64), (64, 16)]
    assert by_op["diffusiondepth.conv_link"] == 2 * sum(
        2 * 32 * 48 * 9 * cin * cout for cin, cout in links)
    assert by_op.get("diffusiondepth.ddim_step", 0) == 0
    assert by_op["diffusiondepth.window_attention"] > 0
