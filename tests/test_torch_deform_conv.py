"""The port's deformable-conv family against the JAX package's on the CPU:
``bilinear_sample_nhwc``, ``deform_im2col``, ``modulated_deform_conv``,
``deform_conv``, ``deform_psroi_pooling`` and the ``nn.Module`` wrappers,
forward and gradients, f32. Offsets are large enough that taps cross the
border. Tolerances: each forward result within 1e-4 of its largest value,
each gradient within 1e-3 of its largest value (sums in another order)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.ops import deform_conv as jdc  # noqa: E402
from diffusiondepth_tpu.ops import deform_conv_modules as jdcm  # noqa: E402
from diffusiondepth_tpu.ops import msda as jmsda  # noqa: E402
from diffusiondepth_tpu_torch.ops import deform_conv as pdc  # noqa: E402
from diffusiondepth_tpu_torch.ops import deform_conv_modules as pdcm  # noqa: E402
from diffusiondepth_tpu_torch.ops import msda as pmsda  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import conv_weight, linear_weight  # noqa: E402

from test_torch_support import rel_err  # noqa: E402

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-4, 1e-3


def _parity(jfn, pfn, inputs, grad_of, seed=0):
    """Run ``jfn`` (JAX) and ``pfn`` (port) on the same numpy ``inputs``;
    check the output and the gradients of the inputs named in ``grad_of``
    under one random cotangent."""
    jout = jax.jit(jfn)(*[jnp.asarray(v) for v in inputs.values()])
    cot = np.random.RandomState(seed + 50).randn(*jout.shape).astype(np.float32)
    names = list(inputs)
    idx = [names.index(n) for n in grad_of]

    def jloss(*args):
        return jnp.sum(jfn(*args) * cot)

    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(idx)))(*[jnp.asarray(v) for v in inputs.values()])
    targs = {n: torch.tensor(v, requires_grad=n in grad_of) for n, v in inputs.items()}
    out = pfn(*targs.values())
    (out * torch.from_numpy(cot)).sum().backward()
    assert tuple(out.shape) == tuple(jout.shape)
    assert rel_err(out.detach().numpy(), jout) <= FWD_TOL
    for n, jg in zip(grad_of, jgrads):
        err = rel_err(targs[n].grad.numpy(), jg)
        assert err <= GRAD_TOL, (n, err)
    return out


def test_bilinear_sample_matches_jax():
    """Points inside, on the border and outside the image, on both sides."""
    rng = np.random.RandomState(0)
    img = rng.randn(2, 7, 9, 3).astype(np.float32)
    x = rng.uniform(-2.5, 10.5, (2, 60)).astype(np.float32)
    y = rng.uniform(-2.5, 8.5, (2, 60)).astype(np.float32)
    _parity(jmsda.bilinear_sample_nhwc, pmsda.bilinear_sample_nhwc,
            {"img": img, "x": x, "y": y}, ("img", "x", "y"))


def _offsets(rng, b, ho, wo, n, scale=1.5):
    return (scale * rng.randn(b, ho, wo, n)).astype(np.float32)


IM2COL = [  # (stride, padding, dilation, deformable groups, with mask)
    (1, 1, 1, 1, True), (2, 1, 1, 1, False), (1, 2, 2, 2, True), (2, 0, 1, 2, True)]


@pytest.mark.parametrize("stride,padding,dilation,dg,masked", IM2COL)
def test_deform_im2col_matches_jax(stride, padding, dilation, dg, masked):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    ho = (9 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    wo = (11 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    inputs = {"x": x, "offset": _offsets(rng, 2, ho, wo, dg * 18)}
    if masked:
        inputs["mask"] = rng.rand(2, ho, wo, dg * 9).astype(np.float32)

    def fn(mod):
        def f(x, offset, mask=None):
            return mod.deform_im2col(x, offset, mask, (3, 3), stride, padding, dilation, dg)
        return f

    _parity(fn(jdc), fn(pdc), inputs, tuple(inputs))


CONV = [  # (stride, padding, dilation, groups, deformable groups)
    (1, 1, 1, 1, 1), (2, 1, 1, 1, 1), (1, 2, 2, 1, 1), (1, 1, 1, 2, 1), (1, 1, 1, 1, 2),
    (2, 0, 1, 2, 2)]


@pytest.mark.parametrize("stride,padding,dilation,groups,dg", CONV)
def test_modulated_deform_conv_matches_jax(stride, padding, dilation, groups, dg):
    """DCNv2: the output and the gradients of x, offset, mask, weight and
    bias."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    ho = (9 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    wo = (11 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    inputs = {"x": x, "offset": _offsets(rng, 2, ho, wo, dg * 18),
              "mask": rng.rand(2, ho, wo, dg * 9).astype(np.float32),
              "weight": (rng.randn(3, 3, 4 // groups, 6) / 4).astype(np.float32),
              "bias": rng.randn(6).astype(np.float32)}

    def fn(mod):
        def f(x, offset, mask, weight, bias):
            return mod.modulated_deform_conv(x, offset, mask, weight, bias, stride, padding,
                                             dilation, groups, dg)
        return f

    _parity(fn(jdc), fn(pdc), inputs, tuple(inputs))


@pytest.mark.parametrize("stride,padding,dilation,groups,dg", [CONV[0], CONV[3], CONV[5]])
def test_deform_conv_matches_jax(stride, padding, dilation, groups, dg):
    """DCN v1: the output and the gradients of x, offset and weight."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    ho = (9 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    wo = (11 + 2 * padding - (dilation * 2 + 1)) // stride + 1
    inputs = {"x": x, "offset": _offsets(rng, 2, ho, wo, dg * 18),
              "weight": (rng.randn(3, 3, 4 // groups, 6) / 4).astype(np.float32)}

    def fn(mod):
        def f(x, offset, weight):
            return mod.deform_conv(x, offset, weight, None, stride, padding, dilation, groups, dg)
        return f

    _parity(fn(jdc), fn(pdc), inputs, tuple(inputs))


def _rois():
    # [batch_idx, x1, y1, x2, y2], one box reaching past the image
    return np.asarray([[0, 1.0, 2.0, 9.5, 8.0], [1, 0.0, 0.0, 3.0, 2.0],
                       [1, 4.0, 1.5, 14.0, 11.0]], np.float32)


@pytest.mark.parametrize("with_offset", [False, True])
def test_deform_psroi_pooling_matches_jax(with_offset):
    """Position-sensitive RoI pooling (out 3x3, 2 channels each) with and
    without part offsets: the output and the gradients of x and offset."""
    rng = np.random.RandomState(4)
    inputs = {"x": rng.randn(2, 10, 12, 18).astype(np.float32)}
    if with_offset:
        inputs["offset"] = rng.randn(3, 3, 3, 2).astype(np.float32)
    rois = _rois()

    def fn(mod, asarray):
        def f(x, offset=None):
            return mod.deform_psroi_pooling(x, asarray(rois), offset, 3, 0.8, 2, 0.1)
        return f

    _parity(fn(jdc, jnp.asarray), fn(pdc, torch.from_numpy), inputs, tuple(inputs))


def _conv_sd(p, prefix=""):
    """A JAX deform-conv module's tree under the port's names."""
    sd = {prefix + "weight": conv_weight(p["kernel"])}
    if "bias" in p:
        sd[prefix + "bias"] = np.asarray(p["bias"])
    if "conv_offset" in p:
        sd[prefix + "conv_offset.weight"] = conv_weight(p["conv_offset"]["kernel"])
        sd[prefix + "conv_offset.bias"] = np.asarray(p["conv_offset"]["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _random_tree(tree, rng):
    """Non-zero values for every leaf (the offset convs start at zero)."""
    return jax.tree_util.tree_map(
        lambda a: (0.3 * rng.randn(*a.shape)).astype(np.float32), tree)


MODULES = [  # (JAX class, port class, extra inputs: offset and/or mask)
    ("ModulatedDeformConv", ("offset", "mask")), ("ModulatedDeformConvPack", ()),
    ("DeformConv", ("offset",)), ("DeformConvPack", ())]


@pytest.mark.parametrize("name,extra", MODULES)
def test_deform_modules_match_jax(name, extra):
    """Each module with the JAX module's weights (random, the offset convs
    too): the output and the gradients of the input and of every weight."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 10, 4).astype(np.float32)
    args = [x] + [(_offsets(rng, 2, 4, 5, 36) if e == "offset" else
                   rng.rand(2, 4, 5, 18).astype(np.float32)) for e in extra]
    jm = getattr(jdcm, name)(features=6, kernel_size=3, strides=2, padding=1,
                             deformable_groups=2)
    params = _random_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))["params"],
                          rng)
    pm = getattr(pdcm, name)(4, 6, 3, 2, 1, deformable_groups=2)
    pm.load_state_dict(_conv_sd(params), strict=True)

    jargs = [jnp.asarray(a) for a in args]
    cot = rng.randn(2, 4, 5, 6).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, *a: jm.apply({"params": p}, *a), params, *jargs)
    jg = vjp(jnp.asarray(cot))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = pm(*targs)
    (out * torch.from_numpy(cot)).sum().backward()
    assert rel_err(out.detach().numpy(), jout) <= FWD_TOL
    ref = {k: v.numpy() for k, v in _conv_sd(jax.tree_util.tree_map(np.asarray, jg[0])).items()}
    for n, p in pm.named_parameters():
        assert rel_err(p.grad.numpy(), ref[n]) <= GRAD_TOL, n
    for t, g in zip(targs, jg[1:]):
        assert rel_err(t.grad.numpy(), g) <= GRAD_TOL


def test_pack_modules_start_as_plain_convs():
    """A fresh *Pack module's offset conv is zero: it computes the plain
    (dense) convolution of its weight, the mask at sigmoid(0) = 1/2."""
    torch.manual_seed(0)
    x = torch.randn(1, 6, 7, 4)
    for cls, scale in ((pdcm.DeformConvPack, 1.0), (pdcm.ModulatedDeformConvPack, 0.5)):
        m = cls(4, 5, 3, 1, 1)
        dense = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), m.weight, m.bias, 1, 1)
        with torch.no_grad():
            ref = (scale * (dense - (0 if m.bias is None else m.bias[:, None, None]))
                   + (0 if m.bias is None else m.bias[:, None, None]))
            np.testing.assert_allclose(m(x).numpy(), ref.permute(0, 2, 3, 1).numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pack", [False, True])
def test_deform_roi_pooling_modules_match_jax(pack):
    rng = np.random.RandomState(6)
    x = rng.randn(2, 10, 12, 18).astype(np.float32)
    rois = _rois()
    offset = rng.randn(3, 3, 3, 2).astype(np.float32)
    if pack:
        jm = jdcm.DeformRoIPoolingPack(out_size=3, spatial_scale=0.8, hidden=16)
        params = _random_tree(jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0), x, rois))["params"], rng)
        pm = pdcm.DeformRoIPoolingPack(3, 18, spatial_scale=0.8, hidden=16)
        pm.load_state_dict({f"{n}.{'weight' if k == 'kernel' else k}": torch.from_numpy(
            np.array(linear_weight(v) if k == "kernel" else v, np.float32))
            for n, d in params.items() for k, v in d.items()}, strict=True)
        ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(rois))
        out = pm(torch.from_numpy(x), torch.from_numpy(rois))
    else:
        jm = jdcm.DeformRoIPooling(out_size=3, spatial_scale=0.8)
        ref = jm.apply({}, jnp.asarray(x), jnp.asarray(rois), jnp.asarray(offset))
        out = pdcm.DeformRoIPooling(3, 0.8)(torch.from_numpy(x), torch.from_numpy(rois),
                                             torch.from_numpy(offset))
    assert tuple(out.shape) == (3, 3, 3, 2)
    assert rel_err(out.detach().numpy(), ref) <= FWD_TOL
