"""The port's six depth transforms against the JAX package's, in f32: ``t``
and ``inv_t`` in eval mode (running statistics) and in training mode
(batch statistics and their running update), ``inv_t(running=True)`` in
training mode, and ``build_depth_transform`` from a cfg dict."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models import depth_transform as jdt  # noqa: E402
from diffusiondepth_tpu_torch.models import depth_transform as pdt  # noqa: E402
from diffusiondepth_tpu_torch.registry import DEPTH_TRANSFORMS  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import _depth_transform  # noqa: E402

from test_torch_support import module_variables  # noqa: E402

torch.set_num_threads(1)

NAMES = ["DeepDepthTransformWithUpsampling", "DeepDepthTransformWithUpsampling1x1",
         "DeepDepthTransformWithUpsamplingX4", "DeepDepthTransform",
         "ReciprocalDepthTransform", "ReciprocalDepthTransformII"]
LEARNED = NAMES[:4]
TOL = dict(rtol=1e-5, atol=1e-5)


def _depth(seed, b=2, h=16, w=24):
    return (np.random.RandomState(seed).rand(b, h, w, 1) * 40 + 0.1).astype(np.float32)


def _pair(name, seed=0):
    """The JAX module, its variables (numpy draws) and the port module
    holding the same weights."""
    jm = getattr(jdt, name)()
    pm = getattr(pdt, name)()
    depth = _depth(seed)
    if name not in LEARNED:
        return jm, {}, pm
    variables = module_variables(jm, depth, seed=seed)
    sd = {}
    _depth_transform(sd, "", variables["params"], variables.get("batch_stats", {}))
    pm.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()},
                       strict=True)
    return jm, variables, pm


def _jax(jm, variables, method, x, train):
    fn = getattr(jm, method)
    if not variables:
        return np.asarray(fn(jnp.asarray(x))), {}
    out, mut = jm.apply(variables, jnp.asarray(x), train, method=method,
                        mutable=["batch_stats"])
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, dict(mut))


def _stats(pm):
    return {n: b.numpy().copy() for n, b in pm.named_buffers()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", NAMES)
def test_transform_matches_jax(name, train):
    """t(depth), then inv_t of a latent of t's shape drawn in [-1, 1]:
    both within rtol 1e-5 and atol 1e-5 of JAX's (the decode is f32; a
    sigmoid near 0 maps to depths up to 1e6, so the latent stays in the
    tanh range). In training mode the running statistics after each call
    equal flax's within the same tolerance; in eval mode they stay put."""
    jm, variables, pm = _pair(name, seed=3)
    pm.train(train)
    depth = _depth(4)
    jlat, jmut = _jax(jm, variables, "t", depth, train)
    before = _stats(pm)
    with torch.no_grad():
        plat = pm.t(torch.from_numpy(depth))
    np.testing.assert_allclose(plat.numpy(), jlat, **TOL)

    value = np.tanh(np.random.RandomState(5).randn(*jlat.shape)).astype(np.float32)
    if name == "ReciprocalDepthTransformII":
        value = np.abs(value) + 0.05  # its inverse divides by the value
    jdec, jmut_dec = _jax(jm, variables, "inv_t", value, train)
    with torch.no_grad():
        pdec = pm.inv_t(torch.from_numpy(value))
    assert pdec.dtype == torch.float32 and pdec.shape == jdec.shape
    np.testing.assert_allclose(pdec.numpy(), jdec, **TOL)

    if name not in LEARNED:
        return
    after = _stats(pm)
    if not train:
        for n in after:
            np.testing.assert_array_equal(after[n], before[n])
        return
    # the port's statistics after both calls against flax's after each one
    sd_t, sd_dec = {}, {}
    _depth_transform(sd_t, "", variables["params"], jmut["batch_stats"])
    _depth_transform(sd_dec, "", variables["params"], jmut_dec["batch_stats"])
    moved = 0
    for n in after:
        ref = sd_t[n] if not np.array_equal(np.asarray(sd_t[n]), before[n]) else sd_dec[n]
        np.testing.assert_allclose(after[n], np.asarray(ref), **TOL)
        moved += not np.array_equal(after[n], before[n])
    assert moved == len(after)


@pytest.mark.parametrize("name", LEARNED)
def test_inv_t_running_matches_jax_eval(name):
    """inv_t(running=True) in training mode decodes with the running
    statistics, as JAX's inv_t(train=False) (the vis heads' decode), and
    leaves them as they were."""
    jm, variables, pm = _pair(name, seed=6)
    pm.train()
    value = np.tanh(np.random.RandomState(7).randn(2, 8, 12, 16)).astype(np.float32)
    jdec, _ = _jax(jm, variables, "inv_t", value, False)
    before = _stats(pm)
    with torch.no_grad():
        pdec = pm.inv_t(torch.from_numpy(value), running=True)
    np.testing.assert_allclose(pdec.numpy(), jdec, **TOL)
    for n, v in _stats(pm).items():
        np.testing.assert_array_equal(v, before[n])


@pytest.mark.parametrize("cfg", [
    dict(type="DeepDepthTransformWithUpsamplingX4", hidden=16, eps=1e-6),
    dict(type="DeepDepthTransformWithUpsampling1x1", hidden=8, eps=1e-4),
    dict(type="ReciprocalDepthTransform", linear=(2.0, 0.5), eps=1e-3),
    dict(type="ReciprocalDepthTransformII", min_depth=1.0),
    "DeepDepthTransform"], ids=lambda c: c if isinstance(c, str) else c["type"])
def test_build_depth_transform_from_cfg(cfg):
    """build_depth_transform takes a cfg dict or a name, as the JAX
    registry does: the same class and settings, the same parameter count,
    and the same outputs for the parameter-free transforms."""
    jm = jdt.build_depth_transform(cfg)
    pm = pdt.build_depth_transform(cfg)
    assert type(pm).__name__ == type(jm).__name__
    assert sorted(DEPTH_TRANSFORMS._module_dict) == sorted(NAMES)
    depth = _depth(8)
    if type(pm).__name__ in LEARNED:
        assert pm.eps == jm.eps
        variables = module_variables(jm, depth)
        n_jax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(variables))
        assert n_jax == sum(v.numel() for v in pm.state_dict().values())
        return
    lat = pm.t(torch.from_numpy(depth))
    np.testing.assert_allclose(lat.numpy(), np.asarray(jm.t(jnp.asarray(depth))), **TOL)
    np.testing.assert_allclose(pm.inv_t(lat).numpy(), np.asarray(jm.inv_t(jnp.asarray(lat))),
                               **TOL)


def test_head_refuses_a_parameter_free_transform_as_jax():
    """A head builds its transform with its compute dtype, which the two
    reciprocal transforms do not take: both packages raise the same
    TypeError, so no model carries them (the weight bridge maps a head
    without a depth-transform tree all the same)."""
    from diffusiondepth_tpu.models.heads.ddim_head import DDIMDepthEstimate_Res as JHead
    from diffusiondepth_tpu_torch.models.heads.ddim_head import DDIMDepthEstimate_Res

    cfg = dict(type="ReciprocalDepthTransform")
    fp = [jnp.zeros((1, 16 >> i, 24 >> i, c)) for i, c in enumerate((64, 128, 256, 512))]
    key = jax.random.PRNGKey(0)
    with pytest.raises(TypeError, match="dtype"):
        jax.eval_shape(lambda: JHead(depth_transform_cfg=cfg, inference_steps=1).init(
            {"params": key, "diffusion": key}, fp, gt_depth_map=jnp.ones((1, 32, 48, 1))))
    with pytest.raises(TypeError, match="dtype"):
        DDIMDepthEstimate_Res(depth_transform_cfg=cfg)
