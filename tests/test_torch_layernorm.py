"""The port's LayerNorm against the JAX package: the plain versions of
kernels K9 and K10 against the JAX Pallas kernels in interpret mode (at
Swin widths, an odd C and a C wider than Swin's 3072), and the
``LayerNorm`` module (f32 and bf16 branches) against the JAX module,
forward and gradients, the bf16 branch at every kind of width K9 and K10
take and on a view that does not start on 16 bytes."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.common import LayerNorm as JLayerNorm  # noqa: E402
from diffusiondepth_tpu.ops.layernorm import (  # noqa: E402
    _ln_jnp_fwd, layernorm_bwd_pallas, layernorm_fwd_pallas,
)
from diffusiondepth_tpu_torch.models.common import LayerNorm  # noqa: E402
from diffusiondepth_tpu_torch.ops.layernorm import layernorm_bwd, layernorm_fwd  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    """A JAX array as a torch tensor of the same type (bf16 through f32)."""
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _ln_inputs(m, c, seed):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(m, c) * 2, jnp.bfloat16)
    dy = jnp.asarray(rng.randn(m, c), jnp.bfloat16)
    scale = jnp.asarray(rng.rand(c).astype(np.float32) + 0.5)
    bias = jnp.asarray(rng.randn(c).astype(np.float32))
    return x, dy, scale, bias


@pytest.mark.parametrize("m,c", [(300, 192), (129, 384), (37, 7), (5, 5000)])
def test_layernorm_fwd_matches_pallas(m, c):
    """Plain K9 == ``layernorm_fwd_pallas`` (interpret mode; M not a
    multiple of its row block; C odd and C above 3072 too), with the JAX
    kernel test's tolerances: y 0.06 absolute (one bf16 step at |y| ~
    4-8), mean 1e-5, inv 1e-4."""
    x, _, scale, bias = _ln_inputs(m, c, seed=0)
    y_k, mean_k, inv_k = layernorm_fwd_pallas(x, scale, bias, 1e-5, interpret=True)
    y, mean, inv = layernorm_fwd(_t(x), _t(scale), _t(bias), 1e-5)
    assert y.dtype == torch.bfloat16 and y.shape == (m, c)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_k, np.float32), rtol=0, atol=0.06)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_k), rtol=1e-4, atol=1e-4)


def test_layernorm_bwd_matches_pallas():
    """Plain K10 == ``layernorm_bwd_pallas`` (interpret mode) at (290, 256),
    with the JAX kernel test's tolerances: dx 0.06 absolute, dscale and
    dbias 2e-2 (the JAX kernel sums them block by block over its grid, the
    plain version over all rows at once)."""
    x, dy, scale, bias = _ln_inputs(290, 256, seed=1)
    _, mean, inv = _ln_jnp_fwd(x, scale, bias, 1e-5)
    dx_k, ds_k, db_k = layernorm_bwd_pallas(x, dy, mean, inv, scale, interpret=True)
    dx, ds, db = layernorm_bwd(_t(x), _t(dy), _t(mean), _t(inv), _t(scale))
    assert dx.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(dx_k, np.float32), rtol=0,
                               atol=0.06)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_k), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_k), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("m,c", [(37, 7), (5, 5000)])
def test_layernorm_bwd_matches_pallas_any_width(m, c):
    """Plain K10 == ``layernorm_bwd_pallas`` (interpret mode) at an odd C
    and at a C above 3072, with ``test_layernorm_bwd_matches_pallas``'s
    tolerances."""
    x, dy, scale, bias = _ln_inputs(m, c, seed=3)
    _, mean, inv = _ln_jnp_fwd(x, scale, bias, 1e-5)
    dx_k, ds_k, db_k = layernorm_bwd_pallas(x, dy, mean, inv, scale, interpret=True)
    dx, ds, db = layernorm_bwd(_t(x), _t(dy), _t(mean), _t(inv), _t(scale))
    assert dx.dtype == torch.bfloat16 and dx.shape == (m, c) and ds.shape == db.shape == (c,)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(dx_k, np.float32), rtol=0,
                               atol=0.06)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_k), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_k), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bf16", [False, True])
def test_layernorm_module_matches_jax(bf16):
    """The port's ``LayerNorm`` == the JAX ``models/common.py::LayerNorm``
    with the same parameters (lifted through ``jax_to_state_dict``), on an
    f32 (2, 5, 7, 96) input: the output and the gradients of the input,
    the scale and the bias, torch autograd against ``jax.vjp``. f32 branch:
    summation order, 1e-5 of the largest value. bf16 branch (K9/K10's
    plain versions behind ``LayerNormBF16``, the Pallas custom_vjp's jnp
    twin in JAX): the same arithmetic and rounding points; 1e-2 of the
    largest value covers one bf16 step of the output and of dx."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 96).astype(np.float32) * 3 + 1
    dy = rng.randn(2, 5, 7, 96).astype(np.float32)
    params = {"scale": (1 + 0.2 * rng.randn(96)).astype(np.float32),
              "bias": (0.1 * rng.randn(96)).astype(np.float32)}
    jmod = JLayerNorm(dtype=jnp.bfloat16 if bf16 else None)
    jy, vjp = jax.vjp(lambda p, x: jmod.apply({"params": p}, x), params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy, jy.dtype))

    port = LayerNorm(96, dtype=torch.bfloat16 if bf16 else None)
    port.load_state_dict(jax_to_state_dict(params))
    tx = torch.from_numpy(x).requires_grad_()
    y = port(tx)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert y.dtype == (torch.bfloat16 if bf16 else torch.float32)
    tol = 1e-2 if bf16 else 1e-5
    pairs = ((y.detach(), jy), (tx.grad, jgx), (port.weight.grad, jgp["scale"]),
             (port.bias.grad, jgp["bias"]))
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("c", [1, 7, 100, 3080, 5000])
def test_layernorm_bf16_module_any_width_matches_jax(c):
    """The port's ``LayerNorm(c, dtype=bf16)`` == JAX's
    ``LayerNorm(dtype=bf16)`` at every kind of width K9 and K10 take on the
    card (C = 1, odd, C % 8 != 0, above 3072 and above K10's ring): the
    output and the gradients of the input, the scale and the bias, with
    ``test_layernorm_module_matches_jax``'s bf16 tolerance (1e-2 of the
    largest value). The bf16 input is a view one element into its storage,
    so that ``LayerNormBF16`` copies it to a 16-byte boundary first, as it
    must before K10 on the card."""
    rng = np.random.RandomState(c)
    shape = (3, 5, c)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    params = {"scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
              "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    xb = jnp.asarray(x, jnp.bfloat16)
    jmod = JLayerNorm(dtype=jnp.bfloat16)
    jy, vjp = jax.vjp(lambda p, x: jmod.apply({"params": p}, x), params, xb)
    jgp, jgx = vjp(jnp.asarray(dy, jy.dtype))

    port = LayerNorm(c, dtype=torch.bfloat16)
    port.load_state_dict(jax_to_state_dict(params))
    store = torch.zeros(x.size + 1, dtype=torch.bfloat16)
    store[1:] = _t(xb).reshape(-1)
    store.requires_grad_()
    tx = store[1:].view(shape)
    assert tx.data_ptr() % 16 != 0
    y = port(tx)
    y.backward(torch.from_numpy(dy).to(y.dtype))
    assert y.dtype == torch.bfloat16 and y.shape == shape
    pairs = ((y.detach(), jy), (store.grad[1:].view(shape), jgx),
             (port.weight.grad, jgp["scale"]), (port.bias.grad, jgp["bias"]))
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        assert got.shape == want.shape
        assert np.abs(got.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()
