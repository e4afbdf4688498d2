"""The port's other two window-attention routes against the JAX package:
the split q/k/v attention (plain version of kernel K8) against the JAX v2
Pallas kernel in interpret mode, and the einsum path of ``WindowMSA``
(``use_pallas`` training, ``fused_qkv_attention=False``) against the JAX
``WindowMSA`` einsum path, forward and gradients."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.models.backbones import swin as jswin  # noqa: E402
from diffusiondepth_tpu.ops.window_attention import (  # noqa: E402
    window_attention_pallas, window_attention_qkv_reference,
)
from diffusiondepth_tpu_torch.models.backbones import swin as pswin  # noqa: E402
from diffusiondepth_tpu_torch.ops.window_attention import (  # noqa: E402
    window_attention_einsum, window_attention_split,
)

torch.set_num_threads(1)


def _split_inputs(b, nw, h, with_mask, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, nw, h, 49, 32).astype(np.float32) for _ in range(3))
    bias = (rng.randn(h, 49, 49) * 0.1).astype(np.float32)
    # a distinct 0 / -100 mask per window, so the per-window indexing counts
    mask = rng.choice([0.0, -100.0], size=(nw, 49, 49)).astype(np.float32) if with_mask else None
    return q, k, v, bias, mask


@pytest.mark.parametrize("dtype,with_mask,nw", [
    (torch.float32, False, 2), (torch.float32, True, 9),
    (torch.bfloat16, False, 6), (torch.bfloat16, True, 5)])
def test_split_attention_matches_pallas(dtype, with_mask, nw):
    """Plain K8 == ``window_attention_pallas`` (interpret mode, window
    block 4, nW not always a multiple of it). f32: summation order, 1e-5.
    bf16: both round q * scale, the probabilities and the output at the
    same points; a sum in another order can move an output by one bf16
    step: 2e-2 of the largest value."""
    q, k, v, bias, mask = _split_inputs(2, nw, 3, with_mask, seed=nw)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(t, jdt) for t in (q, k, v))
    jm = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(window_attention_pallas(jq, jk, jv, jnp.asarray(bias), jm, 32 ** -0.5,
                                             win_block=4, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(t.astype(jnp.float32))).to(dtype)
                  for t in (jq, jk, jv))
    out = window_attention_split(tq, tk, tv, torch.from_numpy(bias),
                                 None if mask is None else torch.from_numpy(mask), 32 ** -0.5)
    assert out.dtype == dtype and out.shape == q.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2 * np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_mask", [False, True])
def test_einsum_core_matches_jax_spec(dtype, with_mask):
    """``window_attention_einsum`` == ``window_attention_qkv_reference``,
    the einsum of the JAX WindowMSA path, on the same qkv. f32: 1e-5 of
    the largest value. bf16: the same rounding points, so at most 0.1% of
    the outputs may differ, by at most 2e-3 of the largest value. K4's
    formulation (f32 logits) differs in over half of them."""
    rng = np.random.RandomState(3)
    qkv = rng.randn(2, 6, 49, 3 * 64).astype(np.float32)
    bias = (rng.randn(2, 49, 49) * 0.1).astype(np.float32)
    mask = rng.choice([0.0, -100.0], size=(6, 49, 49)).astype(np.float32) if with_mask else None
    jq = jnp.asarray(qkv, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    ref = np.asarray(window_attention_qkv_reference(
        jq, jnp.asarray(bias), None if mask is None else jnp.asarray(mask), 32 ** -0.5, 2),
        np.float32)
    out = window_attention_einsum(
        torch.from_numpy(np.array(jq.astype(jnp.float32))).to(dtype), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), 32 ** -0.5, 2).float().numpy()
    err = np.abs(out - ref)
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * np.abs(ref).max()
    else:
        assert (err > 0).mean() <= 1e-3 and err.max() <= 2e-3 * np.abs(ref).max()


def _msa_pair(dtype, c=64, heads=2, seed=0):
    """A JAX WindowMSA on its einsum path and the port's with the same
    weights (non-trivial biases)."""
    rng = np.random.RandomState(seed)
    jdt = None if dtype == torch.float32 else jnp.bfloat16
    jmod = jswin.WindowMSA(embed_dims=c, num_heads=heads, window_size=(7, 7),
                           fused_qkv_attention=False, dtype=jdt)
    x = rng.randn(2, 6, 49, c).astype(np.float32)
    init = jax.jit(lambda key, x: jmod.init(key, x, None, False))
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        dict(init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]))
    port = pswin.WindowMSA(c, heads, 7, None if jdt is None else dtype,
                           fused_qkv_attention=False)
    port.load_state_dict({
        "qkv.weight": torch.from_numpy(params["qkv"]["kernel"].T.copy()),
        "qkv.bias": torch.from_numpy(params["qkv"]["bias"]),
        "proj.weight": torch.from_numpy(params["proj"]["kernel"].T.copy()),
        "proj.bias": torch.from_numpy(params["proj"]["bias"]),
        "relative_position_bias_table": torch.from_numpy(params["relative_position_bias_table"]),
    })
    return jmod, params, port, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_einsum_window_msa_matches_jax(dtype, shifted):
    """The einsum path of the port's WindowMSA (eval and training mode) ==
    the JAX WindowMSA with ``fused_qkv_attention=False``. f32: summation
    order, 1e-5 of the largest value. bf16: the attention core keeps the
    JAX rounding points (``test_einsum_core_matches_jax_spec``), but the
    bf16 qkv and proj Linear layers of the two packages are not bit-equal,
    and a qkv value one bf16 step apart moves the output: 2e-2 of the
    largest value."""
    jmod, params, port, x = _msa_pair(dtype)
    mask = jswin.shifted_window_mask(14, 21, 7, 3) if shifted else None
    ref = np.asarray(jax.jit(lambda p, x: jmod.apply({"params": p}, x, mask, False))(
        params, jnp.asarray(x)), np.float32)
    tm = None if mask is None else torch.from_numpy(mask)
    tol = (1e-5 if dtype == torch.float32 else 2e-2) * np.abs(ref).max()
    for training in (False, True):
        port.train(training)
        with torch.no_grad():
            out = port(torch.from_numpy(x), tm)
        assert out.dtype == dtype
        assert np.abs(out.float().numpy() - ref).max() <= tol


def test_einsum_window_msa_gradients_match_jax():
    """Gradients of the einsum path (input, qkv weight, relative-position
    table) == ``jax.vjp`` of the JAX WindowMSA, f32, shifted windows: 1e-4
    of each gradient's largest value (summation order through softmax and
    two products)."""
    jmod, params, port, x = _msa_pair(torch.float32, seed=1)
    mask = jswin.shifted_window_mask(14, 21, 7, 3)
    dout = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    gp, gx = jax.jit(lambda p, x, d: jax.vjp(
        lambda p, x: jmod.apply({"params": p}, x, mask, False), p, x)[1](d))(
        params, jnp.asarray(x), jnp.asarray(dout))
    port.train()
    tx = torch.from_numpy(x).requires_grad_()
    port(tx, torch.from_numpy(mask)).backward(torch.from_numpy(dout))
    pairs = ((tx.grad, gx), (port.qkv.weight.grad, np.asarray(gp["qkv"]["kernel"]).T),
             (port.relative_position_bias_table.grad, gp["relative_position_bias_table"]))
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
