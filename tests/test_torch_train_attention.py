"""The backward of the port's window attention (plain version of kernel K7
behind ``WindowAttentionQKV``) against the JAX package's flash-style
backward kernel in interpret mode."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.ops.window_attention import (  # noqa: E402
    window_attention_qkv_bwd_pallas, window_attention_qkv_reference,
)
from diffusiondepth_tpu_torch.ops.window_attention import (  # noqa: E402
    WindowAttentionQKV, window_attention_bwd,
)

from test_torch_window_attention import _inputs  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype,with_mask,nw", [
    (torch.float32, False, 6), (torch.float32, True, 5),
    (torch.bfloat16, False, 6), (torch.bfloat16, True, 5)])
def test_bwd_matches_pallas(dtype, with_mask, nw):
    """Plain K7 == ``window_attention_qkv_bwd_pallas`` (interpret, window
    tile 4, nW not a multiple of it). f32: summation order (dqkv 1e-4 of
    its largest value, dbias 1e-4). bf16: the two round at the same points
    (q * scale, P and dS in bf16, dqkv in bf16), so dqkv may move by one
    bf16 step (2e-2 of the largest value); dbias sums unrounded f32 dS
    (1e-2)."""
    heads = 2
    qkv, bias, mask, scale = _inputs(2, nw, heads, 32, with_mask, seed=3)
    dout = np.random.RandomState(4).randn(2, nw, 49, heads * 32).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq = jnp.asarray(qkv, jdt)
    jo = jnp.asarray(dout, jdt)
    jm = None if mask is None else jnp.asarray(mask)
    jdq, jdb = window_attention_qkv_bwd_pallas(jq, jnp.asarray(bias), jm, jo, scale, heads,
                                               win_tile=4, interpret=True)
    dq, db = window_attention_bwd(
        torch.from_numpy(np.array(jq.astype(jnp.float32))).to(dtype), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(np.array(jo.astype(jnp.float32))).to(dtype), scale, heads)
    jdq = np.asarray(jdq, np.float32)
    jdb = np.asarray(jdb)
    tq, tb = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 1e-2)
    assert np.abs(dq.float().numpy() - jdq).max() <= tq * np.abs(jdq).max()
    assert np.abs(db.numpy() - jdb).max() <= tb * np.abs(jdb).max()


def test_function_gradients_match_autodiff_of_reference():
    """WindowAttentionQKV's gradients (qkv and the relative-position bias,
    none for the mask) == ``jax.grad`` of the einsum spec in f32 (1e-4 of
    the largest value)."""
    heads = 2
    qkv, bias, mask, scale = _inputs(2, 5, heads, 32, True, seed=5)
    dout = np.random.RandomState(6).randn(2, 5, 49, heads * 32).astype(np.float32)

    def loss(q, b):
        return jnp.sum(window_attention_qkv_reference(q, b, jnp.asarray(mask), scale, heads)
                       * dout)

    jq, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    tq = torch.from_numpy(qkv).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    tm = torch.from_numpy(mask).requires_grad_()
    out = WindowAttentionQKV.apply(tq, tb, tm, scale, heads)
    out.backward(torch.from_numpy(dout))
    assert tm.grad is None
    for t, j in ((tq.grad, jq), (tb.grad, jb)):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def _dist(a, b):
    """RMS distance normalised by the reference's RMS (the JAX accuracy
    gate's measure)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-8))


@pytest.mark.parametrize("with_mask", [False, True])
def test_bwd_passes_accuracy_gate(with_mask):
    """The bf16 plain K7 and the JAX kernel (interpret mode) against the
    f32 autodiff oracle of the einsum spec, dqkv and dbias each within 2x
    the RMS distance of the spec's own bf16 autodiff + 0.05 (the JAX
    accuracy gate of tests/test_fused_denoiser.py, applied to the
    attention backward)."""
    heads = 2
    qkv, bias, mask, scale = _inputs(2, 5, heads, 32, with_mask, seed=7)
    dout = np.random.RandomState(8).randn(2, 5, 49, heads * 32).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    jq = jnp.asarray(qkv, jnp.bfloat16)
    jo = jnp.asarray(dout, jnp.bfloat16)

    def spec_vjp(dt):
        _, vjp = jax.vjp(lambda q, b: window_attention_qkv_reference(q, b, jm, scale, heads),
                         jq.astype(dt), jnp.asarray(bias))
        return vjp(jo.astype(dt))

    oracle, twin = spec_vjp(jnp.float32), spec_vjp(jnp.bfloat16)
    kern = window_attention_qkv_bwd_pallas(jq, jnp.asarray(bias), jm, jo, scale, heads,
                                           interpret=True)
    port = window_attention_bwd(
        torch.from_numpy(np.array(jq.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(bias), None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(np.array(jo.astype(jnp.float32))).to(torch.bfloat16), scale, heads)
    for i in range(2):
        o, tw = oracle[i], twin[i]
        for got in (port[i].float().numpy(), kern[i]):
            assert _dist(got, o) < 2 * _dist(tw, o) + 0.05, (i, _dist(got, o), _dist(tw, o))
