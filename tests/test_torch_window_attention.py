"""The port's window attention (plain version of kernel K4, the arithmetic
the CUDA kernel reproduces) against the JAX fused-input Pallas kernel in
interpret mode and its einsum spec."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.ops.window_attention import (  # noqa: E402
    window_attention_qkv_pallas, window_attention_qkv_reference,
)
from diffusiondepth_tpu_torch.ops.window_attention import window_attention  # noqa: E402

torch.set_num_threads(1)


def _inputs(b, nw, heads, d, with_mask, seed=0):
    rng = np.random.RandomState(seed)
    n, c = 49, heads * d
    qkv = rng.randn(b, nw, n, 3 * c).astype(np.float32)
    bias = (rng.randn(heads, n, n) * 0.1).astype(np.float32)
    mask = (rng.choice([0.0, -100.0], size=(nw, n, n)).astype(np.float32)
            if with_mask else None)
    return qkv, bias, mask, d ** -0.5


def _port(qkv, bias, mask, scale, heads, dtype):
    out = window_attention(torch.from_numpy(qkv).to(dtype), torch.from_numpy(bias),
                           None if mask is None else torch.from_numpy(mask), scale, heads)
    return out.float().numpy()


@pytest.mark.parametrize("b,nw,heads,d,with_mask", [
    (2, 13, 6, 32, False),
    (2, 13, 6, 32, True),
    (1, 5, 4, 32, True),    # nW not a multiple of the Pallas window tile
    (2, 8, 2, 16, False),
])
def test_f32_matches_pallas_and_reference(b, nw, heads, d, with_mask):
    """f32: the port == the Pallas kernel (interpret, window tile 4) and the
    einsum spec, to f32 summation order (2e-5)."""
    qkv, bias, mask, scale = _inputs(b, nw, heads, d, with_mask)
    jm = None if mask is None else jnp.asarray(mask)
    ker = window_attention_qkv_pallas(jnp.asarray(qkv), jnp.asarray(bias), jm, scale,
                                      heads, win_tile=4, interpret=True)
    ref = window_attention_qkv_reference(jnp.asarray(qkv), jnp.asarray(bias), jm, scale, heads)
    out = _port(qkv, bias, mask, scale, heads, torch.float32)
    np.testing.assert_allclose(out, np.asarray(ker), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("with_mask,nw", [(False, 6), (True, 6), (True, 5)])
def test_bf16_matches_pallas(with_mask, nw):
    """bf16: the port rounds where the Pallas kernel does (q * scale, the
    probabilities, the output), so the two differ by f32 summation order
    only, which can move an output by one bf16 step: atol 2e-2."""
    heads = 4
    qkv, bias, mask, scale = _inputs(1, nw, heads, 32, with_mask, seed=1)
    qb = jnp.asarray(qkv, jnp.bfloat16)
    jm = None if mask is None else jnp.asarray(mask)
    ker = window_attention_qkv_pallas(qb, jnp.asarray(bias), jm, scale, heads,
                                      win_tile=4, interpret=True)
    out = _port(np.array(qb.astype(jnp.float32)), bias, mask, scale, heads, torch.bfloat16)
    np.testing.assert_allclose(out, np.asarray(ker, np.float32), rtol=0, atol=2e-2)


def test_bf16_matches_reference_spec():
    """bf16 against the einsum spec, whose logits are bf16 (the port's are
    f32): the JAX test's tolerance for the Pallas kernel vs the spec, 3e-2."""
    heads = 4
    qkv, bias, _, _ = _inputs(1, 6, heads, 32, False, seed=2)
    qb = jnp.asarray(qkv, jnp.bfloat16)
    ref = window_attention_qkv_reference(qb, jnp.asarray(bias), None, 0.17, heads)
    out = _port(np.array(qb.astype(jnp.float32)), bias, None, 0.17, heads, torch.bfloat16)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), rtol=3e-2, atol=3e-2)
