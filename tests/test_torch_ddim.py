"""The port's DDIM scheduler against ``diffusiondepth_tpu/diffusion/ddim.py``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.diffusion.ddim import DDIMSchedule as JaxSchedule  # noqa: E402
from diffusiondepth_tpu_torch.diffusion.ddim import DDIMSchedule  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("steps,biased", [(20, False), (4, False), (20, True), (7, True)])
def test_inference_tables_match(steps, biased):
    """Timesteps and alpha tables are the same numpy construction: equal
    bit for bit; the four per-step scalars of the DDIM-step kernel equal
    the JAX head's jnp.sqrt stack to f32 rounding (1e-7)."""
    js, ps = JaxSchedule(clip_sample=False), DDIMSchedule(clip_sample=False)
    ts = js.biased_timesteps(steps) if biased else None
    pts = ps.biased_timesteps(steps) if biased else None
    jt, pt = js.inference_tables(steps, ts), ps.inference_tables(steps, pts)
    np.testing.assert_array_equal(np.asarray(jt.timesteps), pt.timesteps)
    np.testing.assert_array_equal(np.asarray(jt.alpha_prod_t), pt.alpha_prod_t)
    np.testing.assert_array_equal(np.asarray(jt.alpha_prod_prev), pt.alpha_prod_prev)
    jsched = jnp.stack([jnp.sqrt(jt.alpha_prod_t), jnp.sqrt(1.0 - jt.alpha_prod_t),
                        jnp.sqrt(jt.alpha_prod_prev), jnp.sqrt(1.0 - jt.alpha_prod_prev)],
                       axis=1)
    np.testing.assert_allclose(pt.sched(), np.asarray(jsched), rtol=1e-7, atol=0)


@pytest.mark.parametrize("a_t,a_prev", [(0.63, 0.89), (0.0047, 0.02), (0.9991, 1.0)])
def test_step_from_alphas_matches(a_t, a_prev):
    """One reverse step in f32: the same expression in both packages, to
    f32 rounding (1e-6 relative)."""
    rng = np.random.RandomState(0)
    eps = np.maximum(rng.randn(2, 8, 12, 16), 0).astype(np.float32)
    x = rng.randn(2, 8, 12, 16).astype(np.float32)
    jx, jx0 = JaxSchedule(clip_sample=False).step_from_alphas(
        jnp.asarray(eps), jnp.asarray(x), jnp.float32(a_t), jnp.float32(a_prev))
    px, px0 = DDIMSchedule(clip_sample=False).step_from_alphas(
        torch.from_numpy(eps), torch.from_numpy(x), torch.tensor(a_t, dtype=torch.float32),
        torch.tensor(a_prev, dtype=torch.float32))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(px0.numpy(), np.asarray(jx0), rtol=1e-6, atol=1e-6)


def test_twenty_step_trajectory_matches():
    """A full 20-step reverse trajectory with a fixed stand-in denoiser
    eps = relu(0.5 sin(x) + t/1000) (the real one is tested elsewhere):
    f32 to 1e-5 relative after 20 steps (1e-6 per step, compounded)."""
    rng = np.random.RandomState(1)
    x0 = rng.randn(2, 6, 10, 16).astype(np.float32)
    js, ps = JaxSchedule(clip_sample=False), DDIMSchedule(clip_sample=False)
    jt, pt = js.inference_tables(20), ps.inference_tables(20)

    jx = jnp.asarray(x0)
    for t, a, ap in zip(jt.timesteps, jt.alpha_prod_t, jt.alpha_prod_prev):
        eps = jnp.maximum(0.5 * jnp.sin(jx) + t.astype(jnp.float32) / 1000.0, 0.0)
        jx, _ = js.step_from_alphas(eps, jx, a, ap)

    px = torch.from_numpy(x0)
    ts = torch.from_numpy(pt.timesteps)
    at = torch.from_numpy(pt.alpha_prod_t)
    ap = torch.from_numpy(pt.alpha_prod_prev)
    for i in range(20):
        eps = torch.clamp_min(0.5 * torch.sin(px) + ts[i].float() / 1000.0, 0.0)
        px, _ = ps.step_from_alphas(eps, px, at[i], ap[i])
    assert np.abs(np.asarray(jx)).max() > 0.1
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
