"""The scheduler's timestep-indexed API on the port against the JAX
package's: ``init_noise_sigma``, ``step`` at several timesteps (with and
without eta, under each prediction type) and ``sample`` from JAX's own
starting latent."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.diffusion.ddim import DDIMSchedule as JSchedule  # noqa: E402
from diffusiondepth_tpu_torch.diffusion.ddim import DDIMSchedule  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _draw(seed, shape=(2, 4, 6, 16)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("timestep,steps,eta", [
    (999, 20, 0.0), (500, 20, 0.0), (50, 20, 0.0), (0, 20, 0.0), (700, 50, 0.5), (25, 4, 1.0)])
def test_step_matches_jax(timestep, steps, eta, prediction_type):
    """step(model_output, timestep, sample, num_inference_steps) returns
    (prev_sample, pred_original) equal to JAX's within rtol 1e-5 and atol
    1e-5 (f32; the final step, whose previous timestep is below 0, takes
    final_alpha_cumprod); eta > 0 with the same variance noise."""
    j = JSchedule(prediction_type=prediction_type)
    p = DDIMSchedule(prediction_type=prediction_type)
    assert p.init_noise_sigma == j.init_noise_sigma == 1.0
    eps, x, vn = _draw(0), _draw(1), _draw(2)
    jout = j.step(jnp.asarray(eps), timestep, jnp.asarray(x), steps, eta=eta,
                  variance_noise=jnp.asarray(vn) if eta > 0 else None)
    pout = p.step(torch.from_numpy(eps), timestep, torch.from_numpy(x), steps, eta=eta,
                  variance_noise=torch.from_numpy(vn) if eta > 0 else None)
    for a, b in zip(pout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _denoise_np(x, t):
    return 0.3 * x + 1e-3 * t


@pytest.mark.parametrize("steps,biased", [(5, False), (20, True)])
def test_sample_matches_jax_from_its_latent(steps, biased):
    """sample at eta 0 from the latent JAX's sample draws (handed in with
    latent=), with the same denoise function: the final latent and every
    step's latent (return_trajectory) within rtol 1e-5 and atol 1e-5."""
    j, p = JSchedule(), DDIMSchedule()
    ts = j.biased_timesteps(steps) if biased else None
    key = jax.random.PRNGKey(3)
    shape = (2, 4, 6, 16)
    jfinal, jtraj = j.sample(lambda x, t: _denoise_np(x, t.astype(jnp.float32)), key, shape,
                             steps, return_trajectory=True, timesteps=ts)
    latent = torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))
    pfinal, ptraj = p.sample(lambda x, t: _denoise_np(x, t.float()), None, shape, steps,
                             return_trajectory=True, timesteps=ts, latent=latent)
    assert tuple(ptraj.shape) == (steps,) + shape == jtraj.shape
    np.testing.assert_allclose(ptraj.numpy(), np.asarray(jtraj), **TOL)
    np.testing.assert_allclose(pfinal.numpy(), np.asarray(jfinal), **TOL)
    plain = p.sample(lambda x, t: _denoise_np(x, t.float()), None, shape, steps,
                     timesteps=ts, latent=latent)
    torch.testing.assert_close(plain, pfinal)


def test_sample_draws_from_the_generator():
    """The starting latent and, at eta > 0, each step's variance noise come
    from the generator: one seed gives the same result twice; eta 0 and
    eta 1 differ; the starting latent drawn is the generator's first
    draw."""
    p = DDIMSchedule()
    shape = (1, 3, 5, 16)

    def run(seed, eta):
        g = torch.Generator().manual_seed(seed)
        return p.sample(lambda x, t: 0.1 * x, g, shape, 4, eta=eta)

    torch.testing.assert_close(run(0, 1.0), run(0, 1.0), rtol=0, atol=0)
    assert not torch.equal(run(0, 1.0), run(0, 0.0))
    first = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(run(0, 0.0), p.sample(lambda x, t: 0.1 * x, None, shape, 4,
                                                     latent=first), rtol=0, atol=0)
