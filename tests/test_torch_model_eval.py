"""The port's eval slice against the JAX package: the whole of
``make_eval_step`` in f32, and the bf16 policy module by module."""

import collections

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.training.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch import make_eval_step  # noqa: E402

from test_torch_support import (  # noqa: E402
    init_latent, jax_model, jax_variables, make_batch, port_model, rel_err,
    torch_batch,
)

torch.set_num_threads(1)

_State = collections.namedtuple("_State", "params batch_stats")


class _FixedLatent:
    """Hands the JAX eval step's ``model.apply`` a fixed starting latent."""

    def __init__(self, model, latent):
        self.model = model
        self.latent = latent

    def apply(self, variables, batch, **kw):
        return self.model.apply(variables, batch, init_latent=self.latent, **kw)


def test_eval_step_matches_jax_f32():
    """pred and the 8-metric row of the port's make_eval_step equal the JAX
    make_eval_step's at opt_level O0, with the same weights, batch and
    starting latent (4 DDIM steps). Tolerance 1e-3 relative per element
    (random weights put pred between 1e-3 and the decode's 1e6 ceiling):
    both run f32, sums are taken in another order (convolutions, attention,
    GroupNorm) and the differences grow through the steps and the
    reciprocal decode."""
    batch = make_batch(0)
    lat = init_latent(1, batch)
    model = jax_model(steps=4)
    variables = jax_variables(model, batch)

    jstep = jax_make_eval_step(_FixedLatent(model, jnp.asarray(lat)))
    state = _State(variables["params"], variables["batch_stats"])
    jpred, jmet, _ = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))

    pstep = make_eval_step(port_model(variables, steps=4))
    ppred, pmet, _ = pstep(torch_batch(batch), init_latent=torch.from_numpy(lat))

    assert ppred.shape == tuple(jpred.shape)
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pmet.numpy(), np.asarray(jmet), rtol=1e-3, atol=1e-6)


def test_bf16_modules_match_jax():
    """Under the bf16 policy (O1) the backbone pyramid and the condition
    map match the JAX modules within bf16 noise (2e-2 of each map's largest
    value: bf16 keeps 8 bits, rounded at other points in the two packages).
    pred is not compared: with random weights bf16 noise is amplified
    chaotically through the steps and the reciprocal decode."""
    batch = make_batch(2)
    model = jax_model(steps=2, bf16=True)
    variables = jax_variables(model, batch, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_feats(mdl, rgb, gt):
        fp = mdl.depth_backbone(rgb, False)
        head = mdl.depth_head
        gt_t = head.depth_transform.t(gt, False)
        cond = head._fpn_condition(head.hahineck(fp, False), False)
        return fp, head.model.upsample_condition(cond, gt_t.shape[1:3])

    jfp, jcond = model.apply(variables, jb["rgb"], jb["gt"], method=jax_feats)

    port = port_model(variables, steps=2, opt_level="O1")
    with torch.no_grad():
        tb = torch_batch(batch)
        fp = port.depth_backbone(tb["rgb"])
        head = port.depth_head
        gt_t = head.depth_transform.t(tb["gt"])
        cond = head.model.upsample_condition(
            head.fpn_condition(head.hahineck(fp)), gt_t.shape[1:3])

    for a, b in zip(fp, jfp):
        assert a.dtype == torch.bfloat16
        assert rel_err(a.float().numpy(), np.asarray(b, np.float32)) < 2e-2
    assert rel_err(cond.float().numpy(), np.asarray(jcond, np.float32)) < 2e-2
