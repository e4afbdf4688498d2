"""The concat ('bins') heads on the port against the JAX package's:
``DDIMDepthEstimate_Swin`` through ``make_eval_step`` in f32,
``DDIMDepthEstimate_Swin_Bins_ADDVis``'s ``pred_inter``, and the concat
denoiser under the bf16 policy, which stays on the module path as in
JAX."""

import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.training.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch import make_eval_step  # noqa: E402

from test_torch_support import (  # noqa: E402
    FixedLatent, init_latent, jax_model, make_batch, module_variables, port_model, rel_err,
    torch_batch,
)

torch.set_num_threads(1)

_State = collections.namedtuple("_State", "params batch_stats")
HEAD = "DDIMDepthEstimate_Swin"


def _variables(model, batch, seed=0):
    return module_variables(model, batch, seed=seed, train=False,
                            init_latent=init_latent(0, batch))


def test_concat_head_eval_step_matches_jax_f32():
    """pred and the metric row of make_eval_step with swin_micro under
    DDIMDepthEstimate_Swin equal JAX's at O0, same weights, batch and
    starting latent (4 steps): rtol 1e-3 and atol 1e-3, as the flagship's
    eval test. The concat convs are upsample_fuse.convA (2C -> C) and
    .convB."""
    batch = make_batch(0)
    lat = init_latent(1, batch)
    jm = jax_model(steps=4, head=HEAD)
    variables = _variables(jm, batch)
    jstep = jax_make_eval_step(FixedLatent(jm, jnp.asarray(lat)))
    jpred, jmet, _ = jstep(_State(variables["params"], variables["batch_stats"]),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    port = port_model(variables, steps=4, head=HEAD)
    den = port.depth_head.model
    assert den.fuse == "upsample_concat" and not hasattr(den, "upsample_add")
    assert den.upsample_fuse.convA.conv.weight.shape == (256, 512, 3, 3)
    ppred, pmet, _ = make_eval_step(port)(torch_batch(batch), init_latent=torch.from_numpy(lat))
    assert ppred.shape == tuple(jpred.shape)
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pmet.numpy(), np.asarray(jmet), rtol=1e-3, atol=1e-6)


def test_bins_vis_pred_inter_matches_jax():
    """DDIMDepthEstimate_Swin_Bins_ADDVis returns pred_inter (steps, B, H,
    W, 1), each step's latent decoded with the running statistics: equal to
    the JAX head's trajectory decoded the same way within rtol 1e-3 and
    atol 1e-3 (3 steps, f32); its last step is pred. (The JAX vis head's own
    pred_inter reshapes the decoded maps to the latent's size and raises;
    the trajectory comes from its _sample.)"""
    batch = make_batch(2, b=1)
    lat = init_latent(3, batch)
    jm = jax_model(steps=3, head="DDIMDepthEstimate_Swin_Bins_ADDVis")
    variables = _variables(jax_model(steps=3, head=HEAD), batch, seed=4)

    def jax_vis(mdl, rgb, gt, lat):
        head = mdl.depth_head
        gt_t = head.depth_transform.t(gt, False)
        cond = head.model.upsample_condition(
            head._fpn_condition(mdl.depth_backbone(rgb, False), False), gt_t.shape[1:3])
        _, traj = head._sample(cond, lat.shape, None, init_latent=lat)
        dec = head.depth_transform.inv_t(traj.reshape((-1,) + traj.shape[2:]), False)
        return dec.reshape(traj.shape[:2] + dec.shape[1:])

    jinter = jax.jit(lambda v, r, g, l: jm.apply(v, r, g, l, method=jax_vis))(
        variables, jnp.asarray(batch["rgb"]), jnp.asarray(batch["gt"]), jnp.asarray(lat))
    port = port_model(variables, steps=3, head="DDIMDepthEstimate_Swin_Bins_ADDVis")
    with torch.no_grad():
        out = port(torch_batch(batch), init_latent=torch.from_numpy(lat))
    assert tuple(out["pred_inter"].shape) == (3, 1, 64, 96, 1) == jinter.shape
    np.testing.assert_allclose(out["pred_inter"].numpy(), np.asarray(jinter),
                               rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out["pred_inter"][-1], out["pred"])


def test_concat_denoiser_bf16_matches_jax():
    """Under the bf16 policy the concat denoiser is not fused in either
    package (fused_active is false at a latent height that is a multiple
    of 8) and one call on the JAX condition map agrees with JAX's within
    2e-2 of its largest value (8-bit rounding at other points)."""
    batch = make_batch(5)
    jm = jax_model(steps=2, bf16=True, head=HEAD)
    variables = _variables(jm, batch, seed=6)
    lat = init_latent(7, batch)

    def jax_parts(mdl, rgb, gt, lat):
        head = mdl.depth_head
        gt_t = head.depth_transform.t(gt, False)
        cond = head.model.upsample_condition(
            head._fpn_condition(mdl.depth_backbone(rgb, False), False), gt_t.shape[1:3])
        return cond, head.model(lat, 500, cond)

    jcond, jeps = jax.jit(lambda v, *a: jm.apply(v, *a, method=jax_parts))(
        variables, jnp.asarray(batch["rgb"]), jnp.asarray(batch["gt"]), jnp.asarray(lat))
    port = port_model(variables, steps=2, opt_level="O1", head=HEAD)
    den = port.depth_head.model
    assert not den.fused_active(lat.shape[1]) and lat.shape[1] % 8 == 0
    with torch.no_grad():
        eps = den(torch.from_numpy(lat), 500,
                  torch.from_numpy(np.asarray(jcond, np.float32)).to(torch.bfloat16))
    assert eps.dtype == torch.bfloat16
    assert rel_err(eps.float().numpy(), np.asarray(jeps, np.float32)) < 2e-2
