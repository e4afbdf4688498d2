"""The ResNet and MPViT models of the port against the JAX package's:
``mmbev_res18`` under ``DDIMDepthEstimate_Res`` (and ``_ResVis``) and
``mpvit_tiny`` under ``DDIMDepthEstimate_MPVIT_ADDHAHI``, through
``make_eval_step`` in f32, module by module under the bf16 policy, and one
``make_train_step`` step in f32 (loss, every gradient leaf, the BatchNorm
statistics after the step)."""

import collections
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.training.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch import (  # noqa: E402
    LossComputer, make_eval_step, make_optimizer, make_train_step,
)

from test_torch_support import (  # noqa: E402
    Draws, FixedLatent, close_leaves, init_latent, jax_model, make_batch, module_variables,
    named, port_config, port_model, rel_err, torch_batch,
)

torch.set_num_threads(1)

_State = collections.namedtuple("_State", "params batch_stats")
FAMILIES = ["res18", "mpvit_tiny"]


def _variables(model, batch, seed=0):
    return module_variables(model, batch, seed=seed, train=False,
                            init_latent=init_latent(0, batch))


def _jax_eval(model, variables, batch, lat):
    step = jax_make_eval_step(FixedLatent(model, jnp.asarray(lat)))
    return step(_State(variables["params"], variables["batch_stats"]),
                {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))


@pytest.mark.parametrize("family", FAMILIES)
def test_eval_step_matches_jax_f32(family):
    """pred and the 8-metric row of make_eval_step equal the JAX
    make_eval_step's at opt_level O0, with the same weights, batch and
    starting latent (4 DDIM steps): 1e-3 relative per element, as the
    flagship's eval test states (sums in another order, grown through the
    steps and the reciprocal decode)."""
    batch = make_batch(0)
    lat = init_latent(1, batch)
    model = jax_model(steps=4, family=family)
    variables = _variables(model, batch)
    jpred, jmet, _ = _jax_eval(model, variables, batch, lat)

    port = port_model(variables, steps=4, family=family)
    assert not port.depth_head.model.fused_active(lat.shape[1])  # f32: the module path
    ppred, pmet, _ = make_eval_step(port)(torch_batch(batch), init_latent=torch.from_numpy(lat))
    assert ppred.shape == tuple(jpred.shape)
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pmet.numpy(), np.asarray(jmet), rtol=1e-3, atol=1e-6)


def test_res_vis_pred_inter_matches_jax():
    """DDIMDepthEstimate_ResVis returns pred_inter (steps, B, H, W, 1), each
    step's latent decoded by inv_t with the running statistics: equal to
    the JAX head's trajectory decoded the same way at 1e-3 relative per
    element (3 steps, f32); its last step is pred. (The JAX head's own
    pred_inter reshapes the decoded maps to the latent's size, which
    inv_t doubles, and raises; the trajectory comes from its _sample.)"""
    batch = make_batch(3, b=1)
    lat = init_latent(4, batch)
    model = jax_model(steps=3, family="res18", head="DDIMDepthEstimate_ResVis")
    # the _Res head's tree: vis adds no parameter, and the Vis head's init raises
    variables = _variables(jax_model(steps=3, family="res18"), batch, seed=5)

    def jax_vis(mdl, rgb, gt, lat):
        head = mdl.depth_head
        gt_t = head.depth_transform.t(gt, False)
        cond = head.model.upsample_condition(
            head._fpn_condition(mdl.depth_backbone(rgb, False), False), gt_t.shape[1:3])
        _, traj = head._sample(cond, lat.shape, None, init_latent=lat)
        dec = head.depth_transform.inv_t(traj.reshape((-1,) + traj.shape[2:]), False)
        return dec.reshape(traj.shape[:2] + dec.shape[1:])

    jinter = jax.jit(lambda v, r, g, l: model.apply(v, r, g, l, method=jax_vis))(
        variables, jnp.asarray(batch["rgb"]), jnp.asarray(batch["gt"]), jnp.asarray(lat))

    port = port_model(variables, steps=3, family="res18", head="DDIMDepthEstimate_ResVis")
    with torch.no_grad():
        out = port(torch_batch(batch), init_latent=torch.from_numpy(lat))
    assert tuple(out["pred_inter"].shape) == (3, 1, 64, 96, 1) == jinter.shape
    np.testing.assert_allclose(out["pred_inter"].numpy(), np.asarray(jinter),
                               rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(out["pred_inter"][-1], out["pred"])


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_modules_match_jax(family):
    """Under the bf16 policy (O1), module by module from the JAX modules'
    own bf16 inputs: the condition map at latent resolution (neck, FPN,
    upsample) from the JAX pyramid, and one denoiser call on the JAX
    condition map (the fused chain's plain versions in both heads: four
    links for the Res head's 'add', against JAX's module path, and six for
    MPViT's 'upsample_add'); res18's pyramid too (mpvit_tiny's is held
    module by module in test_torch_mpvit.py). Each within 2e-2 of the JAX
    map's largest value (8-bit rounding at other points)."""
    batch = make_batch(6)
    model = jax_model(steps=2, bf16=True, family=family)
    variables = _variables(model, batch, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lat = init_latent(8, batch)

    def jax_parts(mdl, rgb, gt, lat):
        fp = mdl.depth_backbone(rgb, False)
        head = mdl.depth_head
        gt_t = head.depth_transform.t(gt, False)
        fpn = head.hahineck(fp, False) if head.use_hahi else fp
        cond = head.model.upsample_condition(head._fpn_condition(fpn, False), gt_t.shape[1:3])
        return fp, cond, head.model(lat, 500, cond)

    jfp, jcond, jeps = jax.jit(lambda v, *a: model.apply(v, *a, method=jax_parts))(
        variables, jb["rgb"], jb["gt"], jnp.asarray(lat))

    port = port_model(variables, steps=2, opt_level="O1", family=family)
    head = port.depth_head
    assert head.model.fused_active(lat.shape[1])  # 'add' and 'upsample_add' alike

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    with torch.no_grad():
        tb = torch_batch(batch)
        gt_t = head.depth_transform.t(tb["gt"])
        fp = [t(f) for f in jfp]
        cond = head.model.upsample_condition(
            head.fpn_condition(head.hahineck(fp) if head.use_hahi else fp), gt_t.shape[1:3])
        eps = head.model(torch.from_numpy(lat), 500, t(jcond))
        pyramid = port.depth_backbone(tb["rgb"]) if family == "res18" else []
    for a, b in [(cond, jcond), (eps, jeps)] + list(zip(pyramid, jfp)):
        assert a.dtype == torch.bfloat16
        assert rel_err(a.float().numpy(), np.asarray(b, np.float32)) < 2e-2


@pytest.mark.parametrize("family,hw", [("res18", (64, 96)), ("mpvit_tiny", (32, 48))])
def test_train_step_matches_jax(family, hw, monkeypatch):
    """One Adam step of make_train_step (batch 2, 2 DDIM steps, f32; mpvit_tiny
    at 32x48 to keep its JAX backward short) against JAX's loss and
    gradients with the same starting latent, DDIM noise and timesteps.

    The loss terms within 2e-3. The gradients of these models are less
    well conditioned in f32 than the flagship's: JAX's own gradient moves
    by more than 2e-3 of many leaves, by several percent of some, when the
    two samples swap places (the same function summed in another order;
    the test measures this movement for each leaf), through the
    train-mode BatchNorms, GroupNorms and two sampler steps. So each leaf
    is held within 1e-2 of its largest value or twice JAX's own movement,
    whichever is larger, and at least half the leaves within the flagship
    test's 2e-3.
    BatchNorm statistics after the step within 1e-5: for res18 every one of
    them moves as flax's do; under MPViT's norm_eval the backbone's stay
    bit-unchanged (so do JAX's), while the head's move."""
    steps = 2
    batch = make_batch(9, h=hw[0], w=hw[1])
    jm = jax_model(steps=steps, family=family)
    variables = _variables(jm, batch, seed=10)
    lat = init_latent(11, batch)
    rng = np.random.RandomState(12)
    noise = rng.randn(*lat.shape).astype(np.float32)
    ts = np.array([413, 77], np.int64)
    kw = dict(batch_size=2, accum_steps=1, max_depth=88.0)
    jcfg = dataclasses.replace(jconfig.Config(), **kw)
    pcfg = dataclasses.replace(port_config(steps, family=family), **kw)

    draws = Draws(noise, ts)
    monkeypatch.setattr(jhead, "jax", draws)
    lc = JLossComputer(jcfg)

    def loss_fn(p, jb, lat, noise, ts):
        draws.noise, draws.timesteps = noise, ts
        out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb,
                            train=True, init_latent=lat,
                            rngs={"diffusion": jax.random.PRNGKey(0),
                                  "dropout": jax.random.PRNGKey(1)},
                            mutable=["batch_stats"])
        s, v = lc(jb, out)
        return s / 2, (mut["batch_stats"], v / 2)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, (jstats, jval)), jgrads = grad_fn(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()}, lat, noise, ts)
    _, jgrads_swapped = grad_fn(variables["params"],
                                {k: jnp.asarray(v[::-1]) for k, v in batch.items()},
                                lat[::-1], noise[::-1], ts[::-1])

    port = port_model(variables, steps=steps, family=family)
    head = port.depth_head
    sample, ddim_loss = head._sample, head._ddim_loss
    monkeypatch.setattr(head, "_sample", lambda c, shape, g=None, i=None:
                        sample(c, shape, g, torch.from_numpy(lat)))
    monkeypatch.setattr(head, "_ddim_loss", lambda r, c, g=None:
                        ddim_loss(r, c, g, noise=torch.from_numpy(noise),
                                  timesteps=torch.from_numpy(ts)))
    before = {n: b.clone() for n, b in port.named_buffers()}
    step = make_train_step(port, LossComputer(pcfg), make_optimizer(pcfg, 10, port))
    loss, lval, met = step(torch_batch(batch))

    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=2e-3)
    np.testing.assert_allclose(lval.numpy(), np.asarray(jval), rtol=2e-3)
    assert bool(torch.isfinite(met).all())
    jg, js = named(jgrads), named(jgrads_swapped)
    floor = 1e-4 * max(np.abs(v).max() for v in jg.values())
    errs = []
    for n, p in port.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        scale = max(np.abs(jg[n]).max(), floor)
        err = np.abs(got - jg[n]).max() / scale
        jax_noise = np.abs(js[n] - jg[n]).max() / scale
        assert err <= max(1e-2, 2 * jax_noise), (n, err, jax_noise)
        errs.append(err)
    assert len(errs) == len(jg) and np.median(errs) <= 2e-3, np.median(errs)

    jstats = jax.tree_util.tree_map(np.asarray, jstats)
    stats = {n: b.numpy() for n, b in port.named_buffers() if n.endswith(("mean", "var"))}
    ref = {k: v for k, v in named(variables["params"], jstats).items()
           if k.endswith(("mean", "var"))}
    assert set(stats) == set(ref)
    close_leaves(stats, ref, 1e-5)
    backbone = [n for n in stats if n.startswith("depth_backbone.")]
    head_stats = [n for n in stats if n.startswith("depth_head.")]
    assert backbone and head_stats
    moved = {n: not np.array_equal(stats[n], before[n].numpy()) for n in stats}
    if family == "mpvit_tiny":
        assert not any(moved[n] for n in backbone)
        for n in backbone:
            np.testing.assert_array_equal(ref[n], before[n].numpy())
    else:
        assert all(moved[n] for n in backbone)
    assert all(moved[n] for n in head_stats)
