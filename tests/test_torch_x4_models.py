"""``Diffusion_DCx4base_`` (the X4 depth transform, a quarter-resolution
latent) on the port against the JAX package's: ``make_eval_step`` in f32
on ``mmbev_res18`` + ``DDIMDepthEstimate_Res`` (the 'add' head, whose
condition map is resized to the X4 latent) and on ``swin_micro`` +
``DDIMDepthEstimate_Swin_ADDHAHI``; one ``make_train_step`` step of the
Swin model; and the widths both packages refuse."""

import collections
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models import diffusion_model as jdm  # noqa: E402
from diffusiondepth_tpu.models.backbones import swin as jswin  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.training.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch import (  # noqa: E402
    LossComputer, build_model, make_eval_step, make_optimizer, make_train_step,
)
from diffusiondepth_tpu_torch.models.diffusion_model import X4_DEPTH_TRANSFORM  # noqa: E402
from diffusiondepth_tpu_torch.models.depth_transform import (  # noqa: E402
    DeepDepthTransformWithUpsamplingX4,
)
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import (  # noqa: E402
    Draws, FixedLatent, close_leaves, jax_model, make_batch, module_variables, named,
    port_config, torch_batch,
)

torch.set_num_threads(1)

_State = collections.namedtuple("_State", "params batch_stats")


def x4_latent(seed, batch):
    b, h, w, _ = batch["gt"].shape
    return np.random.RandomState(seed).randn(b, -(-h // 4), -(-w // 4), 16).astype(np.float32)


def jax_x4(steps, family):
    return jax_model(steps=steps, family=family).clone(depth_transform_cfg=X4_DEPTH_TRANSFORM)


def x4_config(steps, family, **kw):
    return dataclasses.replace(port_config(steps, family=family),
                               model_name="Diffusion_DCx4base_", **kw)


def port_x4(variables, steps, family):
    model = build_model(x4_config(steps, family), device="cpu")
    model.load_state_dict(jax_to_state_dict(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def _variables(model, batch, seed=0):
    return module_variables(model, batch, seed=seed, train=False,
                            init_latent=x4_latent(0, batch))


@pytest.mark.parametrize("family,hw", [("res18", (32, 48)), ("swin", (64, 96))])
def test_x4_eval_step_matches_jax_f32(family, hw):
    """pred and the metric row of make_eval_step equal JAX's at O0 with the
    same weights, batch and quarter-resolution starting latent (4 steps):
    rtol 1e-3 and atol 1e-3, the tolerance of the flagship's eval test
    (sums in another order, grown through the steps and the reciprocal
    decode). The port builds the X4 transform for this model name."""
    batch = make_batch(0, h=hw[0], w=hw[1])
    lat = x4_latent(1, batch)
    jm = jax_x4(4, family)
    variables = _variables(jm, batch)
    jstep = jax_make_eval_step(FixedLatent(jm, jnp.asarray(lat)))
    jpred, jmet, _ = jstep(_State(variables["params"], variables["batch_stats"]),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    port = port_x4(variables, 4, family)
    assert isinstance(port.depth_head.depth_transform, DeepDepthTransformWithUpsamplingX4)
    ppred, pmet, _ = make_eval_step(port)(torch_batch(batch), init_latent=torch.from_numpy(lat))
    assert ppred.shape == tuple(jpred.shape) == batch["gt"].shape
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pmet.numpy(), np.asarray(jmet), rtol=1e-3, atol=1e-6)


def test_res_condition_reaches_the_x4_latent():
    """The Res head's 'add' denoiser takes a condition map at the latent's
    size. Under the X4 transform the FPN's map (at half resolution) is
    resized to the quarter-resolution latent as the JAX head resizes it
    (bilinear, align_corners): within 1e-5."""
    batch = make_batch(2, b=1, h=32, w=48)
    jm = jax_x4(2, "res18")
    variables = _variables(jm, batch, seed=1)

    def jax_cond(mdl, rgb, gt):
        head = mdl.depth_head
        gt_t = head.depth_transform.t(gt, False)
        cond = head._fpn_condition(mdl.depth_backbone(rgb, False), False)
        return cond, head.model.upsample_condition(cond, gt_t.shape[1:3])

    jcond, jlat_cond = jax.jit(lambda v, r, g: jm.apply(v, r, g, method=jax_cond))(
        variables, jnp.asarray(batch["rgb"]), jnp.asarray(batch["gt"]))
    port = port_x4(variables, 2, "res18")
    with torch.no_grad():
        tb = torch_batch(batch)
        head = port.depth_head
        gt_t = head.depth_transform.t(tb["gt"])
        cond = head.fpn_condition(port.depth_backbone(tb["rgb"]))
        lat_cond = head.model.upsample_condition(cond, gt_t.shape[1:3])
    assert tuple(cond.shape[1:3]) == (16, 24) and tuple(gt_t.shape[1:3]) == (8, 12)
    assert lat_cond.shape == jlat_cond.shape == (1, 8, 12, 256)
    np.testing.assert_allclose(lat_cond.numpy(), np.asarray(jlat_cond), rtol=1e-5, atol=1e-5)


def test_x4_train_step_matches_jax(monkeypatch):
    """One Adam step of make_train_step on swin_micro under the X4
    transform (batch 2, 2 DDIM steps, f32) against JAX's loss and
    gradients with the same starting latent, DDIM noise and timesteps,
    drop-path off: the loss terms within rtol 2e-3, every gradient leaf
    within 2e-3 of its largest value, the BatchNorm statistics after the
    step within 1e-5, as the flagship's training test holds them."""
    steps = 2
    batch = make_batch(3)
    jm = jax_x4(steps, "swin")
    variables = _variables(jm, batch, seed=4)
    lat = x4_latent(5, batch)
    noise = np.random.RandomState(6).randn(*lat.shape).astype(np.float32)
    ts = np.array([413, 77], np.int64)
    kw = dict(batch_size=2, accum_steps=1, max_depth=88.0)
    jcfg = dataclasses.replace(jconfig.Config(), **kw)
    pcfg = x4_config(steps, "swin", **kw)

    draws = Draws(noise, ts)
    monkeypatch.setattr(jhead, "jax", draws)
    monkeypatch.setattr(jswin, "drop_path", lambda x, *a, **k: x)
    lc = JLossComputer(jcfg)

    def loss_fn(p, jb):
        out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb,
                            train=True, init_latent=jnp.asarray(lat),
                            rngs={"diffusion": jax.random.PRNGKey(0),
                                  "dropout": jax.random.PRNGKey(1)},
                            mutable=["batch_stats"])
        s, v = lc(jb, out)
        return s / 2, (mut["batch_stats"], v / 2)

    (jloss, (jstats, jval)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})

    port = port_x4(variables, steps, "swin")
    head = port.depth_head
    sample, ddim_loss = head._sample, head._ddim_loss
    monkeypatch.setattr(head, "_sample", lambda c, shape, g=None, i=None:
                        sample(c, shape, g, torch.from_numpy(lat)))
    monkeypatch.setattr(head, "_ddim_loss", lambda r, c, g=None:
                        ddim_loss(r, c, g, noise=torch.from_numpy(noise),
                                  timesteps=torch.from_numpy(ts)))
    for stage in port.depth_backbone.stages:
        for blk in stage.blocks:
            blk.drop_path_rate = 0.0
    step = make_train_step(port, LossComputer(pcfg), make_optimizer(pcfg, 10, port))
    loss, lval, met = step(torch_batch(batch))

    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=2e-3)
    np.testing.assert_allclose(lval.numpy(), np.asarray(jval), rtol=2e-3)
    assert bool(torch.isfinite(met).all())
    grads = {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
             for n, p in port.named_parameters()}
    jg = named(jgrads)
    close_leaves(grads, jg, 2e-3)
    # all three stages of the X4 decoder reach the loss
    for n in ("conv_inv_transform.0.weight", "conv_inv_transform.1.weight",
              "conv_inv_transform.4.0.weight"):
        assert np.abs(grads["depth_head.depth_transform." + n]).max() > 0, n
    stats = {n: b.numpy() for n, b in port.named_buffers() if n.endswith(("mean", "var"))}
    ref = {k: v for k, v in named(variables["params"], jax.tree_util.tree_map(
        np.asarray, jstats)).items() if k.endswith(("mean", "var"))}
    close_leaves(stats, ref, 1e-5)


@pytest.mark.parametrize("width", [50, 906])
def test_width_2_mod_4_raises_in_both(width):
    """At W % 4 == 2 the X4 encoder rounds W up twice and its decoder
    multiplies by 4 (50 -> 25 -> 13 -> 52; 906 -> 908), so pred is wider
    than the ground truth. Neither package crops: JAX's L1 raises on the
    broadcast, and so does the port's. The depth transform alone shows
    the widths at 906 (the flagship's training crop)."""
    if width == 906:
        jm = jdm.build_model(dataclasses.replace(jconfig.Config(), model_name="Diffusion_DCx4base_"))
        assert jm.depth_transform_cfg == X4_DEPTH_TRANSFORM
        tr = DeepDepthTransformWithUpsamplingX4().eval()
        with torch.no_grad():
            lat = tr.t(torch.zeros(1, 8, width, 1))
            assert lat.shape[2] == 227 and tr.inv_t(lat).shape[2] == 908
        return
    batch = make_batch(7, b=1, h=32, w=width)
    jm = jax_x4(1, "res18")
    variables = _variables(jm, batch, seed=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax.jit(lambda v, b, l: jm.apply(v, b, init_latent=l))(
        variables, jb, jnp.asarray(x4_latent(9, batch)))
    assert out["pred"].shape == (1, 32, 52, 1)
    jcfg = dataclasses.replace(jconfig.Config(), loss="1.0*L1")
    with pytest.raises((TypeError, ValueError)):
        JLossComputer(jcfg)(jb, out)

    port = port_x4(variables, 1, "res18")
    with torch.no_grad():
        pout = port(torch_batch(batch), init_latent=torch.from_numpy(x4_latent(9, batch)))
    assert tuple(pout["pred"].shape) == (1, 32, 52, 1)
    pcfg = dataclasses.replace(x4_config(1, "res18"), loss="1.0*L1")
    with pytest.raises(RuntimeError):
        LossComputer(pcfg)(torch_batch(batch), pout)
    with pytest.raises(RuntimeError):
        make_eval_step(port)(torch_batch(batch), init_latent=torch.from_numpy(x4_latent(9, batch)))
