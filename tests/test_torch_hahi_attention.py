"""HAHI's deformable self- and cross-attention on the port against the JAX
package, in f32 on the CPU: the neck with each switch setting (BatchNorm and
dropout in eval and in training mode), then the flagship head with both
attentions on over ``swin_micro``: its eval step and one training step.

Neither package's model takes head arguments, so both build the head
with ``hahi_self_att`` and ``hahi_cross_att`` themselves. The MSDA
``sampling_offsets`` and ``attention_weights`` kernels start at zero; here
they are drawn at random, the offsets scaled so that some sampling points
fall outside the maps."""

import collections
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as fnn  # noqa: E402
from flax.linen import stochastic  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models.backbones import swin as jswin  # noqa: E402
from diffusiondepth_tpu.models.diffusion_model import Diffusion_DCbase_Model  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.models.necks import hahi as jhahi  # noqa: E402
from diffusiondepth_tpu.ops import msda as jmsda  # noqa: E402
from diffusiondepth_tpu.registry import BACKBONES as JBACKBONES  # noqa: E402
from diffusiondepth_tpu.registry import HEADS as JHEADS  # noqa: E402
from diffusiondepth_tpu.training.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch import LossComputer, build_model, make_eval_step  # noqa: E402
from diffusiondepth_tpu_torch.models.necks import hahi as phahi  # noqa: E402
from diffusiondepth_tpu_torch.ops import msda as pmsda  # noqa: E402
from diffusiondepth_tpu_torch.registry import HEADS  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402
from diffusiondepth_tpu_torch.training.steps import make_train_step  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import (  # noqa: E402
    HEAD, MICRO_CHANNELS, DropoutMasks, Draws, FixedLatent, close_leaves, init_latent,
    jax_variables, make_batch, module_variables, named, port_config, random_msda_kernels,
    rel_err, torch_batch,
)

torch.set_num_threads(1)

_State = collections.namedtuple("_State", "params batch_stats")
# the neck at micro width: embedding 64 = 2 x 32 encoding features
NECK = dict(embedding_dim=64, num_points=2, num_heads=4, pe_num_feats=32)
SWITCHES = [(True, False), (False, True), (True, True)]


def _neck_inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 16 // 2 ** i, 24 // 2 ** i, c).astype(np.float32)
            for i, c in enumerate(MICRO_CHANNELS)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("self_att,cross_att", SWITCHES)
def test_hahi_neck_matches_jax(monkeypatch, self_att, cross_att, train):
    """The four output levels, and in training mode (batch statistics,
    dropout under the same keep masks) the BatchNorm statistics after the
    call: 1e-4 of each map's largest value (f32, sums in another order)."""
    kw = dict(in_channels=MICRO_CHANNELS, out_channels=MICRO_CHANNELS, self_att=self_att,
              cross_att=cross_att, **NECK)
    jneck = jhahi.HAHIHeteroNeck(**kw)
    fp = _neck_inputs(1)
    variables = module_variables(jneck, fp, seed=2)
    random_msda_kernels(variables["params"], 3)
    variables["params"]["level_embed"] = np.random.RandomState(4).randn(4, 64).astype(np.float32)
    masks = DropoutMasks(5)
    monkeypatch.setattr(stochastic, "random", masks.random)
    monkeypatch.setattr(pmsda, "keep_mask", masks.keep_mask)

    apply = jax.jit(lambda v, fp: jneck.apply(v, fp, train=train, mutable=["batch_stats"],
                                               rngs={"dropout": jax.random.PRNGKey(0)}))
    jouts, jstats = apply(variables, [jnp.asarray(f) for f in fp])

    neck = phahi.HAHIHeteroNeck(**kw)
    neck.load_state_dict(jax_to_state_dict(variables["params"], variables["batch_stats"]),
                         strict=True)
    neck.train(train)
    with torch.no_grad():
        outs = neck([torch.from_numpy(f) for f in fp], generator=torch.Generator())
    for a, b in zip(outs, jouts):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), np.asarray(b)) < 1e-4
    n_att = int(self_att) + int(cross_att)
    assert len(masks.shapes) == (n_att if train else 0)
    stats = {n: b.numpy() for n, b in neck.named_buffers()}
    new_stats = jax.tree_util.tree_map(np.asarray, dict(jstats)["batch_stats"])
    ref = jax_to_state_dict(variables["params"], new_stats)
    for n, v in stats.items():
        assert rel_err(v, ref[n].numpy()) < 1e-5, n


def test_cross_attention_reference_points():
    """sigmoid(reference_points_fc(sine encoding)) at each level-0 token,
    the same point on every level, against numpy on the JAX weights."""
    jneck = jhahi.HAHIHeteroNeck(in_channels=MICRO_CHANNELS, out_channels=MICRO_CHANNELS,
                                 cross_att=True, **NECK)
    fp = _neck_inputs(6)
    variables = module_variables(jneck, fp, seed=7)
    neck = phahi.HAHIHeteroNeck(MICRO_CHANNELS, MICRO_CHANNELS, cross_att=True, **NECK)
    neck.load_state_dict(jax_to_state_dict(variables["params"], variables["batch_stats"]))
    seen = []
    forward = neck.multi_att.forward

    def spy(query, value, query_pos, ref, shapes, **kw):
        seen.append(ref)
        return forward(query, value, query_pos, ref, shapes, **kw)

    neck.multi_att.forward = spy
    with torch.no_grad():
        neck.eval()([torch.from_numpy(f) for f in fp])
    fc = variables["params"]["reference_points_fc"]
    pe = jhahi.sine_positional_encoding(16, 24, 32).reshape(16 * 24, -1)
    ref = 1.0 / (1.0 + np.exp(-(pe @ fc["kernel"] + fc["bias"])))
    (got,) = seen
    assert got.shape == (2, 16 * 24, 3, 2)
    for lvl in range(3):
        np.testing.assert_allclose(got[1, :, lvl].numpy(), ref, rtol=1e-5, atol=1e-6)


class _JaxAttentionModel(Diffusion_DCbase_Model):
    """The JAX model with the flagship head's attentions on."""

    def setup(self):
        self.depth_backbone = JBACKBONES.get(self.backbone_name)(dtype=self.dtype)
        self.depth_head = JHEADS.get(self.head_name)(
            in_channels=tuple(self.head_in_channels), inference_steps=self.inference_steps,
            hahi_self_att=True, hahi_cross_att=True, dtype=self.dtype)


STEPS = 2


@functools.lru_cache(maxsize=None)
def _jax_setup():
    batch = make_batch(3)
    jm = _JaxAttentionModel(backbone_name="swin_micro", backbone_module="swin", head_name=HEAD,
                            inference_steps=STEPS, head_in_channels=MICRO_CHANNELS)
    variables = jax_variables(jm, batch, seed=3)
    random_msda_kernels(variables["params"], 13)
    return batch, jm, variables


def _models():
    """The JAX model and its variables (made once), and the port's model
    on those weights."""
    batch, jm, variables = _jax_setup()
    cfg = port_config(STEPS)
    port = build_model(cfg, device="cpu")
    port.depth_head = HEADS.get(HEAD)(in_channels=MICRO_CHANNELS, inference_steps=STEPS,
                                      hahi_self_att=True, hahi_cross_att=True)
    port.load_state_dict(jax_to_state_dict(variables["params"], variables["batch_stats"]),
                         strict=True)
    return batch, jm, variables, port.eval(), cfg


def test_attention_head_eval_matches_jax():
    """pred and the metric row of make_eval_step with both attentions on,
    2 steps from one starting latent, at the flagship eval test's
    tolerances (pred 1e-3 relative and absolute, metrics 1e-3 / 1e-6)."""
    batch, jm, variables, port, _ = _models()
    assert {"level_embed", "self_attn", "multi_att", "reference_points_fc"} <= set(
        variables["params"]["depth_head"]["hahineck"])
    lat = init_latent(1, batch)
    jstep = jax_make_eval_step(FixedLatent(jm, jnp.asarray(lat)))
    jpred, jmet, _ = jstep(_State(variables["params"], variables["batch_stats"]),
                           {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    ppred, pmet, _ = make_eval_step(port)(torch_batch(batch), init_latent=torch.from_numpy(lat))
    assert ppred.shape == tuple(jpred.shape)
    np.testing.assert_allclose(ppred.numpy(), np.asarray(jpred), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pmet.numpy(), np.asarray(jmet), rtol=1e-3, atol=1e-6)


class _NoDropout:
    """Stands in for ``flax.linen`` inside the JAX MSDA: Dropout is the
    identity."""

    def __getattr__(self, k):
        return getattr(fnn, k)

    @staticmethod
    def Dropout(*args, **kwargs):
        return lambda x: x


def test_attention_train_step_matches_jax(monkeypatch):
    """One training step (batch 2, Adam) with both attentions on, the same
    starting latent, DDIM draws and timesteps, dropout and drop-path off in
    both: the loss terms at rtol 2e-3 and every parameter's gradient
    within 2e-3 of its leaf's largest value (f32, sums in another order,
    grown through two sampler steps and the reciprocal decode)."""
    batch, jm, variables, port, cfg = _models()
    lat = init_latent(1, batch)
    rng = np.random.RandomState(2)
    noise = rng.randn(*lat.shape).astype(np.float32)
    ts = np.array([413, 77], np.int64)
    monkeypatch.setattr(jhead, "jax", Draws(noise, ts))
    monkeypatch.setattr(jswin, "drop_path", lambda x, *a, **k: x)
    monkeypatch.setattr(jmsda, "nn", _NoDropout())
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
    for m in port.modules():
        if isinstance(m, pmsda.MultiScaleDeformableAttention):
            m.dropout = 0.0

    kw = dict(batch_size=2, accum_steps=1, max_depth=88.0)
    jcfg = dataclasses.replace(jconfig.Config(), **kw)
    pcfg = dataclasses.replace(cfg, **kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lc = JLossComputer(jcfg)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb,
                            train=True, init_latent=jnp.asarray(lat),
                            rngs={"diffusion": jax.random.PRNGKey(0),
                                  "dropout": jax.random.PRNGKey(1)},
                            mutable=["batch_stats"])
        s, v = lc(jb, out)
        return s / 2, (mut["batch_stats"], v / 2)

    (jloss, (jstats, jval)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    state = create_train_state(port, pcfg, 10)
    loss, lval, met = make_train_step(state.model, LossComputer(pcfg), state.optimizer)(
        torch_batch(batch))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=2e-3)
    np.testing.assert_allclose(lval.numpy(), np.asarray(jval), rtol=2e-3)
    assert bool(torch.isfinite(met).all())
    grads = {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
             for n, p in port.named_parameters()}
    jg = named(jgrads)
    for part in ("level_embed", "self_attn.sampling_offsets.weight",
                 "multi_att.attention_weights.weight", "reference_points_fc.weight"):
        assert np.abs(jg["depth_head.hahineck." + part]).max() > 0, part
    close_leaves(grads, jg, 2e-3)
    stats = {n: b.numpy() for n, b in port.named_buffers() if n.endswith(("mean", "var"))}
    ref = {k: v for k, v in named(variables["params"], jstats).items()
           if k.endswith(("mean", "var"))}
    close_leaves(stats, ref, 1e-5)
