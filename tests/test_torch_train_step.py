"""The port's whole training step against the JAX package's, in f32:
``make_train_step`` at micro shape (swin_micro under the flagship head, 2
DDIM steps), the plain step and the accumulating one. The random draws of
the two packages differ, so both are handed the same starting latent, DDIM
noise and timesteps, and drop-path is off."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models.backbones import swin as jswin  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu.training.steps import make_train_step as jmake_train_step  # noqa: E402
from diffusiondepth_tpu.training.train_state import TrainState  # noqa: E402
from diffusiondepth_tpu_torch import LossComputer, make_optimizer, make_train_step  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402

from test_torch_support import (  # noqa: E402
    Draws as _Draws, FixedLatent as _FixedLatent, close_leaves as _close, init_latent,
    jax_model, jax_variables, make_batch, named as _named, port_config, port_model,
    torch_batch,
)

torch.set_num_threads(1)

STEPS = 2


def _inject(monkeypatch, port, lat, noise, ts):
    """The same starting latent, DDIM noise and timesteps in both packages;
    drop-path off in both."""
    monkeypatch.setattr(jhead, "jax", _Draws(noise, ts))
    monkeypatch.setattr(jswin, "drop_path", lambda x, *a, **k: x)
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


@functools.lru_cache(maxsize=None)
def _jax_setup():
    batch = make_batch(0)
    jm = jax_model(steps=STEPS)
    return batch, jm, jax_variables(jm, batch)


def _setup(monkeypatch, micro, **opt):
    batch, jm, variables = _jax_setup()
    port = port_model(variables, steps=STEPS)
    lat = init_latent(1, {"gt": batch["gt"][:micro]})
    rng = np.random.RandomState(2)
    noise = rng.randn(*lat.shape).astype(np.float32)
    ts = np.array([413, 77][:micro], np.int64)
    _inject(monkeypatch, port, lat, noise, ts)
    kw = dict(batch_size=2, accum_steps=2 // micro, max_depth=88.0, **opt)
    jcfg = dataclasses.replace(jconfig.Config(), **kw)
    pcfg = dataclasses.replace(port_config(STEPS), **kw)
    return batch, jm, variables, port, lat, jcfg, pcfg


def test_plain_step_matches_jax(monkeypatch):
    """One Adam step without accumulation (batch 2): the loss terms, every
    parameter's gradient, the parameter delta (optax's Adam on the JAX
    gradients) and the BatchNorm statistics after the step match JAX in
    f32, through the train state's model and optimizer. Tolerance 2e-3 of
    each leaf's largest value: both run f32, sums are taken in another order,
    and the differences grow through the two sampler steps and the
    reciprocal decode. Leaves the loss does not reach (the depth encoder,
    which only sizes the latent) have zero gradients in JAX and none in
    the port."""
    batch, jm, variables, port, lat, jcfg, pcfg = _setup(monkeypatch, micro=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lc = JLossComputer(jcfg)
    params = variables["params"]

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, jb,
                            train=True, init_latent=jnp.asarray(lat),
                            rngs={"diffusion": jax.random.PRNGKey(0),
                                  "dropout": jax.random.PRNGKey(1)},
                            mutable=["batch_stats"])
        s, v = lc(jb, out)
        return s / 2, (mut["batch_stats"], v / 2)

    (jloss, (jstats, jval)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tx = jmake_optimizer(jcfg, 10, params)
    upd, _ = jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(jgrads, params)

    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    state = create_train_state(port, pcfg, 10)
    step = make_train_step(state.model, LossComputer(pcfg), state.optimizer)
    loss, lval, met = step(torch_batch(batch))
    assert state.step == 1

    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=2e-3)
    np.testing.assert_allclose(lval.numpy(), np.asarray(jval), rtol=2e-3)
    assert bool(torch.isfinite(met).all())
    grads = {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
             for n, p in port.named_parameters()}
    _close(grads, _named(jgrads), 2e-3)
    # Adam's first update is g / (|g| + 1e-8): where |g| is not well above
    # 1e-8 it follows float noise, so those entries are left out
    jg = _named(jgrads)
    delta = {n: np.where(np.abs(jg[n]) > 1e-6, (p.detach() - before[n]).numpy(), 0.0)
             for n, p in port.named_parameters()}
    jdelta = {n: np.where(np.abs(jg[n]) > 1e-6, u, 0.0) for n, u in _named(upd).items()}
    _close(delta, jdelta, 2e-3)
    stats = {n: b.numpy() for n, b in port.named_buffers() if n.endswith(("mean", "var"))}
    ref = {k: v for k, v in _named(params, jstats).items() if k.endswith(("mean", "var"))}
    _close(stats, ref, 1e-5)


def test_accumulating_step_matches_jax(monkeypatch):
    """Two micro-batches of 1, accumulated (``accum_steps=2``), one SGD
    step at lr 1 without momentum or warm-up, so that the parameter delta
    is minus the summed gradients over the global batch: the delta, the
    loss and the BatchNorm statistics (updated by each micro-batch in
    turn) match JAX's accumulating step (2e-3 of each leaf's largest value,
    statistics 1e-5)."""
    opt = dict(optimizer="SGD", momentum=0.0, lr=1.0, warm_up=False)
    batch, jm, variables, port, lat, jcfg, pcfg = _setup(monkeypatch, micro=1, **opt)
    jstep = jmake_train_step(_FixedLatent(jm, jnp.asarray(lat)), JLossComputer(jcfg),
                             accum_steps=2, donate=False)
    params = variables["params"]
    tx = jmake_optimizer(jcfg, 10, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"], opt_state=jax.jit(tx.init)(params),
                       tx=tx)
    new, jloss, jval, _ = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                jax.random.PRNGKey(0))

    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    step = make_train_step(port, LossComputer(pcfg), make_optimizer(pcfg, 10, port),
                           accum_steps=2)
    loss, lval, _ = step(torch_batch(batch))

    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=2e-3)
    np.testing.assert_allclose(lval.numpy(), np.asarray(jval), rtol=2e-3)
    delta = {n: (p.detach() - before[n]).numpy() for n, p in port.named_parameters()}
    jdelta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                    dict(new.params), dict(params))
    _close(delta, _named(jdelta), 2e-3)
    stats = {n: b.numpy() for n, b in port.named_buffers() if n.endswith(("mean", "var"))}
    ref = {k: v for k, v in _named(new.params, new.batch_stats).items()
           if k.endswith(("mean", "var"))}
    _close(stats, ref, 1e-5)

