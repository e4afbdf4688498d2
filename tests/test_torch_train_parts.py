"""The training building blocks of the port against the JAX package: the
losses, BatchNorm in training mode, drop-path, the forward diffusion, and
the optimizers with their learning-rate schedule (against optax)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.diffusion.ddim import DDIMSchedule as JSchedule  # noqa: E402
from diffusiondepth_tpu.losses import losses as jlosses  # noqa: E402
from diffusiondepth_tpu.models.common import BatchNorm as JBatchNorm  # noqa: E402
from diffusiondepth_tpu.models.common import drop_path as jdrop_path  # noqa: E402
from diffusiondepth_tpu.training.optim import make_lr_schedule as jmake_lr_schedule  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu_torch import Config  # noqa: E402
from diffusiondepth_tpu_torch.diffusion.ddim import DDIMSchedule  # noqa: E402
from diffusiondepth_tpu_torch.losses import LossComputer, get_loss_names, sig_loss  # noqa: E402
from diffusiondepth_tpu_torch.models.common import BatchNorm2d, drop_path  # noqa: E402
from diffusiondepth_tpu_torch.training.optim import make_lr_schedule, make_optimizer  # noqa: E402

torch.set_num_threads(1)


def _depths(seed):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(2, 8, 12, 1) * 100).astype(np.float32)
    gt[:, :2] = 0.0
    pred = (rng.rand(2, 8, 12, 1) * 100 - 5).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("spec", ["1.0*L1+1.0*L2+1.0*DDIM", "0.5*L1+2.0*Sig"])
def test_loss_computer_matches_jax(spec):
    """(loss_sum, loss_val) of LossComputer and the term names, f32 (1e-6
    relative)."""
    pred, gt = _depths(0)
    cfg = Config(loss=spec, max_depth=88.0)
    jc = jconfig.Config(loss=spec, max_depth=88.0)
    out = {"pred": pred, "ddim_loss": np.float32(0.37)}
    js, jv = jlosses.LossComputer(jc)({"gt": jnp.asarray(gt)},
                                      {k: jnp.asarray(v) for k, v in out.items()})
    ps, pv = LossComputer(cfg)({"gt": torch.from_numpy(gt)},
                               {k: torch.as_tensor(v) for k, v in out.items()})
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6)
    assert get_loss_names(cfg) == jlosses.get_loss_names(jc)


def test_sig_loss_with_max_depth_matches_jax():
    pred, gt = _depths(1)
    np.testing.assert_allclose(
        sig_loss(torch.from_numpy(pred), torch.from_numpy(gt), 50.0).numpy(),
        np.asarray(jlosses.sig_loss(jnp.asarray(pred), jnp.asarray(gt), 50.0)), rtol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_batchnorm_training_matches_flax(bf16):
    """Training-mode BatchNorm: the output (f32: 1e-6 relative; bf16 output:
    one bf16 step) and the running statistics after two updates (flax
    momentum 0.9 == torch 0.1, biased variance: 1e-6)."""
    rng = np.random.RandomState(2)
    x1 = (rng.randn(2, 5, 7, 6) * 3 + 1).astype(np.float32)
    x2 = (rng.randn(2, 5, 7, 6) * 2 - 1).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(6)).astype(np.float32)
    bias = (0.1 * rng.randn(6)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else None
    mod = JBatchNorm(dtype=jdt)
    vs = mod.init(jax.random.PRNGKey(0), jnp.asarray(x1), True)
    params = {"BatchNorm_0": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    stats = vs["batch_stats"]
    bn = BatchNorm2d(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    dt = torch.bfloat16 if bf16 else None
    for x in (x1, x2):
        xj = jnp.asarray(x, jdt or jnp.float32)
        jy, mut = mod.apply({"params": params, "batch_stats": stats}, xj, True,
                            mutable=["batch_stats"])
        stats = mut["batch_stats"]
        y = bn(torch.from_numpy(x).to(dt or torch.float32), dt)
        jy = np.asarray(jy, np.float32)
        tol = 1e-2 if bf16 else 1e-6
        assert np.abs(y.detach().float().numpy() - jy).max() <= tol * np.abs(jy).max()
    st = stats["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(st["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(st["var"]), rtol=1e-6)


def test_drop_path_matches_jax():
    """Given the same keep mask, drop-path zeroes the dropped samples and
    scales the kept ones by 1 / (1 - rate) exactly as the JAX function."""
    x = np.random.RandomState(3).randn(4, 3, 5, 8).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jdrop_path(jnp.asarray(x), 0.3, False, key))
    keep = np.array(jax.random.bernoulli(key, 0.7, (4, 1, 1, 1))).reshape(4)
    out = drop_path(torch.from_numpy(x), torch.from_numpy(keep), 0.3)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_add_noise_and_velocity_match_jax():
    rng = np.random.RandomState(4)
    x0 = rng.randn(3, 4, 5, 16).astype(np.float32)
    noise = rng.randn(3, 4, 5, 16).astype(np.float32)
    ts = np.array([0, 517, 999])
    js, ps = JSchedule(), DDIMSchedule()
    for jf, pf in ((js.add_noise, ps.add_noise), (js.get_velocity, ps.get_velocity)):
        ref = np.asarray(jf(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(ts)))
        out = pf(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(ts))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_lr_schedule_matches_jax():
    """Warm-up over epoch 1, then the decay table, at every step of 25
    epochs of 4 steps (f32: 1e-6 relative)."""
    cfg = Config(lr=2e-3)
    jsched = jmake_lr_schedule(jconfig.Config(lr=2e-3), 4)
    sched = make_lr_schedule(cfg, 4)
    steps = np.arange(100)
    np.testing.assert_allclose([sched(int(s)) for s in steps],
                               np.asarray(jax.vmap(jsched)(jnp.asarray(steps))), rtol=1e-6)


class _Tiny(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.depth_backbone = torch.nn.Linear(3, 4)
        self.depth_head = torch.nn.Linear(4, 2)
        for p in self.parameters():
            with torch.no_grad():
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))


@pytest.mark.parametrize("kind,wd,split", [
    ("ADAM", 0.0, False), ("ADAM", 0.01, True), ("SGD", 0.01, False), ("RMSprop", 0.0, True)])
def test_optimizer_matches_optax(kind, wd, split):
    """Three steps of each optimizer on fixed gradients, with weight decay
    and the 0.1x split-backbone groups: the parameters after each step
    (f32: 1e-5 of the largest parameter)."""
    rng = np.random.RandomState(5)
    model = _Tiny(rng)
    kw = dict(optimizer=kind, weight_decay=wd, split_backbone_training=split, lr=0.05)
    opt = make_optimizer(Config(**kw), 2, model)
    names = {"depth_backbone.weight": ("depth_backbone", "w"),
             "depth_backbone.bias": ("depth_backbone", "b"),
             "depth_head.weight": ("depth_head", "w"), "depth_head.bias": ("depth_head", "b")}
    jparams = {"depth_backbone": {}, "depth_head": {}}
    for n, p in model.named_parameters():  # copies: JAX may alias a numpy buffer
        jparams[names[n][0]][names[n][1]] = jnp.asarray(p.detach().numpy().copy())
    tx = jmake_optimizer(dataclasses.replace(jconfig.Config(), **kw), 2, jparams)
    state = tx.init(jparams)
    for _ in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        jg = {a: {} for a in jparams}
        for n, (a, b) in names.items():
            jg[a][b] = jnp.asarray(grads[n])
        upd, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in model.named_parameters():
            ref = np.asarray(jparams[names[n][0]][names[n][1]])
            assert np.abs(p.detach().numpy() - ref).max() <= 1e-5 * np.abs(ref).max(), n

