"""Shared set-up for the tests of the PyTorch port (no tests here).

Inputs and weights are made from a seed with numpy; the JAX model's
parameters reach the port through ``jax_to_state_dict``. Sizes are the
ROADMAP's parity sizes: 64x96 images, at most 4 DDIM steps, and per
backbone family (``FAMILIES``) its smallest model under its head:
``swin_micro`` under the flagship head, ``mmbev_res18`` under
``DDIMDepthEstimate_Res``, ``mpvit_tiny`` under
``DDIMDepthEstimate_MPVIT_ADDHAHI``.

The ``dp_*`` helpers at the end hold the data-parallel steps of two gloo
ranks against JAX's ``data:2`` mesh and against one process, for
``tests/test_torch_parallel_train.py`` (res18, NLSPN, the reductions) and
``tests/test_torch_parallel_train_swin.py`` (swin_micro, whose JAX f64
step is the longest test of the suite: a file of its own lets xdist's
``--dist loadfile`` give it a worker of its own).
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models.backbones import swin as jswin  # noqa: E402
from diffusiondepth_tpu.models.diffusion_model import Diffusion_DCbase_Model  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.models.nlspn import NLSPNModel as JNLSPN  # noqa: E402
from diffusiondepth_tpu.parallel import mesh as jmesh  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu.training.steps import (  # noqa: E402
    make_eval_step as jmake_eval_step, make_train_step as jmake_train_step,
)
from diffusiondepth_tpu.training.train_state import TrainState  # noqa: E402
from diffusiondepth_tpu_torch import Config, LossComputer, build_model  # noqa: E402
from diffusiondepth_tpu_torch.parallel import rank_rows  # noqa: E402
from diffusiondepth_tpu_torch.training.optim import make_lr_schedule  # noqa: E402
from diffusiondepth_tpu_torch.training.steps import make_eval_step, make_train_step  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

HEAD = "DDIMDepthEstimate_Swin_ADDHAHI"
MICRO_CHANNELS = (32, 64, 128, 256)
# family -> (backbone_module, backbone_name, head, head_in_channels)
FAMILIES = {
    "swin": ("swin", "swin_micro", HEAD, MICRO_CHANNELS),
    "res18": ("mmbev_resnet", "mmbev_res18", "DDIMDepthEstimate_Res", None),
    "mpvit_tiny": ("mpvit", "mpvit_tiny", "DDIMDepthEstimate_MPVIT_ADDHAHI", (96, 176, 216, 216)),
}


def make_batch(seed=0, b=2, h=64, w=96):
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, h, w, 1) * 8 + 1).astype(np.float32)
    gt[:, :4] = 0.0  # some invalid pixels, as in sparse KITTI ground truth
    return {"rgb": rng.randn(b, h, w, 3).astype(np.float32), "gt": gt}


def init_latent(seed, batch):
    b, h, w, _ = batch["gt"].shape
    return np.random.RandomState(seed).randn(b, h // 2, w // 2, 16).astype(np.float32)


def jax_model(steps=4, bf16=False, family="swin", head=None):
    """The JAX model of ``family``; ``head`` replaces the family's head."""
    module, name, fhead, channels = FAMILIES[family]
    return Diffusion_DCbase_Model(
        backbone_name=name, backbone_module=module, head_name=head or fhead,
        inference_steps=steps, head_in_channels=channels,
        dtype=jnp.bfloat16 if bf16 else None)


def _randomize(tree, rng, path=()):
    """Non-trivial values for the leaves flax initialises to constants."""
    if isinstance(tree, dict):
        return {k: _randomize(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    name = path[-1]
    if name == "var":
        return (1.0 + 0.3 * rng.rand(*a.shape)).astype(np.float32)
    if name in ("mean", "bias"):
        return (0.1 * rng.randn(*a.shape)).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
    return a


def jax_variables(model, batch, seed=0):
    """Flax init of ``model`` with randomized norms, biases and running
    statistics, as nested dicts of numpy arrays."""
    key = jax.random.PRNGKey(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda key, jb, lat: model.init({"params": key, "diffusion": key}, jb,
                                                   train=False, init_latent=lat))
    vs = init(key, jb, jnp.asarray(init_latent(0, batch)))
    rng = np.random.RandomState(seed + 100)
    to_np = jax.tree_util.tree_map(np.asarray, {k: dict(v) for k, v in vs.items()})
    return {k: _randomize(v, rng) for k, v in to_np.items()}


def module_variables(module, *args, seed=0, **kwargs):
    """Variables of a flax module (or model) applied to ``args`` (numpy
    arrays), drawn with numpy from ``seed``: the shapes come from
    ``jax.eval_shape`` of its init (no compile), each kernel or embedding
    ~ N(0, 1 / fan-in), norms, biases and running statistics as
    ``jax_variables`` randomizes them."""
    key = jax.random.PRNGKey(0)
    args, kwargs = jax.tree_util.tree_map(jnp.asarray, (args, kwargs))
    shapes = jax.eval_shape(lambda: module.init({"params": key, "diffusion": key},
                                                *args, **kwargs))
    rng = np.random.RandomState(seed + 100)

    def draw(tree, path=()):
        if hasattr(tree, "items"):
            return {k: draw(v, path + (k,)) for k, v in tree.items()}
        if path[-1] in ("kernel", "embedding", "relative_position_bias_table"):
            fan_in = int(np.prod(tree.shape[:-1])) if path[-1] == "kernel" else 1
            return (rng.randn(*tree.shape) / np.sqrt(max(fan_in, 1))).astype(np.float32)
        return _randomize(np.zeros(tree.shape, np.float32), rng, path)

    return draw({k: v for k, v in shapes.items()})


def backbone_state_dict(variables):
    """A JAX backbone's variables -> the state dict of the port's backbone
    module (``jax_to_state_dict`` under ``depth_backbone.``, prefix cut)."""
    sd = jax_to_state_dict({"depth_backbone": variables["params"]},
                           {"depth_backbone": variables.get("batch_stats", {})})
    return {k[len("depth_backbone."):]: v for k, v in sd.items()}


class FixedLatent:
    """Hands the JAX step's ``model.apply`` a fixed starting latent."""

    def __init__(self, model, latent):
        self.model, self.latent = model, latent

    def apply(self, variables, batch, **kw):
        return self.model.apply(variables, batch, init_latent=self.latent, **kw)


class Draws:
    """Stands in for ``jax`` inside the JAX head: ``random.normal`` and
    ``random.randint`` return ``self.noise`` and ``self.timesteps``, read at
    the call (a traced function may set them to its arguments)."""

    def __init__(self, noise, timesteps):
        self.noise, self.timesteps = noise, timesteps
        rnd, draws = jax.random, self

        class _Random:
            def __getattr__(self, k):
                return getattr(rnd, k)

            @staticmethod
            def normal(key, shape, dtype=jnp.float32):
                return jnp.asarray(draws.noise, dtype).reshape(shape)

            @staticmethod
            def randint(key, shape, lo, hi):
                return jnp.asarray(draws.timesteps, jnp.int32).reshape(shape)

        self.random = _Random()

    def __getattr__(self, k):
        return getattr(jax, k)


def random_msda_kernels(tree, seed, offset_scale=3.0):
    """Random ``sampling_offsets`` and ``attention_weights`` kernels (the
    offsets ``offset_scale`` times N(0, 1 / fan-in)) in every MSDA of a
    parameter tree, in place."""
    rng = np.random.RandomState(seed)
    for key, v in tree.items():
        if key in ("sampling_offsets", "attention_weights"):
            k = v["kernel"]
            scale = offset_scale if key == "sampling_offsets" else 1.0
            v["kernel"] = (scale * rng.randn(*k.shape) / np.sqrt(k.shape[0])).astype(np.float32)
        elif isinstance(v, dict):
            random_msda_kernels(v, seed + 1, offset_scale)
    return tree


class DropoutMasks:
    """Dropout keep masks drawn in call order from one numpy seed: the
    same sequence of masks for flax's ``random.bernoulli`` and the port's
    ``keep_mask``."""

    def __init__(self, seed):
        self.jax_rng = np.random.RandomState(seed)
        self.port_rng = np.random.RandomState(seed)
        self.shapes = []
        masks = self

        class _Random:
            def __getattr__(self, k):
                return getattr(jax.random, k)

            @staticmethod
            def bernoulli(key, p, shape):
                return jnp.asarray(masks.jax_rng.rand(*shape) < p)

        self.random = _Random()

    def keep_mask(self, shape, rate, generator, device):
        self.shapes.append(tuple(shape))
        return torch.from_numpy(self.port_rng.rand(*shape) < 1.0 - rate)


def named(tree, batch_stats=None):
    """A JAX params (or gradient) tree under the port's parameter names."""
    return {k: v.numpy() for k, v in jax_to_state_dict(tree, batch_stats).items()}


def close_leaves(port_vals, jax_vals, tol):
    """Each leaf within ``tol`` of its largest value; a leaf whose values
    are below 1e-4 of the largest of all leaves (a gradient that vanishes
    analytically, as that of a bias followed by BatchNorm) is held to that
    floor instead: there both packages hold float noise."""
    floor = 1e-4 * max(np.abs(v).max() for v in jax_vals.values())
    for name, ref in jax_vals.items():
        err = np.abs(port_vals[name] - ref).max()
        scale = max(np.abs(ref).max(), floor)
        assert err <= tol * scale, (name, err, scale)


def port_config(steps=4, opt_level="O0", family="swin", head=None):
    module, name, fhead, channels = FAMILIES[family]
    return Config(model_name="Diffusion_DCbase_", backbone_module=module,
                  backbone_name=name, head_specify=head or fhead,
                  inference_steps=steps, opt_level=opt_level,
                  head_in_channels=channels and ",".join(map(str, channels))).finalize()


def port_model(variables, steps=4, opt_level="O0", family="swin", head=None):
    model = build_model(port_config(steps, opt_level, family, head), device="cpu")
    sd = jax_to_state_dict(variables["params"], variables.get("batch_stats"))
    model.load_state_dict(sd, strict=True)
    return model


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# ---- data-parallel steps: two gloo ranks against JAX's data:2 mesh and
# against one process (the checks and their tolerances are explained in
# tests/test_torch_parallel_train.py's docstring)

DP_REPO = Path(__file__).resolve().parent.parent
DP_RANKS = 2
DP_STEPS = 2
DP_JAX_TOL, DP_JAX_EVAL_TOL = 2e-3, 1e-3
DP_TOL, DP_METRIC_TOL, DP_GRAD_TOL = 1e-5, 1e-4, 1e-3
DP_JAX_F64 = {"res18": False, "swin": True, "nlspn": True}
DP_SEED = 5
DP_NLSPN_FLAGS = dict(model_name="NLSPN", network="resnet18", prop_time=3, prop_kernel=3,
                      affinity="TGASS", conf_prop=True, prop_stencil_radius=6,
                      loss="1.0*L1+1.0*L2", max_depth=90.0)
# family -> (global batch, accum_steps, height, width, loss)
DP_FAMILIES = {
    "res18": (8, 1, 32, 48, "1.0*L1+1.0*L2+1.0*Sig+1.0*DDIM"),
    "swin": (4, 2, 64, 96, "1.0*L1+1.0*L2+1.0*DDIM"),
    "nlspn": (4, 1, 32, 48, DP_NLSPN_FLAGS["loss"]),
}


@pytest.fixture(autouse=True, scope="module")
def dp_no_onednn():
    """PyTorch's own CPU convolutions for the module's tests (import it
    into a test module to use it): oneDNN's convolution backward loses
    precision at some shapes (ROADMAP Queue 3)."""
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


def dp_uneven_batch(seed, b, h, w, accum, depth):
    """rgb, gt in (1, 1 + ``depth``) (and NLSPN's dep): rank 0's rows 85%
    invalid, rank 1's 5%."""
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, h, w, 1) * depth + 1).astype(np.float32)
    invalid = np.zeros((b,), np.float32)
    for r, share in enumerate((0.85, 0.05)):
        invalid[rank_rows(b, accum, r, DP_RANKS)] = share
    gt[rng.rand(b, h, w, 1) < invalid[:, None, None, None]] = 0.0
    dep = (gt * (rng.rand(b, h, w, 1) > 0.9)).astype(np.float32)
    return {"rgb": rng.randn(b, h, w, 3).astype(np.float32), "gt": gt, "dep": dep}


@functools.lru_cache(maxsize=None)
def dp_family(family):
    """(port Config at data:2, JAX model, variables, the port's state dict,
    train batch, eval batch, draws) of a family."""
    b, accum, h, w, loss = DP_FAMILIES[family]
    if family == "nlspn":
        cfg = Config(**DP_NLSPN_FLAGS, batch_size=b, mesh_shape=f"data:{DP_RANKS}").finalize()
        batch = dp_uneven_batch(DP_SEED, b, h, w, accum, 80.0)
        jm = JNLSPN(args=jconfig.Config(**DP_NLSPN_FLAGS).finalize())
        variables = module_variables(jm, batch, seed=1, train=False)
        prop = variables["params"]["prop_layer"]
        prop["conv_offset_aff"]["kernel"][..., :16] *= 2.0  # offsets beyond the radius
        prop["aff_scale_const"] = np.asarray([0.5 * 8 + 0.37], np.float32)
        # the initial depth in the ground truth's range, as a trained model's:
        # random weights predict depths near 0, whose reciprocals (iRMSE,
        # iMAE) amplify the f32 differences of pred a thousandfold
        variables["params"]["id_dec0"]["Conv_0"]["bias"][:] = 20.0
        draws = None
    else:
        base = port_config(DP_STEPS, family=family)
        cfg = dataclasses.replace(base, loss=loss, batch_size=b, accum_steps=accum,
                                  max_depth=10.0 if family == "res18" else 88.0,
                                  mesh_shape=f"data:{DP_RANKS}")
        batch = dp_uneven_batch(DP_SEED, b, h, w, accum, 8.0)  # make_batch's range
        jm = jax_model(steps=DP_STEPS, family=family)
        variables = jax_variables(jm, {k: v[:2] for k, v in batch.items()})
        micro = {"gt": batch["gt"][:b // accum]}
        lat = init_latent(1, micro)
        rng = np.random.RandomState(2)
        draws = {"lat": lat, "noise": rng.randn(*lat.shape).astype(np.float32),
                 "ts": rng.randint(0, 1000, (b // accum,)).astype(np.int64),
                 "eval_lat": init_latent(3, batch)}
    ebatch = dp_uneven_batch(DP_SEED + 1, b, h, w, 1, 80.0 if family == "nlspn" else 8.0)
    sd = jax_to_state_dict(variables["params"], variables.get("batch_stats"))
    return cfg, jm, variables, sd, batch, ebatch, draws


def dp_reductions_case():
    rng = np.random.RandomState(9)
    b = 4
    gt = (rng.rand(b, 16, 24, 1) * 50 + 1).astype(np.float32)
    for r, share in enumerate((0.85, 0.05)):
        rows = rank_rows(b, 1, r, DP_RANKS)
        gt[rows] = np.where(rng.rand(len(rows), 16, 24, 1) < share, 0.0, gt[rows])
    pred = (gt + rng.randn(*gt.shape) * 3 * (1 + np.arange(b)[:, None, None, None])).clip(0.1)
    return {"name": "reductions", "mesh_shape": f"data:{DP_RANKS}",
            "pred": pred.astype(np.float32), "gt": gt}


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_ranks_out(case_dir, families, reductions=False):
    """Every case of ``families`` (and the reductions case) run once by two
    gloo ranks in one spawned group; returns ``load(name)``, the ranks'
    results of a case."""
    cases = [dp_reductions_case()] if reductions else []
    for family in families:
        cfg, _, _, sd, batch, ebatch, draws = dp_family(family)
        common = {"mesh_shape": cfg.mesh_shape, "config": cfg.to_dict(), "state_dict": sd,
                  "batch": batch, "eval_batch": ebatch, "seed": DP_SEED}
        cases.append(dict(common, name=f"{family}-natural"))
        if draws is not None:
            cases.append(dict(common, name=f"{family}-inject", inject=draws))
    torch.save(cases, case_dir / "cases.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run([sys.executable,
                           str(DP_REPO / "tests" / "test_torch_parallel_support.py"),
                           str(case_dir), str(free_port()), str(DP_RANKS)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]

    def load(name):
        return [torch.load(case_dir / f"{name}_{r}.pt", weights_only=False)
                for r in range(DP_RANKS)]

    return load


def dp_jax_run(family, monkeypatch, f64=True):
    """JAX's data:2 train step (SGD, lr 1, so the parameter change is minus
    the gradient) and eval step, in f64 or f32, on the family's batches with
    the injected draws: (loss, loss row, metric row, gradients, batch
    statistics, eval pred, eval metric row)."""
    cfg, jm, variables, _, batch, ebatch, draws = dp_family(family)
    kw = dict(loss=cfg.loss, batch_size=cfg.batch_size, accum_steps=cfg.accum_steps,
              max_depth=cfg.max_depth, optimizer="SGD", momentum=0.0, lr=1.0, warm_up=False,
              weight_decay=0.0)
    if family == "nlspn":
        jcfg = dataclasses.replace(jconfig.Config(**DP_NLSPN_FLAGS).finalize(), **kw)
        model, emodel = jm, jm
    else:
        jcfg = dataclasses.replace(jconfig.Config(), **kw)
        monkeypatch.setattr(jhead, "jax", Draws(draws["noise"], draws["ts"]))
        monkeypatch.setattr(jswin, "drop_path", lambda x, *a, **k: x)
        model = FixedLatent(jm, jnp.asarray(draws["lat"]))
        emodel = FixedLatent(jm, jnp.asarray(draws["eval_lat"]))
    dtype = np.float64 if f64 else np.float32

    def cast(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), tree)

    mesh = jmesh.create_mesh(f"data:{DP_RANKS}", jax.devices()[:DP_RANKS])
    with jax.enable_x64(f64):
        params, stats = cast(variables["params"]), cast(variables.get("batch_stats", {}))
        tx = jmake_optimizer(jcfg, 10, params)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=jax.jit(tx.init)(params), tx=tx)
        jstep = jmake_train_step(model, JLossComputer(jcfg), mesh=mesh, donate=False,
                                 accum_steps=cfg.accum_steps)
        new, loss, lval, met = jstep(state, jmesh.shard_batch(cast(batch), mesh),
                                     jax.random.PRNGKey(0))
        to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
        grads = named(to_np(jax.tree_util.tree_map(lambda a, b: a - b, params, new.params)))
        out = dict(loss=float(loss), loss_val=np.asarray(lval, np.float64),
                   metric=np.asarray(met, np.float64), grads=grads,
                   stats=named(to_np(new.params), to_np(new.batch_stats)))
        estep = jmake_eval_step(emodel, mesh=mesh)
        pred, emet, _ = estep(state, jmesh.shard_batch(cast(ebatch), mesh), jax.random.PRNGKey(1))
        out.update(pred=np.asarray(pred), eval_metric=np.asarray(emet))
    return out


def dp_check_matches_jax_data_mesh(family, ranks_out, monkeypatch):
    """Rank 0 of the two gloo ranks against JAX's data:2 mesh: one train
    step and one eval step."""
    name = f"{family}-inject" if family != "nlspn" else "nlspn-natural"
    r0 = ranks_out(name)[0]
    ref = dp_jax_run(family, monkeypatch, DP_JAX_F64[family])
    np.testing.assert_allclose(r0["loss"].item(), ref["loss"], rtol=DP_JAX_TOL)
    np.testing.assert_allclose(r0["loss_val"].numpy(), ref["loss_val"], rtol=DP_JAX_TOL,
                               atol=1e-6)
    np.testing.assert_allclose(r0["metric"].numpy(), ref["metric"], rtol=DP_JAX_TOL)
    stats = {n: b.numpy() for n, b in r0["buffers"].items() if "running" in n}
    close_leaves(stats, {k: v for k, v in ref["stats"].items() if "running" in k}, 1e-5)
    grads = {n: r0["grads"][n].numpy() if n in r0["grads"] else np.zeros_like(g)
             for n, g in ref["grads"].items()}
    close_leaves(grads, ref["grads"], DP_JAX_TOL)
    assert rel_err(r0["pred"].numpy(), ref["pred"]) <= DP_JAX_EVAL_TOL
    np.testing.assert_allclose(r0["eval_metric"].numpy(), ref["eval_metric"],
                               rtol=DP_JAX_EVAL_TOL)


def dp_one_process(family):
    """The port's one-process train and eval step on the whole batches,
    the generator seeded as on every rank."""
    cfg, _, _, sd, batch, ebatch, _ = dp_family(family)
    cfg = dataclasses.replace(cfg, mesh_shape=None)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    pred, emet, _ = make_eval_step(model)({k: torch.from_numpy(v) for k, v in ebatch.items()},
                                          generator=torch.Generator().manual_seed(DP_SEED + 1))
    state = create_train_state(model, cfg, 10)
    step = make_train_step(model, LossComputer(cfg), state.optimizer, cfg.accum_steps)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, lval, met = step(tb, torch.Generator().manual_seed(DP_SEED))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    return dict(loss=loss, loss_val=lval, metric=met, grads=grads, model=model, pred=pred,
                eval_metric=emet, lr=make_lr_schedule(cfg, 10)(0))


def dp_check_ranks_match_one_process(family, ranks_out):
    """Two ranks against one process on the same global batch and seed:
    the numbers do not depend on the number of ranks."""
    r0 = ranks_out(f"{family}-natural")[0]
    ref = dp_one_process(family)
    np.testing.assert_allclose(r0["loss"].item(), ref["loss"].item(), rtol=DP_TOL)
    np.testing.assert_allclose(r0["loss_val"].numpy(), ref["loss_val"].numpy(), rtol=DP_TOL,
                               atol=1e-7)
    np.testing.assert_allclose(r0["metric"].numpy(), ref["metric"].numpy(), rtol=DP_METRIC_TOL)
    assert r0["grads"].keys() == ref["grads"].keys()
    close_leaves({n: g.numpy() for n, g in r0["grads"].items()}, ref["grads"], DP_GRAD_TOL)
    params = dict(ref["model"].named_parameters())
    worst = max(float((r0["params"][n] - p.detach()).abs().max()) for n, p in params.items())
    assert worst <= 2.0 * ref["lr"], (worst, ref["lr"])
    stats = {n: b.numpy() for n, b in r0["buffers"].items() if "running" in n}
    close_leaves(stats, {n: b.numpy() for n, b in ref["model"].named_buffers()
                         if "running" in n}, DP_TOL)
    assert rel_err(r0["pred"].numpy(), ref["pred"].numpy()) <= DP_TOL
    np.testing.assert_allclose(r0["eval_metric"].numpy(), ref["eval_metric"].numpy(),
                               rtol=DP_METRIC_TOL)
    assert r0["comm"]["bytes"] == 4 * sum(g.numel() for g in r0["grads"].values())


def dp_check_ranks_end_bit_equal(family, ranks_out):
    """One optimizer update from the same all-reduced gradient: every
    parameter and buffer is the same on both ranks, bit for bit, and so
    are the returned rows."""
    for name in (f"{family}-natural", f"{family}-inject"):
        if family == "nlspn" and name.endswith("inject"):
            continue
        r0, r1 = ranks_out(name)
        for key in ("params", "buffers", "grads"):
            assert r0[key].keys() == r1[key].keys()
            for n in r0[key]:
                assert torch.equal(r0[key][n], r1[key][n]), (name, key, n)
        for key in ("loss", "loss_val", "metric", "pred", "eval_metric"):
            assert torch.equal(r0[key], r1[key]), (name, key)
