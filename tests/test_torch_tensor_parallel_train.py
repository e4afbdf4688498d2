"""The port's tensor-parallel training and eval steps on gloo CPU ranks
(started by the port's launcher, ``test_torch_parallel_support``), the
parameters cut by ``state_sharding`` at ``min_size`` 2**12, against JAX's
sharded step and against the port's one-process step. The batches are
``test_torch_parallel_train``'s: each data rank's rows hold a different
share of invalid pixels.

* ``mmbev_res18`` + ``DDIMDepthEstimate_Res`` (with Sig), batch 8 at
  32x48, f32, on four ranks at ``data:2,model:2``, against JAX's
  ``make_train_step(mesh=create_mesh("data:2,model:2", ...),
  state_shardings=state_sharding(..., min_size=2**12))`` and its eval step,
  with the same weights and injected draws, JAX in f32, at
  ``test_torch_parallel_train``'s res18 tolerances: loss, loss and metric
  rows 2e-3, the BatchNorm statistics 1e-5, the eval pred and metric row
  1e-3; every whole gradient (rebuilt from the shards) 2e-3 of its leaf
  against JAX's ``data:2`` step (the test's docstring says why).
* ``swin_micro`` under the flagship head at ``accum_steps=2`` on two ranks
  at ``model:2`` (drop-path on), and NLSPN on four at ``data:2,model:2``,
  against the port's one process on the whole batch with the same
  generator seed, at that file's ``DP_*`` tolerances: loss and loss row
  1e-5, metric row 1e-4, whole gradients 1e-3 of each leaf, each leaf's
  change by Adam's first update within 0.25 of one process's (relative
  L2 weighted by |gradient|; a leaf left unchanged reads 1), the eval
  pred 1e-5. The sharded
  layers change only the order of f32 sums, and the weights are
  ``test_torch_parallel_train``'s. Other weights can part the f32 steps
  by percents of one leaf: where a ReLU's input lies within rounding of
  zero, another order of sums moves it across and drops or keeps that
  pixel's gradient, and a stride-2 ``conv_up`` ConvTranspose2d's weight
  gradient sums few terms per element. With every kernel drawn
  N(0, 1/fan-in) from seed 3 the sharded step lay 10.9% of
  ``conv_up.1.0.weight`` from one process, all of it in output channel
  104, whose BatchNorm output holds the value nearest zero of the layer
  (7.5e-8, at an even pixel: the kernel tap that the gradient concentrates
  on); the same whole step run in f64 at those weights, with the same
  draws, agrees with one process to 1.0e-13 of a leaf, and res18's
  data:2,model:2 step in f64 to 1.1e-10 (CBAM's conditioning). So the
  sharded step computes one process's function
  (``tests/tensor_parallel_rounding_check.py`` reproduces each number).
* Each route of a sharded layer (column-parallel Conv2d, ConvTranspose2d
  and Linear, the weight-gather of a depthwise conv and of an embedding,
  flax's attention) in f64 on the two ranks: the
  output, dX and every whole gradient are the unsharded layers' to 1e-12.
* A checkpoint of the sharded state holds whole tensors: the gathered
  parameters bit for bit and Adam moments of their whole shapes; it loads
  into one process, and each rank restores its shards from it bit for
  bit.
* Every rank holds only its shards: its parameters and Adam moments have
  the elements that the sharding reckons, and a model group's whole
  tensors (replicated ones, the gathered shards, the buffers) are
  bit-equal across its ranks.

Both packages run on the CPU with oneDNN off, as in
``test_torch_parallel_train``.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.parallel import mesh as jmesh  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu.training.steps import (  # noqa: E402
    make_eval_step as jmake_eval_step, make_train_step as jmake_train_step,
)
from diffusiondepth_tpu.training.train_state import TrainState  # noqa: E402
from diffusiondepth_tpu_torch import LossComputer, build_model  # noqa: E402
from diffusiondepth_tpu_torch.parallel import Mesh, state_sharding  # noqa: E402
from diffusiondepth_tpu_torch.training.optim import make_lr_schedule  # noqa: E402
from diffusiondepth_tpu_torch.training.steps import make_eval_step, make_train_step  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402

from test_torch_support import (  # noqa: E402
    DP_GRAD_TOL, DP_METRIC_TOL, DP_TOL, Draws, FixedLatent, close_leaves, free_port, named,
    rel_err,
)
from test_torch_support import DP_JAX_EVAL_TOL as JAX_EVAL_TOL  # noqa: E402
from test_torch_support import DP_JAX_TOL as JAX_TOL  # noqa: E402
from test_torch_support import DP_REPO as REPO  # noqa: E402
from test_torch_support import DP_SEED as SEED  # noqa: E402
from test_torch_support import dp_family as _family  # noqa: E402

torch.set_num_threads(1)

MIN_SIZE = 2**12
# Adam's first step against one process's, relative L2 per leaf weighted
# by one process's |gradient|: an update left out reads 1, one of the
# wrong sign 2. Adam's first step is about lr times the gradient's sign,
# so elements whose gradient is noise around zero (the key third of a qkv
# bias) take either sign; unweighted, swin's stage-0 qkv bias read 0.073
ADAM_STEP_TOL = 0.25
# case -> (family, mesh, ranks, injected draws)
CASES = {"res18": ("res18", "data:2,model:2", 4, True),
         "swin": ("swin", "model:2", 2, False),
         "nlspn": ("nlspn", "data:2,model:2", 4, False)}


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


def _case(name):
    """(port Config at the case's mesh, state dict, train batch, eval
    batch, draws): ``test_torch_parallel_train``'s family."""
    family, spec, _, _ = CASES[name]
    cfg, _, _, sd, batch, ebatch, draws = _family(family)
    return dataclasses.replace(cfg, mesh_shape=spec), sd, batch, ebatch, draws


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every case run once, by one spawned group per number of ranks."""
    root = tmp_path_factory.mktemp("tp_ranks")
    for n in sorted({c[2] for c in CASES.values()}):
        case_dir = root / str(n)
        case_dir.mkdir()
        cases = []
        for name, (family, spec, ranks, inject) in CASES.items():
            if ranks != n:
                continue
            cfg, sd, batch, ebatch, draws = _case(name)
            cases.append({"name": name, "mesh_shape": spec, "config": cfg.to_dict(),
                          "state_dict": sd, "batch": batch, "eval_batch": ebatch, "seed": SEED,
                          "min_size": MIN_SIZE, "inject": draws if inject else None})
        if n == 2:
            cases.append(dict(_layers_case(), mesh_shape="model:2", min_size=256))
        torch.save(cases, case_dir / "cases.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        proc = subprocess.run([sys.executable,
                               str(REPO / "tests" / "test_torch_parallel_support.py"),
                               str(case_dir), str(free_port()), str(n)],
                              capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]

    def load(name):
        n = CASES[name][2] if name in CASES else 2
        return [torch.load(root / str(n) / f"{name}_{r}.pt", weights_only=False)
                for r in range(n)]

    load.root = root
    return load


def _layers_case():
    rng = np.random.RandomState(3)
    return {"name": "layers", "x": rng.randn(2, 4, 6, 8), "t": np.array([3, 7]),
            "w": rng.randn(2, 96, 32)}


def test_sharded_layer_routes_are_exact(ranks_out):
    """f64, model:2 at min_size 256: the sharded routes compute the whole
    layers' output and gradients to rounding (each gradient leaf to 1e-12
    of its largest value, floored as ``close_leaves`` floors it), and every
    weight of at least 256 elements is cut."""
    from test_torch_parallel_support import tp_layers

    case = _layers_case()
    layers = tp_layers()
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y = layers(x, torch.from_numpy(case["t"]))
    (y * torch.from_numpy(case["w"])).sum().backward()
    grads = {n: p.grad.numpy() for n, p in layers.named_parameters()}
    for out in ranks_out("layers"):
        assert rel_err(out["y"].numpy(), y.detach().numpy()) <= 1e-12
        assert rel_err(out["dx"].numpy(), x.grad.numpy()) <= 1e-12
        # the key projection's bias has an analytically zero gradient
        close_leaves({n: g.numpy() for n, g in out["grads"].items()}, grads, 1e-12)
        for n, p in layers.named_parameters():
            cut = p.ndim >= 2 and p.numel() >= 256
            assert out["local"][n] == p.numel() // (2 if cut else 1), n


def _jax_run(monkeypatch):
    """JAX's data:2,model:2 train step (SGD, lr 1: the parameter change is
    minus the gradient) with the state sharded at MIN_SIZE and its eval
    step, and the gradients of its data:2 train step, in f32, on res18's
    batches with the injected draws."""
    cfg, jm, variables, _, batch, ebatch, draws = _family("res18")
    jcfg = dataclasses.replace(
        jconfig.Config(), loss=cfg.loss, batch_size=cfg.batch_size, accum_steps=1,
        max_depth=cfg.max_depth, optimizer="SGD", momentum=0.0, lr=1.0, warm_up=False,
        weight_decay=0.0)
    monkeypatch.setattr(jhead, "jax", Draws(draws["noise"], draws["ts"]))
    mesh = jmesh.create_mesh("data:2,model:2", jax.devices()[:4])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = jmake_optimizer(jcfg, 10, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=jax.jit(tx.init)(params), tx=tx)
    sh = jmesh.state_sharding(state, mesh, min_size=MIN_SIZE)
    model = FixedLatent(jm, jnp.asarray(draws["lat"]))
    jstep = jmake_train_step(model, JLossComputer(jcfg), mesh=mesh, donate=False,
                             state_shardings=sh)
    new, loss, lval, met = jstep(jax.device_put(state, sh), jmesh.shard_batch(batch, mesh),
                                 jax.random.PRNGKey(0))
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float64))
    dmesh = jmesh.create_mesh("data:2", jax.devices()[:2])
    dstep = jmake_train_step(model, JLossComputer(jcfg), mesh=dmesh, donate=False)
    dnew = dstep(state, jmesh.shard_batch(batch, dmesh), jax.random.PRNGKey(0))[0]
    grads = named(to_np(jax.tree_util.tree_map(lambda a, b: a - b, params, dnew.params)))
    sharded = {k for k, v in named(jax.tree_util.tree_map(
        lambda a, s: np.full(a.shape, float("model" in str(s.spec)), np.float32),
        params, sh.params)).items() if v.any()}
    estep = jmake_eval_step(FixedLatent(jm, jnp.asarray(draws["eval_lat"])), mesh=mesh)
    pred, emet, _ = estep(state, jmesh.shard_batch(ebatch, mesh), jax.random.PRNGKey(1))
    return dict(loss=float(loss), loss_val=np.asarray(lval, np.float64),
                metric=np.asarray(met, np.float64), grads=grads,
                stats=named(to_np(new.params), to_np(new.batch_stats)),
                pred=np.asarray(pred), eval_metric=np.asarray(emet), sharded=sharded)


def test_res18_step_matches_jax_sharded_2d_mesh(ranks_out, monkeypatch):
    """Four ranks at data:2,model:2 against JAX's sharded step on the same
    mesh: the same tensors cut, and the same loss, rows, BatchNorm
    statistics and eval step. The gradients are held against JAX's
    ``data:2`` step (the same arithmetic without the 'model' axis): JAX's
    f32 sharded step, whose forward is its data:2 one to 1e-7, returns
    gradients that part from its own data:2 ones by 15% of
    ``depth_head.conv_up.0.0.weight``, all of it in output channel 255 and
    mostly one kernel tap. That channel's BatchNorm output holds the value
    nearest zero of the layer (2.5e-6 in the port's f32 step, at an even
    pixel, that tap's): JAX's partitioned sums move that ReLU input across
    zero. With x64 on and f64 parameters JAX's two steps agree to 5.4e-7,
    and the port's sharded step in f64 agrees with its one process to
    1.1e-10 (``tests/tensor_parallel_rounding_check.py``; ROADMAP, Queue
    3)."""
    r0 = ranks_out("res18")[0]
    ref = _jax_run(monkeypatch)
    assert set(r0["sharded"]) == ref["sharded"] and ref["sharded"]
    np.testing.assert_allclose(r0["loss"].item(), ref["loss"], rtol=JAX_TOL)
    np.testing.assert_allclose(r0["loss_val"].numpy(), ref["loss_val"], rtol=JAX_TOL, atol=1e-6)
    np.testing.assert_allclose(r0["metric"].numpy(), ref["metric"], rtol=JAX_TOL)
    stats = {n: b.numpy() for n, b in r0["buffers"].items() if "running" in n}
    close_leaves(stats, {k: v for k, v in ref["stats"].items() if "running" in k}, 1e-5)
    grads = {n: r0["grads"][n].numpy() if n in r0["grads"] else np.zeros_like(g)
             for n, g in ref["grads"].items()}
    close_leaves(grads, ref["grads"], JAX_TOL)
    assert rel_err(r0["pred"].numpy(), ref["pred"]) <= JAX_EVAL_TOL
    np.testing.assert_allclose(r0["eval_metric"].numpy(), ref["eval_metric"], rtol=JAX_EVAL_TOL)


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port's one-process train and eval step on the whole batches."""
    cfg, sd, batch, ebatch, _ = _case(name)
    cfg = dataclasses.replace(cfg, mesh_shape=None)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    pred, emet, _ = make_eval_step(model)({k: torch.from_numpy(v) for k, v in ebatch.items()},
                                          generator=torch.Generator().manual_seed(SEED + 1))
    state = create_train_state(model, cfg, 10)
    step = make_train_step(model, LossComputer(cfg), state.optimizer, cfg.accum_steps)
    loss, lval, met = step({k: torch.from_numpy(v) for k, v in batch.items()},
                           torch.Generator().manual_seed(SEED))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return dict(loss=loss, loss_val=lval, metric=met, grads=grads, params=params, pred=pred,
                eval_metric=emet, lr=make_lr_schedule(cfg, 10)(0))


@pytest.mark.parametrize("name", ["swin", "nlspn"])
def test_sharded_step_matches_one_process(name, ranks_out):
    r0 = ranks_out(name)[0]
    ref = _one_process(name)
    np.testing.assert_allclose(r0["loss"].item(), ref["loss"].item(), rtol=DP_TOL)
    np.testing.assert_allclose(r0["loss_val"].numpy(), ref["loss_val"].numpy(), rtol=DP_TOL,
                               atol=1e-7)
    np.testing.assert_allclose(r0["metric"].numpy(), ref["metric"].numpy(), rtol=DP_METRIC_TOL)
    assert r0["grads"].keys() == ref["grads"].keys()
    close_leaves({n: g.numpy() for n, g in r0["grads"].items()}, ref["grads"], DP_GRAD_TOL)
    sd = _case(name)[1]
    floor = 1e-4 * max(np.abs(g).max() for g in ref["grads"].values())
    held = set()
    for n, p in ref["params"].items():
        w = np.abs(ref["grads"][n]) if n in ref["grads"] else 1.0
        if p.ndim < 2 and np.max(w) < floor:
            continue  # a bias BatchNorm follows: float noise
        step_one = (p - sd[n]).numpy()
        diff = (r0["params"][n] - sd[n]).numpy() - step_one
        num, den = np.linalg.norm(diff * w), np.linalg.norm(step_one * w)
        assert (num <= ADAM_STEP_TOL * den) if den else num == 0, (n, num, den)
        held.add(n)
    assert set(r0["sharded"]) <= held
    assert rel_err(r0["pred"].numpy(), ref["pred"].numpy()) <= DP_TOL
    np.testing.assert_allclose(r0["eval_metric"].numpy(), ref["eval_metric"].numpy(),
                               rtol=DP_METRIC_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_rank_holds_its_shards(name, ranks_out):
    """The elements of each rank's parameters and Adam moments are those
    the sharding reckons (1/k of every cut tensor), and the whole tensors
    of a model group are bit-equal."""
    family, spec, n, _ = CASES[name]
    outs = ranks_out(name)
    model = build_model(dataclasses.replace(_case(name)[0], mesh_shape=None), device="cpu")
    axes = {a.split(":")[0]: int(a.split(":")[1]) for a in spec.split(",")}
    sharding = state_sharding(model, Mesh(axes, 0, n, 0, n, torch.device("cpu")), MIN_SIZE)
    assert set(outs[0]["sharded"]) == set(sharding.sharded)
    k = axes["model"]
    for out in outs:
        for pname, p in model.named_parameters():
            local = p.numel() // k if pname in sharding.sharded else p.numel()
            assert out["local"][pname] == (local, 2 * local), pname
        assert sum(v[0] for v in out["local"].values()) == sharding.local_numel(model)
    for r, out in enumerate(outs):
        peer = outs[r - r % k]  # the first rank of r's model group
        for key in ("params", "buffers"):
            for t in out[key]:
                assert torch.equal(out[key][t], peer[key][t]), (r, key, t)
        for key in ("loss", "loss_val", "metric", "pred", "eval_metric"):
            assert torch.equal(out[key], peer[key]), (r, key)


@pytest.mark.parametrize("name", ["swin", "nlspn"])
def test_sharded_checkpoint_is_whole(name, ranks_out):
    """The sharded run's checkpoint (rank 0 writes it after the ranks of
    each model group gathered) holds the whole parameters bit for bit and
    Adam moments of their whole shapes, restores into one process
    (weights, moments, count), and gave every rank its shards back."""
    from diffusiondepth_tpu_torch.utils.checkpoint import load_checkpoint, restore_state

    outs = ranks_out(name)
    assert all(out["restored"] for out in outs)
    path = ranks_out.root / str(CASES[name][2]) / f"{name}_ckpt" / "model_00001.ckpt"
    payload = load_checkpoint(str(path))
    for n, t in outs[0]["params"].items():
        assert torch.equal(payload["state_dict"][n], t), n
    cfg = dataclasses.replace(_case(name)[0], mesh_shape=None)
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg, 10)
    restore_state(state, payload)
    assert state.optimizer.count == 1 and state.step == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), outs[0]["params"][n]), n
        assert [v.shape for v in state.optimizer.state[p].values()] == [p.shape] * 2, n
