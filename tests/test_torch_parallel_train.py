"""The port's data-parallel training and eval steps on two gloo ranks (CPU
processes started by the port's launcher, ``test_torch_parallel_support``)
against JAX's ``data:2`` mesh and against the port's one-process step.

Three families at micro size, f32: ``mmbev_res18`` + ``DDIMDepthEstimate_Res``
(the JAX data-parallel tests' model, here with the Sig term too), ``swin_micro``
under the flagship head at ``accum_steps=2`` with ``1.0*L1+1.0*L2+1.0*DDIM``,
and NLSPN (resnet18, prop_time 3). Every batch has uneven valid-pixel counts
per rank (rank 0's rows are 85% invalid, rank 1's 5%), so a batch-level term
taken per rank (a DDIM mean counted N times, per-rank Sig terms, averaged
RMSEs) would not match.

* Against JAX's ``make_train_step(mesh=create_mesh("data:2", ...))`` with the
  same weights and the same draws (the starting latent, the ddim_loss noise
  and timesteps handed to both, drop-path off): the loss, the loss and
  metric rows at ``test_torch_train_step``'s 2e-3, every gradient at 2e-3 of
  its leaf's largest value (JAX steps with SGD at lr 1, so its parameter
  change is minus the gradient), the BatchNorm statistics at 1e-5; the eval
  step's pred and metric row at ``test_torch_model_eval``'s 1e-3. JAX runs
  in f64 (``jax.enable_x64``) for swin and NLSPN, as ``test_torch_nlspn``
  holds NLSPN: at this batch JAX's own f32 gradient of swin_micro's FPN
  (``conv_up``) lies 3.7e-3 of the leaf from its f64 one, while the port's
  f32 lies within 2.3e-4. For res18 it runs in f32: CBAM's BatchNorm over
  (B, 1, 1, C) maps (ROADMAP, "Conditioning") moves the f32 gradients of
  the first stage 4.3e-3 from f64 in both packages alike, and the two f32
  steps agree to 4.9e-4.
* Against the port's one-process step on the whole batch with the same
  generator seed (no injected draws; drop-path on for swin): the draws are
  the global batch's on every rank, so the two differ only by the order of
  f32 sums (the BatchNorm moments and the gradient summed over the ranks).
  Loss and loss row to 1e-5 (measured 1.2e-7), the metric row to 1e-4 (the
  inverse-depth sums cancel: 9.6e-6 measured for NLSPN), every gradient to
  1e-3 of its leaf's largest value (measured: 4.4e-6 for NLSPN; res18 3.3e-6
  but for the bias of the depth decoder's first deconv, which BatchNorm
  follows, so that its gradient is float noise, 2.5e-4; swin 1.6e-4 in the
  denoiser's noise embedding, fed through both sampler steps), and the
  parameters after Adam's first update within 2 lr: Adam's first step is
  about lr sign(g), and a near-zero gradient whose sign flips under another
  reduction order moves a weight by up to 2 lr
  (``tests/test_parallel_training.py:96-99`` allows the same). The eval
  step's pred to 1e-5.
* The two ranks end with bit-equal parameters and buffers.

Both packages run on the CPU, the port with oneDNN off: oneDNN's
convolution backward loses precision at some shapes (NLSPN's conv5 weight
gradient at batch 4 lay 50% of the leaf from JAX's, whose f32 and f64 agree
to 7e-6; 9.4e-6 with PyTorch's own kernels).
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu.losses import LossComputer as JLossComputer  # noqa: E402
from diffusiondepth_tpu.models.backbones import swin as jswin  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.models.nlspn import NLSPNModel as JNLSPN  # noqa: E402
from diffusiondepth_tpu.parallel import mesh as jmesh  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu.training.steps import (  # noqa: E402
    make_eval_step as jmake_eval_step, make_train_step as jmake_train_step,
)
from diffusiondepth_tpu.training.train_state import TrainState  # noqa: E402
from diffusiondepth_tpu_torch import Config, LossComputer, build_model  # noqa: E402
from diffusiondepth_tpu_torch.losses import sig_loss  # noqa: E402
from diffusiondepth_tpu_torch.metrics import evaluate_depth_metrics  # noqa: E402
from diffusiondepth_tpu_torch.parallel import rank_rows  # noqa: E402
from diffusiondepth_tpu_torch.training.optim import make_lr_schedule  # noqa: E402
from diffusiondepth_tpu_torch.training.steps import make_eval_step, make_train_step  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import (  # noqa: E402
    Draws, FixedLatent, close_leaves, init_latent, jax_model, jax_variables, module_variables,
    named, port_config, rel_err,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
STEPS = 2
JAX_TOL, JAX_EVAL_TOL = 2e-3, 1e-3
DP_TOL, DP_METRIC_TOL, DP_GRAD_TOL = 1e-5, 1e-4, 1e-3
JAX_F64 = {"res18": False, "swin": True, "nlspn": True}
SEED = 5
NLSPN_FLAGS = dict(model_name="NLSPN", network="resnet18", prop_time=3, prop_kernel=3,
                   affinity="TGASS", conf_prop=True, prop_stencil_radius=6,
                   loss="1.0*L1+1.0*L2", max_depth=90.0)
# family -> (global batch, accum_steps, height, width, loss)
FAMILIES = {
    "res18": (8, 1, 32, 48, "1.0*L1+1.0*L2+1.0*Sig+1.0*DDIM"),
    "swin": (4, 2, 64, 96, "1.0*L1+1.0*L2+1.0*DDIM"),
    "nlspn": (4, 1, 32, 48, NLSPN_FLAGS["loss"]),
}


@pytest.fixture(autouse=True, scope="module")
def _no_onednn():
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = enabled


def _uneven_batch(seed, b, h, w, accum, depth):
    """rgb, gt in (1, 1 + ``depth``) (and NLSPN's dep): rank 0's rows 85%
    invalid, rank 1's 5%."""
    rng = np.random.RandomState(seed)
    gt = (rng.rand(b, h, w, 1) * depth + 1).astype(np.float32)
    invalid = np.zeros((b,), np.float32)
    for r, share in enumerate((0.85, 0.05)):
        invalid[rank_rows(b, accum, r, RANKS)] = share
    gt[rng.rand(b, h, w, 1) < invalid[:, None, None, None]] = 0.0
    dep = (gt * (rng.rand(b, h, w, 1) > 0.9)).astype(np.float32)
    return {"rgb": rng.randn(b, h, w, 3).astype(np.float32), "gt": gt, "dep": dep}


@functools.lru_cache(maxsize=None)
def _family(family):
    """(port Config at data:2, JAX model, variables, the port's state dict,
    train batch, eval batch, draws) of a family."""
    b, accum, h, w, loss = FAMILIES[family]
    if family == "nlspn":
        cfg = Config(**NLSPN_FLAGS, batch_size=b, mesh_shape=f"data:{RANKS}").finalize()
        batch = _uneven_batch(SEED, b, h, w, accum, 80.0)
        jm = JNLSPN(args=jconfig.Config(**NLSPN_FLAGS).finalize())
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
        base = port_config(STEPS, family=family)
        cfg = dataclasses.replace(base, loss=loss, batch_size=b, accum_steps=accum,
                                  max_depth=10.0 if family == "res18" else 88.0,
                                  mesh_shape=f"data:{RANKS}")
        batch = _uneven_batch(SEED, b, h, w, accum, 8.0)  # make_batch's range
        jm = jax_model(steps=STEPS, family=family)
        variables = jax_variables(jm, {k: v[:2] for k, v in batch.items()})
        micro = {"gt": batch["gt"][:b // accum]}
        lat = init_latent(1, micro)
        rng = np.random.RandomState(2)
        draws = {"lat": lat, "noise": rng.randn(*lat.shape).astype(np.float32),
                 "ts": rng.randint(0, 1000, (b // accum,)).astype(np.int64),
                 "eval_lat": init_latent(3, batch)}
    ebatch = _uneven_batch(SEED + 1, b, h, w, 1, 80.0 if family == "nlspn" else 8.0)
    sd = jax_to_state_dict(variables["params"], variables.get("batch_stats"))
    return cfg, jm, variables, sd, batch, ebatch, draws


def _reductions_case():
    rng = np.random.RandomState(9)
    b = 4
    gt = (rng.rand(b, 16, 24, 1) * 50 + 1).astype(np.float32)
    for r, share in enumerate((0.85, 0.05)):
        rows = rank_rows(b, 1, r, RANKS)
        gt[rows] = np.where(rng.rand(len(rows), 16, 24, 1) < share, 0.0, gt[rows])
    pred = (gt + rng.randn(*gt.shape) * 3 * (1 + np.arange(b)[:, None, None, None])).clip(0.1)
    return {"name": "reductions", "mesh_shape": f"data:{RANKS}", "pred": pred.astype(np.float32),
            "gt": gt}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every case run once by two gloo ranks in one spawned group."""
    case_dir = tmp_path_factory.mktemp("ranks")
    cases = [_reductions_case()]
    for family in FAMILIES:
        cfg, _, _, sd, batch, ebatch, draws = _family(family)
        common = {"mesh_shape": cfg.mesh_shape, "config": cfg.to_dict(), "state_dict": sd,
                  "batch": batch, "eval_batch": ebatch, "seed": SEED}
        cases.append(dict(common, name=f"{family}-natural"))
        if draws is not None:
            cases.append(dict(common, name=f"{family}-inject", inject=draws))
    torch.save(cases, case_dir / "cases.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "test_torch_parallel_support.py"),
                           str(case_dir), str(_free_port()), str(RANKS)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]

    def load(name):
        return [torch.load(case_dir / f"{name}_{r}.pt", weights_only=False) for r in range(RANKS)]

    return load


def _jax_run(family, monkeypatch, f64=True):
    """JAX's data:2 train step (SGD, lr 1, so the parameter change is minus
    the gradient) and eval step, in f64 or f32, on the family's batches with
    the injected draws: (loss, loss row, metric row, gradients, batch
    statistics, eval pred, eval metric row)."""
    cfg, jm, variables, _, batch, ebatch, draws = _family(family)
    kw = dict(loss=cfg.loss, batch_size=cfg.batch_size, accum_steps=cfg.accum_steps,
              max_depth=cfg.max_depth, optimizer="SGD", momentum=0.0, lr=1.0, warm_up=False,
              weight_decay=0.0)
    if family == "nlspn":
        jcfg = dataclasses.replace(jconfig.Config(**NLSPN_FLAGS).finalize(), **kw)
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

    mesh = jmesh.create_mesh(f"data:{RANKS}", jax.devices()[:RANKS])
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


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_and_eval_step_match_jax_data_mesh(family, ranks_out, monkeypatch):
    """Two gloo ranks against JAX's data:2 mesh: one train step and one
    eval step (see the module docstring for the tolerances)."""
    name = f"{family}-inject" if family != "nlspn" else "nlspn-natural"
    r0 = ranks_out(name)[0]
    ref = _jax_run(family, monkeypatch, JAX_F64[family])
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


def _one_process(family):
    """The port's one-process train and eval step on the whole batches,
    the generator seeded as on every rank."""
    cfg, _, _, sd, batch, ebatch, _ = _family(family)
    cfg = dataclasses.replace(cfg, mesh_shape=None)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    pred, emet, _ = make_eval_step(model)({k: torch.from_numpy(v) for k, v in ebatch.items()},
                                          generator=torch.Generator().manual_seed(SEED + 1))
    state = create_train_state(model, cfg, 10)
    step = make_train_step(model, LossComputer(cfg), state.optimizer, cfg.accum_steps)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, lval, met = step(tb, torch.Generator().manual_seed(SEED))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    return dict(loss=loss, loss_val=lval, metric=met, grads=grads, model=model, pred=pred,
                eval_metric=emet, lr=make_lr_schedule(cfg, 10)(0))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ranks_match_one_process(family, ranks_out):
    """Two ranks against one process on the same global batch and seed:
    the numbers do not depend on the number of ranks."""
    r0 = ranks_out(f"{family}-natural")[0]
    ref = _one_process(family)
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


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ranks_end_bit_equal(family, ranks_out):
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


def test_sig_and_metrics_over_uneven_ranks(ranks_out):
    """Sig and the metric row under the mesh are the global batch's, with
    rank 0's rows 85% invalid and rank 1's 5%; the mean of the two ranks'
    own rows is not (the error the global sums prevent)."""
    case = _reductions_case()
    pred, gt = torch.from_numpy(case["pred"]), torch.from_numpy(case["gt"])
    sig = sig_loss(pred, gt).item()
    row = evaluate_depth_metrics({"gt": gt}, {"pred": pred}).numpy()
    outs = ranks_out("reductions")
    for out in outs:
        np.testing.assert_allclose(out["sig"].item(), sig, rtol=1e-6)
        np.testing.assert_allclose(out["metrics"].numpy(), row, rtol=1e-6)
    naive = np.mean([o["local_metrics"].numpy() for o in outs], axis=0)
    assert np.abs(naive[0, 0] - row[0, 0]) > 1e-2 * row[0, 0]  # RMSE of the averaged rows
