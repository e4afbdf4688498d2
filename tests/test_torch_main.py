"""The port's ``main`` against the JAX package's ``main``, end to end on a
small KITTI-DC tree on disk: train 1 epoch (2 steps), val and test, in f32,
``mmbev_res18`` + ``DDIMDepthEstimate_Res``, 2 DDIM steps, no augmentation.

Both runs start from the same weights: a JAX state saved by JAX's
``save_checkpoint``, lifted with ``jax_to_state_dict`` into a port
checkpoint, and given to each run as ``--pretrain``. The two packages draw
their random numbers differently, so both are handed the same draws: the
sampler's starting latent and the ddim_loss noise as a fixed array per
shape, the ddim_loss timesteps as fixed values. JAX runs on one CPU device.

Tolerance 2e-3, as the train-step tests (tests/test_torch_train_step.py):
both run f32, sums are taken in another order, and the differences grow
through the sampler and the reciprocal decode. Logged values are rounded
to 4 decimals, so each is held to 2e-3 of its value plus 1e-4. The runs
train with SGD (momentum 0.9, warm-up), so that the weights' change is
linear in the gradients and is held to the same tolerance; Adam's first
steps move every weight by about the learning rate whatever the size of
its gradient, so a gradient of float noise would move a weight as far as
a real one (the train-step tests hold Adam's rule).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu import main as jmain  # noqa: E402
from diffusiondepth_tpu.models.heads import ddim_head as jhead  # noqa: E402
from diffusiondepth_tpu.parallel import mesh as jmesh  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu.training.train_state import TrainState as JTrainState  # noqa: E402
from diffusiondepth_tpu.utils import checkpoint as jckpt  # noqa: E402
from diffusiondepth_tpu_torch import build_model, main as pmain  # noqa: E402
from diffusiondepth_tpu_torch.config import parse_args  # noqa: E402
from diffusiondepth_tpu_torch.models.heads.ddim_head import DDIMDepthEstimateHead  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402
from diffusiondepth_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_support import close_leaves, jax_model, jax_variables, named  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 2e-3
FLAGS = ["--data_name", "KITTIDC", "--model_name", "Diffusion_DCbase_",
         "--backbone_module", "mmbev_resnet", "--backbone_name", "mmbev_res18",
         "--head_specify", "DDIMDepthEstimate_Res", "--inference_steps", "2",
         "--patch_height", "32", "--patch_width", "64", "--top_crop", "2", "--no_augment",
         "--batch_size", "2", "--test_batch_size", "2", "--epochs", "1", "--num_threads", "2",
         "--log_every", "1", "--optimizer", "SGD", "--lr", "0.05"]


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """4 train and 2 val frames of 36x72, 2 test frames of 32x64."""
    root = tmp_path_factory.mktemp("kitti_main")
    rng = np.random.RandomState(0)
    split = {}
    for mode, n, (h, w) in (("train", 4, (36, 72)), ("val", 2, (36, 72)), ("test", 2, (32, 64))):
        entries = []
        for i in range(n):
            d = root / mode / f"drive_{i}"
            os.makedirs(d, exist_ok=True)
            ramp = np.linspace(0, 1, h)[:, None, None]
            rgb = 180 * ramp * rng.rand(1, 1, 3) + 60 * rng.rand(h, w, 3)
            Image.fromarray(rgb.astype(np.uint8)).save(d / "image_02.png")
            depth = (4.0 + 60.0 * ramp[..., 0] + rng.rand(h, w)) * 256
            for name, share in (("dep", 0.2), ("gt", 0.6)):
                Image.fromarray(np.where(rng.rand(h, w) < share, depth, 0).astype(np.uint16)
                                ).save(d / f"{name}.png")
            p = "7.2e+02 0.0 3.3e+01 4.4e+01 0.0 7.2e+02 1.7e+01 2.1e-01 0.0 0.0 1.0 2.7e-03"
            (d / "calib.txt").write_text(f"P_rect_02: {p}\n")
            (d / "intr.txt").write_text("721.5 0.0 32.5 0.0 721.5 16.2 0.0 0.0 1.0\n")
            entries.append({"rgb": f"{mode}/drive_{i}/image_02.png",
                            "depth": f"{mode}/drive_{i}/dep.png", "gt": f"{mode}/drive_{i}/gt.png",
                            "K": f"{mode}/drive_{i}/{'intr' if mode == 'test' else 'calib'}.txt"})
        split[mode] = entries
    (root / "split.json").write_text(json.dumps(split))
    return root


def _noise(shape):
    shape = tuple(int(s) for s in shape)
    return np.random.RandomState(sum(shape) + 7 * len(shape)).randn(*shape).astype(np.float32)


def _timesteps(b):
    return np.array([413, 77, 901, 5][:b], np.int64)


class _JaxDraws:
    """Stands in for ``jax`` inside the JAX head: ``random.normal`` gives
    ``_noise(shape)``, ``random.randint`` gives ``_timesteps``."""

    def __init__(self):
        rnd = jax.random

        class _Random:
            def __getattr__(self, k):
                return getattr(rnd, k)

            @staticmethod
            def normal(key, shape, dtype=jnp.float32):
                return jnp.asarray(_noise(shape), dtype)

            @staticmethod
            def randint(key, shape, lo, hi):
                return jnp.asarray(_timesteps(shape[0]), jnp.int32)

        self.random = _Random()

    def __getattr__(self, k):
        return getattr(jax, k)


@pytest.fixture
def same_draws(monkeypatch):
    """The same draws in both packages; JAX on one device."""
    monkeypatch.setattr(jhead, "jax", _JaxDraws())
    monkeypatch.setattr(jmain, "create_mesh",
                        lambda spec=None: jmesh.create_mesh(None, jax.devices()[:1]))
    sample, ddim_loss = DDIMDepthEstimateHead._sample, DDIMDepthEstimateHead._ddim_loss
    monkeypatch.setattr(DDIMDepthEstimateHead, "_sample",
                        lambda self, c, shape, g=None, i=None:
                        sample(self, c, shape, g, torch.from_numpy(_noise(shape))))
    monkeypatch.setattr(DDIMDepthEstimateHead, "_ddim_loss",
                        lambda self, r, c, g=None: ddim_loss(
                            self, r, c, g, noise=torch.from_numpy(_noise(r.shape)),
                            timesteps=torch.from_numpy(_timesteps(r.shape[0]))))


@functools.lru_cache(maxsize=None)
def _start_variables():
    jm = jax_model(steps=2, family="res18")
    batch = {"rgb": np.zeros((1, 32, 64, 3), np.float32),
             "gt": np.ones((1, 32, 64, 1), np.float32)}
    return jax_variables(jm, batch, seed=3)


@pytest.fixture(scope="module")
def start_ckpts(kitti_root, tmp_path_factory):
    """The JAX start state written by JAX's save_checkpoint, and the same
    state lifted into a port checkpoint."""
    d = tmp_path_factory.mktemp("start")
    variables = _start_variables()
    jcfg = jconfig.parse_args(FLAGS)
    tx = jmake_optimizer(jcfg, 2)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), tx=tx)
    jpath = jckpt.save_checkpoint(str(d / "jax"), 0, state, jcfg)
    payload = jckpt.load_checkpoint(jpath)
    pcfg = parse_args(FLAGS)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(jax_to_state_dict(payload["params"], payload["batch_stats"]))
    ppath = save_checkpoint(str(d / "port"), 0, create_train_state(model, pcfg, 2), pcfg)
    return jpath, ppath


def _flags(root, extra=()):
    return FLAGS + ["--dir_data", str(root), "--split_json", str(root / "split.json"), *extra]


def _logged(path):
    rows = []
    for line in Path(path).read_text().splitlines():
        rows.append([float(kv.split(": ")[1]) for kv in line.split("|", 2)[2].split("  ")
                     if ": " in kv])
    return np.asarray(rows)


def test_main_matches_jax(kitti_root, start_ckpts, same_draws, tmp_path):
    """``main.train`` (train -> checkpoint -> val -> test) then ``main.test``
    on the saved checkpoint, in both packages: the loss and metric logs and
    the final weights and BatchNorm statistics agree."""
    jpath, ppath = start_ckpts
    jcfg = jconfig.parse_args(_flags(kitti_root, ["--pretrain", jpath]))
    jcfg.save_dir = str(tmp_path / "jax")
    pcfg = parse_args(_flags(kitti_root, ["--pretrain", ppath]))
    pcfg.save_dir = str(tmp_path / "port")
    jstate = jmain.train(jcfg)
    pstate = pmain.train(pcfg, device="cpu")
    assert int(jstate.step) == pstate.step == 2

    for name in ("loss_train.txt", "metric_train.txt", "metric_val.txt", "metric_test.txt"):
        ours, ref = _logged(tmp_path / "port" / name), _logged(tmp_path / "jax" / name)
        assert ours.shape == ref.shape and ours.shape[0] == 1, name
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=1e-4, err_msg=name)
    weights = {n: p.detach().numpy() for n, p in pstate.model.named_parameters()}
    ref_weights = named(jstate.params)
    close_leaves(weights, ref_weights, TOL)
    start = named(_start_variables()["params"])
    close_leaves({n: w - start[n] for n, w in weights.items()},
                 {n: w - start[n] for n, w in ref_weights.items()}, TOL)
    stats = {n: b.numpy() for n, b in pstate.model.named_buffers() if n.endswith(("mean", "var"))}
    ref = {k: v for k, v in named(jstate.params, jstate.batch_stats).items()
           if k.endswith(("mean", "var"))}
    # the second step's batch statistics come from the weights after the
    # first update, which agree to TOL, so the running statistics do too
    close_leaves(stats, ref, TOL)

    # --test_only on the epoch's checkpoint, with the KITTI submission PNGs
    test_flags = ["--test_only", "--save_image", "--save_result_only"]
    jcfg = jconfig.parse_args(_flags(kitti_root, test_flags + [
        "--pretrain", str(tmp_path / "jax" / "model_00001.ckpt")]))
    jcfg.save_dir = str(tmp_path / "jax_test")
    pcfg = parse_args(_flags(kitti_root, test_flags + [
        "--pretrain", str(tmp_path / "port" / "model_00001.ckpt")]))
    pcfg.save_dir = str(tmp_path / "port_test")
    jmain.test(jcfg)
    pmain.test(pcfg, device="cpu")
    np.testing.assert_allclose(_logged(tmp_path / "port_test" / "metric_test.txt"),
                               _logged(tmp_path / "jax_test" / "metric_test.txt"),
                               rtol=TOL, atol=1e-4)
    names = sorted(os.listdir(tmp_path / "port_test" / "test" / "epoch0000"))
    assert names == sorted(os.listdir(tmp_path / "jax_test" / "test" / "epoch0000"))
    assert names == ["0000000000.png", "0000000001.png"]


class _Stop(Exception):
    pass


def test_resume_equals_a_continuous_run(kitti_root, start_ckpts, same_draws, tmp_path,
                                        monkeypatch):
    """With --save_full and fixed draws, a 2-epoch run stopped after its
    first epoch's checkpoint and resumed with --resume --pretrain ends with
    the same weights, statistics and optimizer count as the run that was not
    stopped, bit for bit."""
    flags = _flags(kitti_root, ["--pretrain", start_ckpts[1], "--epochs", "2", "--save_full"])
    cfg = parse_args(flags)
    cfg.save_dir = str(tmp_path / "continuous")
    whole = pmain.train(cfg, device="cpu")

    save = pmain.save_checkpoint

    def save_then_stop(save_dir, epoch, *a, **k):
        path = save(save_dir, epoch, *a, **k)
        raise _Stop(path)

    cfg = parse_args(flags)
    cfg.save_dir = str(tmp_path / "stopped")
    with monkeypatch.context() as m:
        m.setattr(pmain, "save_checkpoint", save_then_stop)
        with pytest.raises(_Stop):
            pmain.train(cfg, device="cpu")
    cfg = parse_args(_flags(kitti_root, ["--resume", "--pretrain",
                                         str(tmp_path / "stopped" / "model_00001.ckpt")]))
    cfg.save_dir = str(tmp_path / "resumed")
    resumed = pmain.train(cfg, device="cpu")

    assert resumed.optimizer.count == whole.optimizer.count == 4
    assert (tmp_path / "resumed" / "loss_train.txt").read_text().startswith("0002 |")
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_main_without_a_card_raises(kitti_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would run on it")
    cfg = parse_args(_flags(kitti_root))
    cfg.save_dir = str(tmp_path)
    for fn in (pmain.train, pmain.test):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(cfg)


def test_help_runs():
    """``python -m diffusiondepth_tpu_torch.main --help`` exits 0."""
    out = subprocess.run([sys.executable, "-m", "diffusiondepth_tpu_torch.main", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--dir_data", "--test_only", "--save_result_only", "--accum_steps"):
        assert flag in out.stdout
