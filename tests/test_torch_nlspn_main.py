"""The port's ``main`` against the JAX package's ``main`` for
``--model_name NLSPN`` (resnet18, prop_time 2, the stencil radius 6), end
to end on a small KITTI-DC tree on disk: train 1 epoch (2 steps), val and
test, then ``--test_only --save_image`` on the epoch's checkpoint, in f32.

Both runs start from the same weights, random and non-zero (the offset
conv's too, so that the propagation moves the depth; the initial-depth
head's bias at 30 m, so that the depth is positive), written by JAX's
``save_checkpoint`` and lifted with ``jax_to_state_dict`` into a port
checkpoint. NLSPN draws nothing, so no draw is injected. JAX runs on one
CPU device.

Tolerance 2e-3, as ``tests/test_torch_main.py``: the logged losses and
metrics (4 decimals, so 2e-3 of each value plus 1e-4), the weights and
BatchNorm statistics after the 2 SGD steps, the ``Etc/gamma`` scalar, the
raw ``guidance``/``offset``/``aff``/``gamma``/``pred`` dumps of
``NLSPNSummary``. Its PNGs (panels and per-sample maps) are colour-mapped
levels of those values: the same files, the same shapes, and at most one
pixel in a hundred on another level.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu import main as jmain  # noqa: E402
from diffusiondepth_tpu.models.nlspn import NLSPNModel as JNLSPN  # noqa: E402
from diffusiondepth_tpu.parallel import mesh as jmesh  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu.training.train_state import TrainState as JTrainState  # noqa: E402
from diffusiondepth_tpu.utils import checkpoint as jckpt  # noqa: E402
from diffusiondepth_tpu_torch import build_model, main as pmain  # noqa: E402
from diffusiondepth_tpu_torch.config import parse_args  # noqa: E402
from diffusiondepth_tpu_torch.native.png import read_png  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402
from diffusiondepth_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_main import _logged, kitti_root  # noqa: E402,F401  (the tree fixture)
from test_torch_support import close_leaves, module_variables, named  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-3
FLAGS = ["--data_name", "KITTIDC", "--model_name", "NLSPN", "--network", "resnet18",
         "--prop_time", "2", "--prop_stencil_radius", "6", "--loss", "1.0*L1+1.0*L2",
         "--patch_height", "32", "--patch_width", "64", "--top_crop", "2", "--no_augment",
         "--batch_size", "4", "--test_batch_size", "2", "--epochs", "1", "--num_threads", "2",
         "--log_every", "1", "--optimizer", "SGD", "--lr", "0.0002"]


class _JitInit:
    """A flax model whose ``init`` runs as one compiled program: JAX's
    ``main`` draws a start state it then replaces with the checkpoint, and
    op-by-op that init of NLSPN takes ~10 s per run on the CPU."""

    def __init__(self, model):
        self.model = model

    def init(self, rngs, sample, train=False):
        return jax.jit(lambda r, s: self.model.init(r, s, train=train))(rngs, sample)


@pytest.fixture
def one_device(monkeypatch):
    """JAX on one device, with its start state drawn by a compiled init."""
    monkeypatch.setattr(jmain, "create_mesh",
                        lambda spec=None: jmesh.create_mesh(None, jax.devices()[:1]))
    create = jmain.create_train_state
    monkeypatch.setattr(jmain, "create_train_state",
                        lambda model, *a, **k: create(_JitInit(model), *a, **k))


@pytest.fixture(scope="module")
def start_ckpts(tmp_path_factory):
    """The JAX start state (random weights, the offset conv's scaled so
    that offsets reach a few pixels) by JAX's save_checkpoint, and the same
    state lifted into a port checkpoint."""
    d = tmp_path_factory.mktemp("nlspn_start")
    jcfg = jconfig.parse_args(FLAGS)
    batch = {"rgb": np.zeros((1, 32, 64, 3), np.float32),
             "dep": np.ones((1, 32, 64, 1), np.float32)}
    variables = module_variables(JNLSPN(args=jcfg), batch, seed=4, train=False)
    prop = variables["params"]["prop_layer"]
    prop["conv_offset_aff"]["kernel"][..., :16] *= 2.0
    prop["aff_scale_const"] = np.asarray([4.0], np.float32)
    # an initial depth of ~30 m, as a trained model's: at random weights the
    # depth sits near 0 and the inverse metrics (iRMSE, iMAE: 1 / pred above
    # 1e-4) turn a 1e-6 difference in pred into percents
    variables["params"]["id_dec0"]["Conv_0"]["bias"][:] = 30.0
    tx = jmake_optimizer(jcfg, 2)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), tx=tx)
    jpath = jckpt.save_checkpoint(str(d / "jax"), 0, state, jcfg)
    payload = jckpt.load_checkpoint(jpath)
    pcfg = parse_args(FLAGS)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(jax_to_state_dict(payload["params"], payload["batch_stats"]),
                          strict=True)
    ppath = save_checkpoint(str(d / "port"), 0, create_train_state(model, pcfg, 2), pcfg)
    return jpath, ppath, variables


def _flags(root, extra=()):
    return FLAGS + ["--dir_data", str(root), "--split_json", str(root / "split.json"), *extra]


def _gamma(path):
    return [json.loads(line)["value"] for line in Path(path).read_text().splitlines()
            if json.loads(line)["tag"] == "Etc/gamma"]


def _png(path):
    """Decoded pixels: the port's files with the port's reader, JAX's with
    Pillow."""
    return read_png(str(path)) if "port" in str(path) else np.array(Image.open(path))


def test_nlspn_main_matches_jax(kitti_root, start_ckpts, one_device, tmp_path):  # noqa: F811
    jpath, ppath, start = start_ckpts
    jcfg = jconfig.parse_args(_flags(kitti_root, ["--pretrain", jpath]))
    jcfg.save_dir = str(tmp_path / "jax")
    pcfg = parse_args(_flags(kitti_root, ["--pretrain", ppath]))
    pcfg.save_dir = str(tmp_path / "port")
    jstate = jmain.train(jcfg)
    pstate = pmain.train(pcfg, device="cpu")
    assert int(jstate.step) == pstate.step == 1

    for name in ("loss_train.txt", "metric_train.txt", "metric_val.txt", "metric_test.txt"):
        ours, ref = _logged(tmp_path / "port" / name), _logged(tmp_path / "jax" / name)
        assert ours.shape == ref.shape and ours.shape[0] == 1, name
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=1e-4, err_msg=name)
    assert _logged(tmp_path / "port" / "loss_train.txt").shape[1] == 3  # L1, L2, Total
    for mode in ("val", "test"):
        g, gj = (_gamma(tmp_path / d / f"scalars_{mode}.jsonl") for d in ("port", "jax"))
        assert len(g) == len(gj) == 1
        np.testing.assert_allclose(g, gj, rtol=TOL)
    weights = {n: p.detach().numpy() for n, p in pstate.model.named_parameters()}
    close_leaves(weights, named(jstate.params), TOL)
    stats = {n: b.numpy() for n, b in pstate.model.named_buffers() if "running" in n}
    ref = {k: v for k, v in named(jstate.params, jstate.batch_stats).items() if "running" in k}
    close_leaves(stats, ref, TOL)
    moved = named(start["params"])
    assert any(not np.allclose(weights[n], moved[n]) for n in moved)

    # --test_only --save_image on the epoch's checkpoint: NLSPNSummary's files
    test_flags = ["--test_only", "--save_image", "--save_raw_npdepth"]
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
    files = {}
    for d in ("port_test", "jax_test"):
        root = tmp_path / d / "test"
        files[d] = sorted(os.path.relpath(os.path.join(r, f), root)
                          for r, _, fs in os.walk(root) for f in fs if "tfevents" not in f)
    assert files["port_test"] == files["jax_test"]
    per_sample = ["01_rgb.png", "02_dep.png", "03_pred_init.png", "04_pred_prop_00.png",
                  "04_pred_prop_01.png", "05_pred_final.png", "05_pred_final_gray.png",
                  "06_gt.png", "aff.npy", "gamma.npy", "guidance.npy", "offset.npy", "pred.npy"]
    assert files["port_test"] == [f"epoch0000/{i:08d}/{f}" for i in range(2) for f in per_sample]
    for f in files["port_test"]:
        a, b = tmp_path / "port_test" / "test" / f, tmp_path / "jax_test" / "test" / f
        if f.endswith(".npy"):
            ours, ref = np.load(a), np.load(b)
            assert ours.shape == ref.shape, f
            assert np.abs(ours - ref).max() <= TOL * max(np.abs(ref).max(), 1e-6), f
        else:
            ours, ref = _png(a), _png(b)
            assert ours.shape == ref.shape and ours.dtype == ref.dtype, f
            off = np.any(ours != ref, axis=-1) if ours.ndim == 3 else ours != ref
            assert off.mean() <= 0.01, (f, off.mean())
    offset = np.load(tmp_path / "port_test" / "test" / "epoch0000" / "00000000" / "offset.npy")
    assert np.abs(offset).max() > 1.0  # the propagation reads beyond the neighbours
