"""The port's ``main`` against the JAX package's ``main`` on NYUv2, the
command line's default dataset: NLSPN (resnet18, prop_time 2, the stencil
radius 6) on a small NYU tree written by h5py, train 1 epoch (one step of
2, with NYU's augmentation), val and test at the fixed 228x304 crop, then
``--test_only`` on the epoch's checkpoint, in f32.

Both runs start from the same weights, random and non-zero (the offset
conv's too, so that the propagation moves the depth; the initial-depth
head's bias at 5 m, inside NYU's 10 m range), written by JAX's
``save_checkpoint`` and lifted with ``jax_to_state_dict`` into a port
checkpoint. The two loaders hand both models the same samples
(``tests/test_torch_nyu.py``). JAX runs on one CPU device.

Tolerance 2e-3, as ``tests/test_torch_nlspn_main.py``: the logged losses
and metrics (4 decimals, so 2e-3 of each value plus 1e-4), the weights
and BatchNorm statistics after the SGD step, and the ``Etc/gamma``
scalar.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu import config as jconfig  # noqa: E402
from diffusiondepth_tpu import main as jmain  # noqa: E402
from diffusiondepth_tpu.models.nlspn import NLSPNModel as JNLSPN  # noqa: E402
from diffusiondepth_tpu.training.optim import make_optimizer as jmake_optimizer  # noqa: E402
from diffusiondepth_tpu.training.train_state import TrainState as JTrainState  # noqa: E402
from diffusiondepth_tpu.utils import checkpoint as jckpt  # noqa: E402
from diffusiondepth_tpu_torch import build_model, main as pmain  # noqa: E402
from diffusiondepth_tpu_torch.config import parse_args  # noqa: E402
from diffusiondepth_tpu_torch.training.train_state import create_train_state  # noqa: E402
from diffusiondepth_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from diffusiondepth_tpu_torch.utils.convert_jax_params import jax_to_state_dict  # noqa: E402

from test_torch_main import _logged  # noqa: E402
from test_torch_nlspn_main import one_device  # noqa: E402,F401  (the JAX-side fixture)
from test_torch_support import close_leaves, module_variables, named  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-3
FLAGS = ["--data_name", "NYU", "--model_name", "NLSPN", "--network", "resnet18",
         "--prop_time", "2", "--prop_stencil_radius", "6", "--loss", "1.0*L1+1.0*L2",
         "--max_depth", "10", "--num_sample", "100", "--batch_size", "2",
         "--test_batch_size", "2", "--epochs", "1", "--num_threads", "2", "--log_every", "1",
         "--optimizer", "SGD", "--lr", "0.0002"]


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    """2 train and 2 val frames of 60x80 under train/, 2 test frames under
    val/official, written by h5py; a split json."""
    root = tmp_path_factory.mktemp("nyu_main")
    rng = np.random.RandomState(0)
    names = [f"train/scene/{i:05d}.h5" for i in range(4)]
    names += [f"val/official/{i:05d}.h5" for i in range(2)]
    h, w = 60, 80
    ramp = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    for name in names:
        os.makedirs(root / os.path.dirname(name), exist_ok=True)
        rgb = 180 * ramp[None] * rng.rand(3, 1, 1) + 60 * rng.rand(3, h, w)
        depth = (1.0 + 7.0 * ramp + rng.rand(h, w)).astype(np.float32)
        depth[rng.rand(h, w) < 0.2] = 0.0
        with h5py.File(root / name, "w") as f:
            f.create_dataset("rgb", data=rgb.astype(np.uint8))
            f.create_dataset("depth", data=depth)
    split = {"train": [{"filename": n} for n in names[:2]],
             "val": [{"filename": n} for n in names[2:4]],
             "test": [{"filename": n} for n in names[4:]]}
    (root / "split.json").write_text(json.dumps(split))
    return root


@pytest.fixture(scope="module")
def start_ckpts(tmp_path_factory):
    """The JAX start state (random weights, the offset conv's scaled so that
    offsets reach a few pixels) by JAX's save_checkpoint, and the same
    state lifted into a port checkpoint."""
    d = tmp_path_factory.mktemp("nyu_start")
    jcfg = jconfig.parse_args(FLAGS)
    batch = {"rgb": np.zeros((1, 32, 64, 3), np.float32),
             "dep": np.ones((1, 32, 64, 1), np.float32)}
    variables = module_variables(JNLSPN(args=jcfg), batch, seed=5, train=False)
    prop = variables["params"]["prop_layer"]
    prop["conv_offset_aff"]["kernel"][..., :16] *= 2.0
    prop["aff_scale_const"] = np.asarray([4.0], np.float32)
    # an initial depth of ~5 m: at random weights the depth sits near 0 and
    # the inverse metrics turn a 1e-6 difference in pred into percents
    variables["params"]["id_dec0"]["Conv_0"]["bias"][:] = 5.0
    tx = jmake_optimizer(jcfg, 1)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), tx=tx)
    jpath = jckpt.save_checkpoint(str(d / "jax"), 0, state, jcfg)
    payload = jckpt.load_checkpoint(jpath)
    pcfg = parse_args(FLAGS)
    model = build_model(pcfg, device="cpu")
    model.load_state_dict(jax_to_state_dict(payload["params"], payload["batch_stats"]),
                          strict=True)
    ppath = save_checkpoint(str(d / "port"), 0, create_train_state(model, pcfg, 1), pcfg)
    return jpath, ppath, variables


def _flags(root, extra=()):
    return FLAGS + ["--dir_data", str(root), "--split_json", str(root / "split.json"), *extra]


def _gamma(path):
    return [json.loads(line)["value"] for line in Path(path).read_text().splitlines()
            if json.loads(line)["tag"] == "Etc/gamma"]


def test_nyu_main_matches_jax(nyu_root, start_ckpts, one_device, tmp_path):  # noqa: F811
    jpath, ppath, start = start_ckpts
    jcfg = jconfig.parse_args(_flags(nyu_root, ["--pretrain", jpath]))
    jcfg.save_dir = str(tmp_path / "jax")
    pcfg = parse_args(_flags(nyu_root, ["--pretrain", ppath]))
    pcfg.save_dir = str(tmp_path / "port")
    jstate = jmain.train(jcfg)
    pstate = pmain.train(pcfg, device="cpu")
    assert int(jstate.step) == pstate.step == 1

    for name in ("loss_train.txt", "metric_train.txt", "metric_val.txt", "metric_test.txt"):
        ours, ref = _logged(tmp_path / "port" / name), _logged(tmp_path / "jax" / name)
        assert ours.shape == ref.shape and ours.shape[0] == 1, name
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=1e-4, err_msg=name)
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

    # --test_only on the epoch's checkpoint
    jcfg = jconfig.parse_args(_flags(nyu_root, ["--test_only", "--pretrain",
                                                str(tmp_path / "jax" / "model_00001.ckpt")]))
    jcfg.save_dir = str(tmp_path / "jax_test")
    pcfg = parse_args(_flags(nyu_root, ["--test_only", "--pretrain",
                                        str(tmp_path / "port" / "model_00001.ckpt")]))
    pcfg.save_dir = str(tmp_path / "port_test")
    jmain.test(jcfg)
    pmain.test(pcfg, device="cpu")
    ours = _logged(tmp_path / "port_test" / "metric_test.txt")
    np.testing.assert_allclose(ours, _logged(tmp_path / "jax_test" / "metric_test.txt"),
                               rtol=TOL, atol=1e-4)
    assert ours.shape == (1, 8) and np.isfinite(ours).all()
