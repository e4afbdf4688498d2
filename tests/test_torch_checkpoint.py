"""The port's checkpoints: save -> load is bit-exact for the weights, the
BatchNorm buffers, the optimizer's state and count, the step and the
epoch; the args file and the resume rule match the JAX package's; the
source backup leaves the build outputs out."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from diffusiondepth_tpu import config as jconfig
from diffusiondepth_tpu.utils.checkpoint import apply_checkpoint_args as j_apply
from diffusiondepth_tpu_torch import LossComputer, build_model, make_train_step
from diffusiondepth_tpu_torch.config import Config
from diffusiondepth_tpu_torch.training.train_state import create_train_state
from diffusiondepth_tpu_torch.utils.checkpoint import (
    apply_checkpoint_args, load_checkpoint, load_checkpoint_args, restore_state, save_checkpoint,
)
from diffusiondepth_tpu_torch.utils.misc import backup_source_code

torch.set_num_threads(1)


def _cfg(**kw):
    return Config(model_name="Diffusion_DCbase_", backbone_module="mmbev_resnet",
                  backbone_name="mmbev_res18", inference_steps=1, batch_size=2,
                  patch_height=32, patch_width=32, **kw).finalize()


def _trained_state(cfg, steps=2):
    state = create_train_state(build_model(cfg, device="cpu"), cfg, 10)
    step = make_train_step(state.model, LossComputer(cfg), state.optimizer)
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        step({"rgb": torch.randn(2, 32, 32, 3, generator=g),
              "gt": torch.rand(2, 32, 32, 1, generator=g) * 9 + 1}, g)
    return state


@pytest.fixture(scope="module")
def trained():
    cfg = _cfg(optimizer="ADAM")
    return cfg, _trained_state(cfg)


def _equal_state_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_full_round_trip_is_bit_exact(tmp_path, trained):
    cfg, state = trained
    path = save_checkpoint(str(tmp_path), 3, state, cfg, save_full=True)
    assert os.path.basename(path) == "model_00003.ckpt"
    payload = load_checkpoint(path)
    assert payload["epoch"] == 3 and payload["step"] == 2
    assert payload["args"].to_dict() == cfg.to_dict()

    fresh = create_train_state(build_model(_cfg(optimizer="ADAM", seed=1), device="cpu"), cfg, 10)
    restore_state(fresh, payload)
    _equal_state_dicts(fresh.model.state_dict(), state.model.state_dict())
    buffers = [k for k in state.model.state_dict() if k.endswith(("running_mean", "running_var",
                                                                  "num_batches_tracked"))]
    assert buffers  # the BatchNorm statistics are in the file
    assert fresh.optimizer.count == state.optimizer.count == 2 and fresh.step == 2
    params = dict(state.model.named_parameters())
    fresh_params = dict(fresh.model.named_parameters())
    n_moments = 0
    for name, p in params.items():
        st, fst = state.optimizer.state[p], fresh.optimizer.state[fresh_params[name]]
        assert st.keys() == fst.keys()
        for k in st:
            assert torch.equal(st[k], fst[k]), (name, k)
            n_moments += 1
    assert n_moments == 2 * len(params)  # Adam's mu and nu of every parameter


def test_round_trip_continues_training_identically(tmp_path):
    """A restored full checkpoint takes the same next step as the state it
    was saved from."""
    cfg = _cfg(optimizer="ADAM")
    a = _trained_state(cfg, steps=1)
    b = create_train_state(build_model(_cfg(optimizer="ADAM", seed=5), device="cpu"), cfg, 10)
    restore_state(b, load_checkpoint(save_checkpoint(str(tmp_path), 1, a, cfg, save_full=True)))
    batch = {"rgb": torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(9)),
             "gt": torch.full((2, 32, 32, 1), 4.0)}
    for s in (a, b):
        make_train_step(s.model, LossComputer(cfg), s.optimizer)(
            batch, torch.Generator().manual_seed(3))
    _equal_state_dicts(a.model.state_dict(), b.model.state_dict())
    assert a.step == b.step == 2


def test_weights_only_checkpoint_keeps_the_step(tmp_path, trained):
    """Without ``save_full`` the file has no optimizer state: the restored
    optimizer starts afresh (its count and schedule at 0) while the step is
    the saved one, as JAX restores ``step`` without ``opt_state``."""
    cfg, state = trained
    payload = load_checkpoint(save_checkpoint(str(tmp_path), 1, state, cfg))
    assert "opt_state" not in payload
    fresh = create_train_state(build_model(cfg, device="cpu"), cfg, 10)
    restore_state(fresh, payload)
    _equal_state_dicts(fresh.model.state_dict(), state.model.state_dict())
    assert fresh.optimizer.count == 0 and fresh.step == 2 and not fresh.optimizer.state


def test_args_json_matches_jax(tmp_path, trained):
    cfg, state = trained
    save_checkpoint(str(tmp_path), 1, state, cfg)
    saved = json.loads((tmp_path / "model_00001.args.json").read_text())
    jcfg = jconfig.Config.from_dict(saved)
    assert saved == json.loads(json.dumps(jcfg.to_dict(), default=str))
    assert load_checkpoint_args(str(tmp_path / "model_00001.ckpt")) == cfg
    assert load_checkpoint_args(str(tmp_path / "model_00009.ckpt")) is None


def test_apply_checkpoint_args_keeps_the_jax_fields():
    """Resume takes the args from the checkpoint but test_only, pretrain,
    dir_data, resume, save_dir and (with force_maxdepth) max_depth from
    the command line, in both packages."""
    ckpt = dict(epochs=7, lr=3e-4, batch_size=4, dir_data="/old", max_depth=80.0,
                save_dir="/old/run", backbone_name="mmbev_res50", test_only=False)
    cli = dict(epochs=2, lr=1e-3, batch_size=8, dir_data="/new", max_depth=90.0,
               save_dir="/new/run", pretrain="/new/m.ckpt", resume=True, test_only=True)
    for force in (False, True):
        ours = apply_checkpoint_args(Config(**ckpt).finalize(),
                                     Config(**cli, force_maxdepth=force).finalize())
        ref = j_apply(jconfig.Config(**ckpt).finalize(),
                      jconfig.Config(**cli, force_maxdepth=force).finalize())
        assert ours.to_dict() == ref.to_dict()
        assert (ours.epochs, ours.dir_data, ours.max_depth) == (7, "/new", 90.0 if force else 80.0)


def test_backup_leaves_out_build_outputs(tmp_path):
    backup_source_code(str(tmp_path / "code"))
    files = {os.path.relpath(os.path.join(r, f), tmp_path / "code")
             for r, _, fs in os.walk(tmp_path / "code") for f in fs}
    assert "main.py" in files and "native/depthops.cpp" in files and "csrc/conv_link.cu" in files
    assert not any(f.startswith("_build") or "__pycache__" in f for f in files)
    assert np.all([not f.endswith(".so") for f in files])


def test_restore_rejects_another_model(tmp_path, trained):
    cfg, state = trained
    payload = load_checkpoint(save_checkpoint(str(tmp_path), 1, state, cfg))
    other = dataclasses.replace(cfg, backbone_name="mmbev_res50")
    with pytest.raises(RuntimeError):
        restore_state(create_train_state(build_model(other, device="cpu"), other, 10), payload)
