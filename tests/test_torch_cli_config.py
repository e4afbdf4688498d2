"""The port's configuration and command line against the JAX package's:
the same ``Config`` fields and defaults, the same flags parsing to the same
values, the same ``args.json``; a ``--mesh_shape`` over more devices than
it is given raises, and so does a 'model' axis. Exact comparisons: no
arithmetic is involved."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from diffusiondepth_tpu import config as jconfig
from diffusiondepth_tpu_torch import config as pconfig

README_TRAIN = ("--dir_data /data/kitti_depth --data_name KITTIDC --split_json "
                "data_json/kitti_dc.json --patch_height 352 --patch_width 906 --top_crop 100 "
                "--model_name Diffusion_DCbase_ --backbone_module swin --backbone_name "
                "swin_large_naive_l4w722422k --head_specify DDIMDepthEstimate_Swin_ADDHAHI "
                "--loss 1.0*L1+1.0*L2+1.0*DDIM --opt_level O1 --batch_size 8")
README_TEST = "--test_only --pretrain exp/model_00030.ckpt --save_image --save_result_only"
ARGVS = {
    "defaults": [],
    "readme_train": README_TRAIN.split(),
    "readme_test": (README_TRAIN + " " + README_TEST).split(),
    "no_augment": ["--no_augment", "--num_sample", "500", "--no_warm_up", "--no_conf"],
    "extensions": ["--accum_steps", "2", "--test_batch_size", "8", "--tta_flip", "--use_pallas",
                   "--no_fused_window_attention", "--no_remat_backbone", "--no_fused_denoiser",
                   "--head_in_channels", "96,192,384,768", "--dtype", "float32",
                   "--mesh_shape", "data:1", "--profile_dir", "prof", "--ip_basic"],
}


@pytest.fixture
def fixed_clock(monkeypatch):
    """One timestamp for both packages' default ``save_dir``."""
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "261017_080000_")


def test_same_fields_and_defaults():
    jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pconfig.Config)]
    assert len(jf) == 74 and pf == jf


def test_same_choices():
    for name in ("MODEL_CHOICES", "BACKBONE_MODULE_CHOICES", "BACKBONE_NAME_CHOICES",
                 "HEAD_CHOICES"):
        assert getattr(pconfig, name) == getattr(jconfig, name), name


def test_same_flags():
    def flags(parser):
        return sorted((tuple(a.option_strings), a.dest, a.default, a.type and a.type.__name__,
                       tuple(a.choices or ())) for a in parser._actions)

    assert flags(pconfig.build_parser()) == flags(jconfig.build_parser())


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_args_matches_jax(fixed_clock, name):
    """Every field of ``to_dict()`` is equal, the finalized ones too."""
    argv = ARGVS[name]
    assert pconfig.parse_args(argv).to_dict() == jconfig.parse_args(argv).to_dict()


def test_augment_flags():
    """``--augment`` is the reference's ``type=bool`` flag (any non-empty
    value is true) beside ``--no_augment``, as in JAX."""
    for argv in (["--augment", "False"], ["--augment", ""], ["--no_augment"]):
        assert pconfig.parse_args(argv).augment == jconfig.parse_args(argv).augment
    assert pconfig.parse_args(["--augment", "False"]).augment is True
    assert pconfig.parse_args(["--no_augment"]).augment is False


@pytest.mark.parametrize("name", ["defaults", "readme_train", "extensions"])
def test_round_trip_and_args_json(tmp_path, fixed_clock, name):
    """``from_dict(to_dict())`` gives the same config, and both packages
    write the same ``args.json``."""
    cfg = pconfig.parse_args(ARGVS[name])
    assert pconfig.Config.from_dict(cfg.to_dict()) == cfg
    assert pconfig.Config.load_json(_saved(cfg, tmp_path / "p.json")) == cfg
    jcfg = jconfig.parse_args(ARGVS[name])
    assert (tmp_path / "p.json").read_text() == Path(_saved(jcfg, tmp_path / "j.json")).read_text()
    # a JAX args.json loads into the port's Config
    assert pconfig.Config.load_json(str(tmp_path / "j.json")).to_dict() == jcfg.to_dict()


def _saved(cfg, path):
    cfg.save_json(str(path))
    return str(path)


def test_args_json_is_json():
    d = json.loads(json.dumps(pconfig.Config().finalize().to_dict(), default=str))
    assert d["betas"] == [0.9, 0.999] and d["mesh_shape"] is None


@pytest.mark.parametrize("spec", ["data:2", "data:4,model:2", "model:2"])
def test_mesh_over_one_device_raises(spec):
    """A 'data' mesh parses, and ``create_mesh`` raises when it asks for
    more devices than it is given, as JAX's ``parse_mesh_shape`` does; a
    'model' axis of more than one device raises at the command line,
    naming the tensor-parallel slice, instead of being ignored."""
    from diffusiondepth_tpu_torch.parallel import create_mesh

    if "model" in spec:
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            pconfig.parse_args(["--mesh_shape", spec])
    else:
        assert pconfig.parse_args(["--mesh_shape", spec]).mesh_shape == spec
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            create_mesh(spec, [torch.device("cpu")])
    assert pconfig.parse_args(["--mesh_shape", "data:1"]).mesh_shape == "data:1"


def test_compute_dtype_is_torch():
    import torch

    assert pconfig.parse_args(["--opt_level", "O1"]).compute_dtype == torch.bfloat16
    assert pconfig.parse_args([]).compute_dtype == torch.float32
