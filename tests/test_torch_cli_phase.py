"""A rehearsal on the CPU of phase 11 (``cli``) of ``chip_smoke.py``, at a
small size: the KITTI-DC tree writer, main's training run, the loader on
its own, ``--test_only`` with its bit-equal reload and submission PNGs,
and ``--resume``, with every check of the phase (the launch counts are 0:
the CPU runs the plain versions)."""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
import diffusiondepth_tpu_torch as port  # noqa: E402

torch.set_num_threads(2)

MICRO = ["--model_name", "Diffusion_DCbase_", "--backbone_module", "swin",
         "--backbone_name", "swin_micro", "--head_specify", "DDIMDepthEstimate_Swin_ADDHAHI",
         "--head_in_channels", "32,64,128,256", "--inference_steps", "2", "--opt_level", "O1",
         "--patch_height", "64", "--patch_width", "96", "--top_crop", "4"]
TREE = {"train": (16, 75, 124), "val": (8, 75, 124), "test": (8, 64, 128)}


def test_cli_phase_runs_on_the_cpu(capsys):
    launches = chip_smoke.cli_phase(port, torch, torch.device("cpu"), {}, {}, flags=MICRO,
                                    tree=TREE)
    assert launches == {k: 0 for k in port.LAUNCHES}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"phase": "cli"')]
    assert [line.get("run") for line in lines] == ["train", "loader", "test_only", "resume",
                                                  None]
    train, _, test_only, resume, _ = lines
    assert len(train["step_ms"]) == 2 and len(train["loader_wait_share"]) == 2
    assert test_only["reload_bit_equal"] and test_only["submission_pngs"] == 8
    assert resume["epochs_logged"] == ["0002"] and resume["optimizer_count"] == 4


NLSPN_MICRO = ["--model_name", "NLSPN", "--network", "resnet18", "--prop_time", "2",
               "--patch_height", "64", "--patch_width", "96", "--top_crop", "4",
               "--loss", "1.0*L1+1.0*L2"]


def test_cli_phase_runs_nlspn_on_the_cpu(capsys):
    """Phase 15 (``cli-nlspn``) at the micro size: NLSPN through main's
    training run (with its gamma scalar and 5-column panels checked),
    --test_only and --resume, no kernel launched."""
    launches = chip_smoke.cli_phase(port, torch, torch.device("cpu"), {}, {}, flags=NLSPN_MICRO,
                                    tree=TREE, phase="cli-nlspn")
    assert launches == {k: 0 for k in port.LAUNCHES}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"phase": "cli-nlspn"')]
    assert [line.get("run") for line in lines] == ["train", "loader", "test_only", "resume",
                                                  None]
    assert lines[2]["reload_bit_equal"] and lines[3]["optimizer_count"] == 4


NYU_MICRO = ["--model_name", "NLSPN", "--network", "resnet18", "--prop_time", "2",
             "--max_depth", "10", "--num_sample", "100", "--loss", "1.0*L1+1.0*L2"]
NYU_TREE = {"train": 4, "test": 1}


def test_nyu_tree_writer_and_split(tmp_path):
    """Phase 16's tree at a few frames: the port's HDF5 files read back by
    h5py as written, and the split of the port's generate_json equal to
    the JAX package's on the same csv and directory."""
    import h5py
    import numpy as np

    from diffusiondepth_tpu.tools.generate_json import generate_nyu_json
    from diffusiondepth_tpu_torch.native.hdf5 import read_datasets

    split = chip_smoke.write_nyu_tree(str(tmp_path), {"train": 8, "test": 2}, (30, 40))
    assert [len(split[m]) for m in ("train", "val", "test")] == [6, 2, 2]
    assert split["test"][0]["filename"] == "val/official/00000.h5"
    assert json.loads((tmp_path / "split.json").read_text()) == split
    assert split == generate_nyu_json(str(tmp_path), str(tmp_path / "nyudepth_hdf5_train.csv"),
                                      str(tmp_path / "nyudepth_hdf5_val.csv"),
                                      val_ratio=chip_smoke.NYU_VAL_RATIO)
    for entry in split["train"] + split["val"] + split["test"]:
        path = tmp_path / entry["filename"]
        ours = read_datasets(str(path), ("rgb", "depth"))
        with h5py.File(path, "r") as f:
            for k in ("rgb", "depth"):
                assert f[k].dtype == ours[k].dtype and np.array_equal(f[k][:], ours[k])
        assert ours["rgb"].shape == (3, 30, 40) and ours["depth"].shape == (30, 40)
        d = ours["depth"]
        assert 0.1 < (d == 0).mean() < 0.3 and d.max() <= 10.0 and d[d > 0].min() >= 0.5


def test_cli_nyu_phase_runs_on_the_cpu(capsys):
    """Phase 16 (``cli-nyu``) at a micro size: NLSPN resnet18 through
    main's training run on an NYU tree (3 steps of 1), --test_only, the val
    split under --ip_basic and the loader alone, no kernel launched."""
    launches = chip_smoke.cli_nyu_phase(port, torch, torch.device("cpu"), flags=NYU_MICRO,
                                        tree=NYU_TREE, hw=(30, 40), batch=1)
    assert launches == {k: 0 for k in port.LAUNCHES}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"phase": "cli-nyu"')]
    assert [line.get("run") for line in lines] == ["train", "loader", "test_only",
                                                  "val_ip_basic", None]
    train = lines[0]
    assert len(train["step_ms"]) == 3 and len(train["loader_wait_share"]) == 3
    assert train["split"] == {"train": 3, "val": 1, "test": 1}
    assert lines[2]["reload_bit_equal"] and len(lines[3]["metric_rows"]) == 1


def test_cli_phase_runs_x4_on_the_cpu(capsys):
    """Phase 11 at the micro size with --model_name Diffusion_DCx4base_ (the
    README's X4 command; a 96-pixel crop, 96 % 4 == 0): main's training
    run, --test_only with its bit-equal reload and submission PNGs, and
    --resume, no kernel launched."""
    flags = [("Diffusion_DCx4base_" if f == "Diffusion_DCbase_" else f) for f in MICRO]
    launches = chip_smoke.cli_phase(port, torch, torch.device("cpu"), {}, {}, flags=flags,
                                    tree=TREE, phase="cli-x4")
    assert launches == {k: 0 for k in port.LAUNCHES}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"phase": "cli-x4"')]
    assert [line.get("run") for line in lines] == ["train", "loader", "test_only", "resume",
                                                  None]
    assert lines[2]["reload_bit_equal"] and lines[2]["submission_pngs"] == 8
