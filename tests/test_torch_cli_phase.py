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
