"""``main`` at ``--mesh_shape data:2`` on the CPU against the one-process
run: Synthetic data, ``mmbev_res18`` + ``DDIMDepthEstimate_Res`` at 32x48,
2 DDIM steps, one step per epoch (a batch of 64: all of Synthetic's train
split, 32 rows per rank) for 2 epochs, a val and a test pass per epoch
(16 frames at batch 8), then ``--resume`` from the first epoch's
checkpoint, two ranks against one process. Each run is a subprocess with
its own time limit; ``main`` spawns the ranks itself (gloo, one torch
thread each).

* Only rank 0 writes: the two runs leave the same files, with as many
  lines in each log and one event file per split; the panels have the
  one-process run's shapes (the host batch is gathered for them).
* The first step's loss and metric rows (epoch 1's train logs, full
  precision in ``scalars_train.jsonl``) agree to 1e-5, as do the first
  steps after the two resumes from the same checkpoint: the ranks start
  from the same weights and draw the same numbers.
* The later rows (epoch 1's val and test, epoch 2) follow one update of
  SGD (momentum 0.9, lr 0.002; linear in a gradient that agrees to ~1e-5 of
  each leaf) and agree to 1e-4 relative, 1e-6 absolute: the change in the
  weights carries the gradient's reordering error through another forward.
* The threshold metrics D^1-D^3 count pixels: a pixel at a threshold that
  flips moves them by one over the valid pixels, so they are also allowed
  3 pixels of an eval batch (3 / (8 x 32 x 48)).
* ``--mesh_shape data:1,model:2`` runs two ranks as JAX's ``main`` runs a
  'model' axis: the batch over 'data' alone, the state replicated (no
  ``state_sharding``); the logs and the final checkpoint are the
  one-process run's, bit for bit.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FLAGS = ["--data_name", "Synthetic", "--model_name", "Diffusion_DCbase_",
         "--backbone_module", "mmbev_resnet", "--backbone_name", "mmbev_res18",
         "--head_specify", "DDIMDepthEstimate_Res", "--inference_steps", "2",
         "--patch_height", "32", "--patch_width", "48", "--max_depth", "10",
         "--batch_size", "64", "--test_batch_size", "8", "--epochs", "2", "--num_threads", "1",
         "--log_every", "1", "--optimizer", "SGD", "--lr", "0.002", "--save_full"]
RUN = """
import sys
sys.path.insert(0, sys.argv[1])
from diffusiondepth_tpu_torch import main
from diffusiondepth_tpu_torch.config import parse_args
if __name__ == "__main__":
    cfg = parse_args(sys.argv[3:])
    cfg.save_dir = sys.argv[2]
    main.main(cfg, device="cpu")
"""
FIRST, LATER = 1e-5, 1e-4
D_ATOL = 3 / (8 * 32 * 48)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def _main(save_dir, *argv):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    script = save_dir.parent / "run_main.py"
    script.write_text(RUN)
    proc = subprocess.run([sys.executable, str(script), str(REPO), str(save_dir), *FLAGS,
                           "--port", _free_port(), *argv],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("main_dp")
    out = {"one": _main(root / "one"), "two": _main(root / "two", "--mesh_shape", "data:2"),
           "model": _main(root / "model", "--mesh_shape", "data:1,model:2")}
    ckpt = str(root / "two" / "model_00001.ckpt")
    out["one_resume"] = _main(root / "one_resume", "--resume", "--pretrain", ckpt)
    out["two_resume"] = _main(root / "two_resume", "--resume", "--pretrain", ckpt,
                              "--mesh_shape", "data:2")
    return root, out


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*")
                  if "code" not in p.relative_to(d).parts and p.name != "args.json"
                  and not p.name.startswith("events.out"))


def _scalars(d, mode):
    """{(step, tag): value} of a split's scalar log."""
    rows = [json.loads(line) for line in (d / f"scalars_{mode}.jsonl").read_text().splitlines()]
    return {(r["step"], r["tag"]): r["value"] for r in rows}


def test_only_rank_0_writes(runs):
    from diffusiondepth_tpu_torch.native.png import read_png

    root, out = runs
    one, two = root / "one", root / "two"
    assert _files(one) == _files(two)
    for name in ("loss_train.txt", "metric_train.txt", "metric_val.txt", "metric_test.txt",
                 "scalars_train.jsonl", "scalars_val.jsonl", "scalars_test.jsonl"):
        assert (len((one / name).read_text().splitlines())
                == len((two / name).read_text().splitlines())), name
    for mode in ("train", "val", "test"):
        assert len([p for p in (two / mode).iterdir() if p.name.startswith("events.out")]) == 1
    for mode in ("val", "test"):
        for step in (1, 2):
            png = f"{mode}/images/step_{step:06d}.png"
            assert read_png(str(two / png)).shape == read_png(str(one / png)).shape
    assert (two / "code").is_dir()
    assert "mesh: {'data': 2}" in out["two"] and out["two"].count("saved ") == 2
    import torch

    ckpt = torch.load(two / "model_00002.ckpt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["opt_state"]["count"] == 2


def _close(a, b, rtol, atol=0.0):
    assert a.keys() == b.keys()
    for k in a:
        tol = atol + rtol * abs(b[k]) + (D_ATOL if k[1].startswith("Metric/D^") else 0.0)
        assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])


def test_logs_match_the_one_process_run(runs):
    root, _ = runs
    one, two = _scalars(root / "one", "train"), _scalars(root / "two", "train")
    first = {k: v for k, v in two.items() if k[0] == 1}
    _close(first, {k: v for k, v in one.items() if k[0] == 1}, FIRST)
    _close(two, one, LATER, 1e-6)
    for mode in ("val", "test"):
        _close(_scalars(root / "two", mode), _scalars(root / "one", mode), LATER, 1e-6)


def test_resume_matches_the_one_process_resume(runs):
    """Both resume at epoch 2 from the data:2 run's first checkpoint (every
    rank restores it), with the optimizer's momentum and count."""
    root, out = runs
    one, two = root / "one_resume", root / "two_resume"
    assert [line.split(" |")[0] for line in (two / "loss_train.txt").read_text().splitlines()] \
        == ["0002"]
    assert sorted(p.name for p in two.glob("*.ckpt")) == ["model_00002.ckpt"]
    _close(_scalars(two, "train"), _scalars(one, "train"), FIRST)
    for mode in ("val", "test"):
        _close(_scalars(two, mode), _scalars(one, mode), LATER, 1e-6)
    assert "loaded checkpoint" in out["two_resume"]


def test_model_axis_is_the_one_process_run(runs):
    """data:1,model:2: the model ranks repeat one process's work on the
    same batch; rank 0 writes that run's logs and checkpoints."""
    import torch

    root, out = runs
    one, model = root / "one", root / "model"
    assert "mesh: {'data': 1, 'model': 2}" in out["model"]
    assert _files(model) == _files(one)
    for name in ("loss_train.txt", "metric_train.txt", "metric_val.txt", "metric_test.txt",
                 "scalars_train.jsonl", "scalars_val.jsonl", "scalars_test.jsonl"):
        assert (model / name).read_text() == (one / name).read_text(), name
    ck = [torch.load(d / "model_00002.ckpt", weights_only=True) for d in (one, model)]
    assert ck[0]["state_dict"].keys() == ck[1]["state_dict"].keys()
    assert all(torch.equal(ck[0]["state_dict"][k], ck[1]["state_dict"][k])
               for k in ck[0]["state_dict"])
    st = [c["opt_state"]["optimizer"]["state"] for c in ck]
    assert all(torch.equal(st[0][i][k], st[1][i][k]) for i in st[0] for k in st[0][i])
