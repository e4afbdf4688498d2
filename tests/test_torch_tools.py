"""The port's evaluation and accounting tools against the JAX package's, on
the CPU: ``eval_parity`` (aggregation, verdict, reference loader, CLI),
``flops`` (the committed table), ``analyze_trace`` (a CPU trace of
``main --profile_dir`` and a synthetic device trace) and ``prepare_kitti``."""

import filecmp
import json
import os
import types

import pytest

jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusiondepth_tpu.tools import eval_parity as jparity  # noqa: E402
from diffusiondepth_tpu.tools.prepare_kitti import reorganize as jreorganize  # noqa: E402
from diffusiondepth_tpu_torch import main as pmain  # noqa: E402
from diffusiondepth_tpu_torch.config import parse_args  # noqa: E402
from diffusiondepth_tpu_torch.metrics import METRIC_NAMES  # noqa: E402
from diffusiondepth_tpu_torch.tools import analyze_trace, eval_parity, flops  # noqa: E402
from diffusiondepth_tpu_torch.tools.prepare_kitti import reorganize  # noqa: E402

torch.set_num_threads(1)


def _jax_report(monkeypatch, rows, reference, rtol):
    """JAX's ``run_parity_eval`` with its model and data stubbed so that
    seed s, batch i yields the metric row ``rows[s][i]``: its aggregation
    and verdict on given rows."""
    n_seeds, n_batches = len(rows), len(rows[0])
    it = iter([r for seed in rows for r in seed])

    class _DS:
        def __init__(self, cfg, mode):
            pass

        def __len__(self):
            return n_batches

    batches = [{"rgb": np.zeros((1, 2, 2, 3), np.float32)}] * n_batches
    stubs = {"create_mesh": lambda spec: None, "get_data": lambda cfg: _DS,
             "DataLoader": lambda *a, **k: batches, "build_model": lambda cfg: None,
             "make_optimizer": lambda *a, **k: None, "create_train_state": lambda *a: None,
             "shard_batch": lambda b, m: b,
             "make_eval_step": lambda *a, **k: (lambda s, b, r: (None, next(it)[None], None))}
    for k, v in stubs.items():
        monkeypatch.setattr(jparity, k, v)
    cfg = types.SimpleNamespace(mesh_shape=None, test_batch_size=1, seed=0, pretrain=None,
                                tta_flip=False, inference_steps=20)
    return jparity.run_parity_eval(cfg, n_seeds, reference, rtol)


def _rows(n_seeds=3, n_batches=4):
    rng = np.random.RandomState(0)
    return [[(1 + 0.01 * rng.rand(8)).astype(np.float32) for _ in range(n_batches)]
            for _ in range(n_seeds)]


@pytest.mark.parametrize("verdict", ["passing", "failing"])
def test_parity_report_matches_jax(monkeypatch, verdict):
    """Mean, std, min, max, deviation and verdict equal JAX's on the same
    per-seed rows; the failing case moves RMSE's reference 5% off, beyond
    max(|ref| rtol, 2 std), and the verdict turns false."""
    rows = _rows()
    per_seed = np.stack([np.stack(seed).mean(0) for seed in rows])
    ref = {n: float(v) for n, v in zip(METRIC_NAMES, per_seed.mean(0))}
    if verdict == "failing":
        ref["RMSE"] *= 1.05
    want = _jax_report(monkeypatch, rows, ref, 0.01)
    got = eval_parity.parity_report(per_seed, want["protocol"], ref, 0.01)
    assert got["metrics"] == want["metrics"]
    assert got["parity"] == want["parity"] == (verdict == "passing")
    assert got["metrics"]["RMSE"]["within_tolerance"] == (verdict == "passing")


def test_reference_metrics_loader_matches_jax(tmp_path):
    path = tmp_path / "ref.json"
    path.write_text(json.dumps({"kitti": {"swin": {"RMSE": 0.98, "MAE": 0.2, "notes": "x"}}}))
    spec = f"{path}#kitti.swin"
    assert eval_parity._load_reference_metrics(spec) == \
        jparity._load_reference_metrics(spec) == {"RMSE": 0.98, "MAE": 0.2}


def test_eval_parity_cli_writes_report(tmp_path):
    """Two latent seeds over the Synthetic test split (16 frames, batch 8)
    on the CPU: finite statistics, seeds that differ, and the report file."""
    out = tmp_path / "report.json"
    report = eval_parity.main([
        "--data_name", "Synthetic", "--model_name", "Diffusion_DCbase_",
        "--backbone_module", "mmbev_resnet", "--backbone_name", "mmbev_res18",
        "--head_specify", "DDIMDepthEstimate_Res", "--patch_height", "32", "--patch_width", "48",
        "--test_batch_size", "8", "--inference_steps", "2", "--parity_seeds", "2",
        "--parity_out", str(out), "--device", "cpu"])
    assert report["protocol"]["n_seeds"] == 2 and report["protocol"]["num_samples"] == 16
    assert set(report["metrics"]) == set(METRIC_NAMES)
    for m in report["metrics"].values():
        assert np.isfinite(m["mean"]) and m["min"] <= m["mean"] <= m["max"] and m["std"] >= 0
    assert any(m["max"] > m["min"] for m in report["metrics"].values())
    assert json.loads(out.read_text()) == report


def test_flops_recomputes_committed_res50_entry():
    spec = flops.BENCH_SPECS[3]
    assert spec[1] == "mmbev_res50"
    committed = flops.lookup(*spec[1:7])
    assert committed is not None and flops.entry(spec) == committed
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12


def test_analyze_trace_of_main_profile_on_cpu(tmp_path):
    """main --profile_dir on the CPU (12 steps: the window opens at step
    10) writes trace.json; with no kernel events the summary is of its host
    operators, with the trace's own totals and counts."""
    cfg = parse_args(["--data_name", "Synthetic", "--model_name", "Diffusion_DCbase_",
                      "--backbone_module", "mmbev_resnet", "--backbone_name", "mmbev_res18",
                      "--inference_steps", "1", "--patch_height", "32", "--patch_width", "32",
                      "--batch_size", "5", "--test_batch_size", "16", "--epochs", "1",
                      "--log_every", "100", "--profile_dir", str(tmp_path / "prof")])
    cfg.save_dir = str(tmp_path / "run")
    pmain.train(cfg, device="cpu")
    path = analyze_trace.find_trace_file(str(tmp_path / "prof"))
    assert path.endswith("trace.json")
    events = json.loads(open(path).read())["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops and not any(e.get("cat") == "kernel" for e in events)
    total, dur, cnt = analyze_trace.breakdown(analyze_trace.load_events(path), "cpu_op")
    assert total == sum(float(e["dur"]) for e in ops) and sum(cnt.values()) == len(ops)
    text = analyze_trace.summarize(path, top=5)
    assert f"host operators: {total / 1000:.3f} ms in {len(ops)} calls" in text
    top = max(dur, key=dur.get)
    assert f"n={cnt[top]:6d}  {top[:100]}" in text


def test_analyze_trace_of_a_device_trace(tmp_path):
    """A Chrome trace with kernel events (as torch.profiler writes on the
    card): the device total, each kernel's time and count, and the
    categories with trailing indices stripped, exactly."""
    ev = [{"ph": "X", "cat": "kernel", "name": n, "dur": d, "pid": 0, "tid": 7, "ts": i}
          for i, (n, d) in enumerate([("conv_link_kernel", 10.0), ("conv_link_kernel", 12.5),
                                      ("ddim_step_kernel", 3.0), ("gemm_1", 4.0),
                                      ("gemm_2", 6.0)])]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99.0, "pid": 1, "tid": 1,
            "ts": 0}, {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 2.0,
                       "pid": 0, "tid": 7, "ts": 9},
           {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    total, dur, cnt = analyze_trace.breakdown(analyze_trace.load_events(str(path)), "kernel")
    assert total == 35.5 and cnt == {"conv_link_kernel": 2, "ddim_step_kernel": 1,
                                     "gemm_1": 1, "gemm_2": 1}
    text = analyze_trace.summarize(analyze_trace.find_trace_file(str(tmp_path)))
    lines = text.splitlines()
    assert "device (kernel) time: 0.035 ms in 5 kernels" in text
    assert "memcpy: 0.002 ms in 1 copies" in text
    assert lines[4] == f"{0.0225:10.3f} ms  n=     2  conv_link_kernel"
    assert f"{0.010:10.3f} ms  gemm_" in lines[lines.index("-- categories --") + 2]


def _kitti_raw(root):
    seq = "2011_09_26_drive_0001_sync"
    for sub in ("image_02", "image_03", "oxts"):
        d = root / "raw" / "2011_09_26" / seq / sub
        d.mkdir(parents=True)
        (d / "0000.png").write_bytes(bytes(range(37)))
    for calib in ("calib_cam_to_cam.txt", "calib_imu_to_velo.txt", "calib_velo_to_cam.txt"):
        (root / "raw" / "2011_09_26" / calib).write_text(calib + "\n")
    for split in ("train", "val"):
        (root / "dc" / split).mkdir(parents=True)
    (root / "dc" / "train" / seq).mkdir()
    (root / "dc" / "val" / seq).mkdir()
    (root / "dc" / "val" / seq / "image_02").mkdir()  # already there: kept as it is


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files + [""])


def test_prepare_kitti_matches_jax(tmp_path):
    """The same raw and depth-completion trees reorganised by the port and
    by JAX's ``reorganize``: the same files, byte for byte."""
    for side in ("port", "jax"):
        _kitti_raw(tmp_path / side)
    reorganize(str(tmp_path / "port" / "dc"), str(tmp_path / "port" / "raw"))
    jreorganize(str(tmp_path / "jax" / "dc"), str(tmp_path / "jax" / "raw"))
    a, b = tmp_path / "port" / "dc", tmp_path / "jax" / "dc"
    assert _tree(a) == _tree(b) and len(_tree(a)) > 8
    for rel in _tree(a):
        if os.path.isfile(a / rel):
            assert filecmp.cmp(a / rel, b / rel, shallow=False), rel
