"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration file (named there), its traffic mix
``traffic/<name>.json``, the driver of the mix's ``kind``,
``drivers/<kind>.py``, and each metric's reader ``metrics/<name>.py``, which
defines ``read(ctx)`` and returns a number or None (nothing to read: the
metric is left out of the line).

A driver module defines ``Driver(cell, seed, device, mark)``, whose
construction is the set-up (weights, the program, inputs, warm-up), with

* ``attach(spans)``: spans around calls into the program (``harness/spans.py``);
* ``window(seconds) -> dict``: the measured work; the dict has ``attempted``
  and ``window_s`` and goes into the readers' ``ctx``;
* ``unit()`` and ``trace_units``: one synchronised unit of work (a request,
  a step) and how many of them the traced slice runs;
* ``release()``: drops the program's state;
* ``readings() -> [dict]``: the check's numbers, one dict per checked item,
  each key held against the configuration's ``limits``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from . import check, program, trace as trace_mod
from .spans import Spans

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_cell(root: Path, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports at each ``--trace`` setting."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {"name": name, "chips": cell["chips"],
            "config": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer, "bench_dir": bench_dir}


def _load(path: Path, prefix: str):
    """The module of the file ``path``, loaded once per process."""
    name = f"{prefix}:{path.resolve()}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def load_driver(bench_dir: Path, kind: str):
    return _load(bench_dir / "drivers" / f"{kind}.py", "h100bench_driver")


def read_metrics(metrics, ctx: dict, bench_dir: Path) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = _load(bench_dir / "metrics" / f"{m['name']}.py", "h100bench_metric").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def peak_of(device, bench_dir: Path) -> Optional[dict]:
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device)
    for k, v in json.loads((bench_dir / "peaks.json").read_text()).items():
        if k.lower() in kind.lower():
            return v
    return None


def run(cell: dict, seed: int, seconds: float, traced: bool, device, t0: float,
        log=sys.stderr) -> dict:
    """One run; returns the result line's object (``checks`` last)."""
    config, traffic = cell["config"], cell["traffic"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def mark(what: str) -> None:
        print(f"h100bench: {what} at {time.perf_counter() - t0:.3f} s", file=log)

    mark("start of set-up")
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=device)
        mark("CUDA context made")
    driver = load_driver(cell["bench_dir"], traffic["kind"]).Driver(cell, seed, device, mark)
    spans = None
    if traced and on_card:
        spans = Spans()
        driver.attach(spans)
    sync()
    # set-up's objects out of the collector's way, so that no long collection
    # of them falls into the window
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    mark("warm-up done, window opens")

    window = driver.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = None
    if traced and on_card:
        summary = traced_slice(driver, window, log)
    ctx = {"kind": traffic["kind"], "setup_s": setup_s, **window, "config": config,
           "traffic": traffic, "peak": peak_of(device, cell["bench_dir"]),
           "spans": spans.all_ms() if spans else {}, "trace": summary}
    metrics = read_metrics(cell["per_layer"] if traced else cell["end_to_end"], ctx,
                           cell["bench_dir"])

    # the check, with the program's state freed; the reference runs in f32
    driver.release()
    del spans
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mark("metrics read")
    readings = driver.readings()
    print("h100bench: checked " + json.dumps(readings), file=log)
    checks, failed = check.judge(readings, config["limits"])
    mark(f"check of {len(readings)} items done")

    result = {"correct": failed == 0 and bool(readings), "attempted": window["attempted"],
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": memory_peak}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def traced_slice(driver, window: dict, log) -> dict:
    """``driver.trace_units`` units of work under ``torch.profiler``, after
    the window, with the device's activity alone traced (no host ops, whose
    recording would lengthen the host's share); the slice's bounds are the
    host clock's, between two synchronisations. The trace is written under
    TMPDIR, read and deleted."""
    from torch.profiler import ProfilerActivity, profile

    n = driver.trace_units
    program.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(n):
            driver.unit()
        torch.cuda.synchronize()
        slice_s = time.perf_counter() - w0
    launches = program.launch_counts()
    tmp = tempfile.mkdtemp(prefix="h100bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = trace_mod.summarize(trace_mod.load_events(path), slice_s)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = summary.pop("kernel_counts")
    by_launch_name = {k: sum(c for name, c in counts.items() if k in name) for k in launches}
    print(json.dumps({"traced_units": n,
                      "traced_ms_a_unit": 1e3 * slice_s / n,
                      "untraced_window_ms_a_unit": 1e3 * window["window_s"] / window["attempted"],
                      "program_launches": launches,
                      "trace_kernels_named_alike": by_launch_name,
                      "trace_kernels": sum(counts.values()),
                      "trace_kernel_counts_top": dict(sorted(counts.items(),
                                                             key=lambda kv: -kv[1])[:12])}),
          file=log)
    return summary
