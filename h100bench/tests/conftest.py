"""CPU tests of the benchmark. They put ``h100bench`` and the checkout root
on ``sys.path`` as ``run.py`` does, and build a micro cell (``micro/``) in a
temporary checkout: Swin micro widths, 2 frames of 64 x 192."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

MICRO = Path(__file__).resolve().parent / "micro"


@pytest.fixture(autouse=True)
def _cpu_setup():
    torch.backends.mkldnn.enabled = False  # oneDNN's conv loses precision at some shapes
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def micro_root(tmp_path):
    """A checkout root whose BENCHMARK.json has the micro cell, with a bench
    directory holding copies of the real traffic-free parts (drivers, metrics, peaks)
    and the micro configuration and traffic."""
    bench = tmp_path / "h100bench"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    shutil.copytree(BENCH / "drivers", bench / "drivers",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH / "peaks.json", bench / "peaks.json")
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    shutil.copy(MICRO / "swin_micro.json", bench / "configs" / "swin_micro.json")
    shutil.copy(MICRO / "eval_micro.json", bench / "traffic" / "eval_micro.json")
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = dict(real, configs=[{"name": "swin_micro", "source": "test",
                                "file": "h100bench/configs/swin_micro.json", "reduced": [],
                                "why": "test"}],
                workloads=[{"name": "micro-eval", "config": "swin_micro",
                            "traffic": "eval_micro", "chips": 1, "why": "test"}])
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["micro-eval"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
