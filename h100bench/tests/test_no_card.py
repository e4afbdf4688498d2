"""``run.py`` exits non-zero and prints no result where there is no CUDA card
(the CPU machine that runs these tests), and in a directory that holds only
``BENCHMARK.json`` and the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "h100bench/run.py", "--workload", "swinl-eval-bs8",
                           "--seed", "4000000001", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "correct" in obj)


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run(ROOT)
    assert res.returncode != 0
    assert "needs 1 CUDA card" in res.stderr
    _no_result(res.stdout)


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "h100bench", ignore=shutil.ignore_patterns(".cache"))
    res = _run(tmp_path)
    assert res.returncode != 0
    _no_result(res.stdout)
