"""On the card: a whole run of the micro cell with the program's kernels
(K1, K3, K4) against the reference, and the same run with the answer
altered where it is produced. Skips without a card."""

import time

import pytest
import torch

from harness import bench


def _run(micro_root):
    cell = bench.load_cell(micro_root, "micro-eval", bench_dir=micro_root / "h100bench")
    return bench.run(cell, 4000000001, 1.0, True, torch.device("cuda"), time.perf_counter())


@pytest.mark.cuda
def test_micro_run_on_the_card(micro_root, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(micro_root)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert {"sampler_ms.eval", "backbone_ms.eval", "device_idle_pct.eval"} <= set(res["metrics"])

    driver = bench.load_driver(micro_root / "h100bench", "eval")
    build = driver.build_step

    def altered(config, seed, state, device):
        model, step = build(config, seed, state, device)

        def step_altered(batch, init_latent=None):
            pred, met, extra = step(batch, init_latent=init_latent)
            return pred * 2.0 + 1.0, met, extra

        return model, step_altered

    monkeypatch.setattr(driver, "build_step", altered)
    assert not _run(micro_root)["correct"]
