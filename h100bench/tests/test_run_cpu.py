"""A whole run of the micro cell on the CPU (the card check skipped), sound
and with the timed path broken underneath: ``correct`` must come out true
for the program as it is and false for each fault an eval cell can have."""

import time

import pytest
import torch

from harness import bench


def run_micro(root, seed=123456789012):
    cell = bench.load_cell(root, "micro-eval", bench_dir=root / "h100bench")
    return bench.run(cell, seed, 0.5, False, torch.device("cpu"), time.perf_counter())


def test_sound_run_is_correct(micro_root):
    res = run_micro(micro_root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"eval_frames_per_s", "request_p90_ms", "setup_s"}
    assert res["checks"]["depth_gap"]["value"] > 0  # bf16 against f32 is never exact


def _broken(root, monkeypatch, alter):
    driver = bench.load_driver(root / "h100bench", "eval")
    build = driver.build_step

    def build_broken(config, seed, state, device):
        model, step = build(config, seed, state, device)

        def step_broken(batch, init_latent=None):
            return alter(model, step, batch, init_latent)

        return model, step_broken

    monkeypatch.setattr(driver, "build_step", build_broken)


def _answer_altered(model, step, batch, init_latent):
    pred, met, extra = step(batch, init_latent=init_latent)
    pred = pred.clone()
    pred[0, :8] = pred[0, :8] * 1.5 + 1.0  # a band of one frame's depth
    return pred, met, extra


def _half_batch(model, step, batch, init_latent):
    pred, met, extra = step(batch, init_latent=init_latent)
    b = batch["rgb"].shape[0] // 2
    _, met_half, _ = step({k: v[:b] for k, v in batch.items()}, init_latent=init_latent[:b])
    return pred, met_half, extra


def _state_unchanged(model, step, batch, init_latent):
    head = model.depth_head
    real = head._sample
    head._sample = lambda cond, shape, gen=None, init=None: (init.float(), None)
    try:
        return step(batch, init_latent=init_latent)
    finally:
        head._sample = real


@pytest.mark.parametrize("alter", [_answer_altered, _half_batch, _state_unchanged],
                         ids=["answer_altered", "half_batch_metrics", "sampler_state_unchanged"])
def test_broken_run_is_not_correct(micro_root, monkeypatch, alter):
    _broken(micro_root, monkeypatch, alter)
    res = run_micro(micro_root)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
