"""What every driver takes from the program under test: the package, its
model built from a configuration's ``program`` settings and loaded with the
benchmark's weights, and its launch counters. A driver takes its entry
(eval step, train step, ...) from ``port()`` itself."""

from __future__ import annotations

from typing import Dict


def port():
    import diffusiondepth_tpu_torch

    return diffusiondepth_tpu_torch


def build_model(config: dict, seed: int, state: Dict, device):
    """The configuration's model, built on ``device`` by the program's own
    factory and loaded with ``state``."""
    p = port()
    cfg = p.Config(**config["program"], seed=int(seed) % 2 ** 31).finalize()
    model = p.build_model(cfg, device=device)
    model.load_state_dict(state)
    return model


def launch_counts() -> Dict[str, int]:
    return dict(port().LAUNCHES)


def reset_launch_counts() -> None:
    port().reset_launch_counts()
