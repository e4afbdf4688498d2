"""Statistical accuracy-parity evaluation (the port of
``diffusiondepth_tpu/tools/eval_parity.py``).

Diffusion inference starts from a random latent, so bit parity with the
reference is undefined; accuracy parity is a statistical statement: the
metrics over N independent latent seeds must bracket the reference's
published numbers. This runs the reference's evaluation protocol (its
``test()``, src/main.py:404-491: batch ``--test_batch_size``, 1 by
default, latents sized from gt, optionally ``--inference_steps 50
--tta_flip``) over N seeds on a port checkpoint and reports mean / std / min / max per metric and, given reference values,
each metric's deviation and the verdict: |mean - ref| <= max(|ref| * rtol,
2 * std), the seeds' spread standing in for the latent's randomness.

Usage (every flag of ``main`` passes through, plus the harness's):

  python -m diffusiondepth_tpu_torch.tools.eval_parity \\
      --pretrain converted/model_00022.ckpt --dir_data ../datasets/kitti \\
      --data_name KITTIDC --split_json .../kitti_dc.json \\
      --backbone_module swin --backbone_name swin_large_naive_l4w722422k \\
      --head_specify DDIMDepthEstimate_Swin_ADDHAHI \\
      --parity_seeds 3 --parity_reference BASELINE.json#kitti_swin \\
      [--inference_steps 50 --tta_flip] [--device cpu]

``--mesh_shape data:N`` divides each batch over N ranks, one process per
device, as ``main`` runs them (``parallel/launch.py``): each metric row is
the global batch's, as JAX's ``eval_parity`` takes the mesh; the
batch must divide over the ranks.

Reference values are ``path.json`` holding ``{"RMSE": 0.9801, ...}`` or
``path.json#key`` (dots for nested keys) selecting a sub-dict.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config, build_parser
from ..metrics import METRIC_NAMES

RTOL_DEFAULT = 0.01  # the north star: RMSE within 1%


def _load_reference_metrics(spec: str) -> Dict[str, float]:
    path, _, key = spec.partition("#")
    with open(path) as f:
        data = json.load(f)
    if key:
        for part in key.split("."):
            data = data[part]
    return {k: float(v) for k, v in data.items() if k in METRIC_NAMES}


def parity_report(per_seed: np.ndarray, protocol: Dict,
                  reference_metrics: Optional[Dict[str, float]] = None,
                  rtol: float = RTOL_DEFAULT) -> Dict:
    """The report of (n_seeds, 8) per-seed mean metric rows: mean, std,
    min and max per metric and, for each metric with a reference value,
    its relative deviation and ``within_tolerance``; ``parity`` when every
    checked metric is within."""
    stack = np.asarray(per_seed)  # the metric rows' own type (f32), as JAX aggregates
    report: Dict = {"protocol": dict(protocol), "metrics": {}}
    for i, name in enumerate(METRIC_NAMES):
        col = stack[:, i]
        m = {"mean": float(col.mean()), "std": float(col.std()),
             "min": float(col.min()), "max": float(col.max())}
        if reference_metrics and name in reference_metrics:
            ref = reference_metrics[name]
            m["reference"] = ref
            m["rel_dev"] = float((m["mean"] - ref) / ref) if ref else 0.0
            slack = max(abs(ref) * rtol, 2.0 * m["std"])
            m["within_tolerance"] = bool(abs(m["mean"] - ref) <= slack)
        report["metrics"][name] = m
    if reference_metrics:
        checked = [v for v in report["metrics"].values() if "within_tolerance" in v]
        report["parity"] = bool(checked) and all(v["within_tolerance"] for v in checked)
    return report


def run_parity_eval(cfg: Config, n_seeds: int = 3,
                    reference_metrics: Optional[Dict[str, float]] = None,
                    rtol: float = RTOL_DEFAULT, device=None) -> Dict:
    """Evaluate the test split ``n_seeds`` times, seed s drawing its
    latents from a generator seeded ``cfg.seed + 1000 s``, and return the
    report of ``parity_report``. Runs on the card unless ``device="cpu"``,
    on the ranks that ``cfg.mesh_shape`` asks for (rank 0's report)."""
    from ..parallel.launch import run_ranks

    return run_ranks(_parity_eval, cfg, device, (n_seeds, reference_metrics, rtol))


def _parity_eval(cfg: Config, dev: torch.device, mesh, n_seeds: int,
                 reference_metrics: Optional[Dict[str, float]], rtol: float) -> Dict:
    from ..data import DataLoader, get as get_data
    from ..models.diffusion_model import build_model
    from ..parallel.mesh import broadcast_module, process_info
    from ..training.steps import make_eval_step
    from ..utils.checkpoint import load_checkpoint

    main_rank = mesh is None or mesh.is_main
    shard = dict(process_info(), rank_index=mesh.local_rank,
                 rank_count=mesh.local_size) if mesh else {}
    ds = get_data(cfg)(cfg, "test")
    loader = DataLoader(ds, cfg.test_batch_size, shuffle=False, num_threads=2, seed=cfg.seed,
                        **shard)
    model = build_model(cfg, device=dev)
    if cfg.pretrain:
        model.load_state_dict(load_checkpoint(cfg.pretrain)["state_dict"])
        if main_rank:
            print(f"loaded checkpoint {cfg.pretrain}")
    broadcast_module(model, mesh)
    eval_step = make_eval_step(model, tta_flip=cfg.tta_flip, mesh=mesh)

    per_seed: List[np.ndarray] = []
    for s in range(n_seeds):
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1000 * s)
        rows = []
        t0 = time.time()
        for batch in loader:
            dbatch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
                      if isinstance(v, np.ndarray)}
            _, metric_val, _ = eval_step(dbatch, generator=gen)
            rows.append(metric_val.cpu().numpy())
        mean_row = np.concatenate(rows, axis=0).mean(axis=0)
        per_seed.append(mean_row)
        line = "  ".join(f"{n}: {v:.4f}" for n, v in zip(METRIC_NAMES, mean_row))
        if main_rank:
            print(f"seed {s}: {line}  ({time.time() - t0:.1f}s)")

    protocol = {"n_seeds": n_seeds, "inference_steps": cfg.inference_steps,
                "tta_flip": cfg.tta_flip, "test_batch_size": cfg.test_batch_size,
                "num_samples": len(ds), "device": str(dev)}
    return parity_report(np.stack(per_seed), protocol, reference_metrics, rtol)


_HARNESS_KEYS = ("parity_seeds", "parity_reference", "parity_rtol", "parity_out", "device")


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description="statistical accuracy-parity evaluation",
                                parents=[build_parser()], conflict_handler="resolve")
    p.add_argument("--parity_seeds", type=int, default=3)
    p.add_argument("--parity_reference", type=str, default=None,
                   help="path.json[#key] with reference metric values")
    p.add_argument("--parity_rtol", type=float, default=RTOL_DEFAULT)
    p.add_argument("--parity_out", type=str, default=None, help="where to write the json report")
    p.add_argument("--device", default=None, help="default: the card")
    ns = p.parse_args(argv)
    cfg = Config.from_dict({k: v for k, v in vars(ns).items() if k not in _HARNESS_KEYS})
    ref = _load_reference_metrics(ns.parity_reference) if ns.parity_reference else None
    report = run_parity_eval(cfg, ns.parity_seeds, ref, ns.parity_rtol, device=ns.device)
    print(json.dumps(report, indent=2))
    if ns.parity_out:
        os.makedirs(os.path.dirname(ns.parity_out) or ".", exist_ok=True)
        with open(ns.parity_out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {ns.parity_out}")
    return report


if __name__ == "__main__":
    main()
