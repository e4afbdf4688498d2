"""Ranks of the port's data-parallel steps for the tests (no tests here).

    python tests/test_torch_parallel_support.py CASE_DIR PORT RANKS

starts RANKS gloo ranks on the CPU through the port's own launcher
(``parallel.launch``), one torch thread each (``run_cases`` also runs on
ranks that share a card: each rank works on its mesh's device). Every rank
runs each case of
``CASE_DIR/cases.pt`` and saves what it computed to
``CASE_DIR/<case>_<rank>.pt``:

* an eval step (``make_eval_step(mesh=..., gather=True)``) of the
  case's weights: the gathered pred and the metric row;
* then a training step (``make_train_step(mesh=...)``) on its rows of the
  case's global batch: the loss, the loss and metric rows, every
  parameter's gradient after the all-reduce (the global batch's), the
  parameters after the update and the buffers;
* ``reductions``: ``sig_loss`` and ``evaluate_depth_metrics`` of the
  case's (pred, gt) under the mesh.

A case with ``inject`` hands the model the given global draws (the
starting latent, the ddim_loss noise and timesteps; each rank its rows)
and turns drop-path off, as the JAX comparisons need; without it the
model draws from a generator seeded ``seed`` on every rank.
"""

import os
import sys

import numpy as np
import torch


def _rows(a: np.ndarray, rank: int, ranks: int, dev="cpu") -> torch.Tensor:
    """Rank ``rank``'s block of the rows of a global (micro-)batch array."""
    per = a.shape[0] // ranks
    return torch.from_numpy(np.ascontiguousarray(a[rank * per:(rank + 1) * per])).to(dev)


def _inject(model, draws, rank, ranks):
    head = model.depth_head
    sample, ddim_loss = head._sample, head._ddim_loss
    lat, noise, ts = (_rows(draws[k], rank, ranks) for k in ("lat", "noise", "ts"))
    head._sample = lambda c, shape, g=None, i=None: sample(c, shape, g, lat if i is None else i)
    head._ddim_loss = lambda r, c, g=None: ddim_loss(r, c, g, noise=noise, timesteps=ts)
    backbone = model.depth_backbone
    for stage in getattr(backbone, "stages", ()):
        for blk in stage.blocks:
            blk.drop_path_rate = 0.0


def fail_on_rank(rank_to_fail: int) -> int:
    """Rank ``rank_to_fail`` raises; the others sum a one across the ranks
    (and wait there for a failed one)."""
    import torch.distributed as dist

    if dist.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails")
    t = torch.ones(1)
    dist.all_reduce(t)
    return int(t.item())


def run_cases(case_dir: str) -> None:
    from diffusiondepth_tpu_torch import LossComputer, build_model
    from diffusiondepth_tpu_torch.config import Config
    from diffusiondepth_tpu_torch.losses import sig_loss
    from diffusiondepth_tpu_torch.metrics import evaluate_depth_metrics
    from diffusiondepth_tpu_torch.parallel import activate, create_mesh, shard_batch
    from diffusiondepth_tpu_torch.training.steps import make_eval_step, make_train_step
    from diffusiondepth_tpu_torch.training.train_state import create_train_state

    torch.set_num_threads(1)
    # oneDNN's CPU convolution backward loses precision at some shapes
    # (test_torch_parallel_train's docstring), and cuDNN picks algorithms by
    # the batch's rows, whose f32 roundings parted by 3% of a gradient leaf
    # (an NVIDIA H100 80GB HBM3 at 700 W): the parity cases take PyTorch's
    # own convolutions
    torch.backends.mkldnn.enabled = False
    torch.backends.cudnn.enabled = False
    cases = torch.load(os.path.join(case_dir, "cases.pt"), weights_only=False)
    for case in cases:
        mesh = create_mesh(case["mesh_shape"])
        rank, ranks = mesh.rank, mesh.world_size
        out = {}
        if case["name"] == "reductions":
            pred = shard_batch({"x": torch.from_numpy(case["pred"])}, mesh)["x"]
            gt = shard_batch({"x": torch.from_numpy(case["gt"])}, mesh)["x"]
            with activate(mesh):
                out["sig"] = sig_loss(pred, gt)
                out["metrics"] = evaluate_depth_metrics({"gt": gt}, {"pred": pred})
            out["local_metrics"] = evaluate_depth_metrics({"gt": gt}, {"pred": pred})
            torch.save(out, os.path.join(case_dir, f"{case['name']}_{rank}.pt"))
            continue
        dev = mesh.device
        cfg = Config.from_dict(case["config"])
        model = build_model(cfg, device=dev)
        model.load_state_dict(case["state_dict"])
        if case.get("inject") is not None:
            _inject(model, case["inject"], rank, ranks)
        eval_step = make_eval_step(model, mesh=mesh, gather=True)
        ebatch = {k: torch.from_numpy(v).to(dev) for k, v in case["eval_batch"].items()}
        lat = case.get("inject") and case["inject"].get("eval_lat")
        pred, emet, _ = eval_step(shard_batch(ebatch, mesh),
                                  generator=torch.Generator(dev).manual_seed(case["seed"] + 1),
                                  init_latent=None if lat is None else _rows(lat, rank, ranks,
                                                                             dev))
        out.update(pred=pred, eval_metric=emet)
        state = create_train_state(model, cfg, 10)
        step = make_train_step(model, LossComputer(cfg), state.optimizer, cfg.accum_steps,
                               mesh=mesh)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in case["batch"].items()}
        gen = torch.Generator(dev).manual_seed(case["seed"])
        loss, lval, met = step(shard_batch(batch, mesh, cfg.accum_steps), gen)
        out.update(loss=loss, loss_val=lval, metric=met, comm=dict(step.comm),
                   grads={n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None},
                   params={n: p.detach().clone() for n, p in model.named_parameters()},
                   buffers={n: b.clone() for n, b in model.named_buffers()})
        torch.save(out, os.path.join(case_dir, f"{case['name']}_{rank}.pt"))


if __name__ == "__main__":
    case_dir, port, ranks = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from diffusiondepth_tpu_torch.parallel import launch

    launch(run_cases, [torch.device("cpu")] * ranks, port, (case_dir,))
