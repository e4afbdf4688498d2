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

A case with ``min_size`` is tensor-parallel: the model is cut by
``state_sharding(model, mesh, min_size)`` and ``shard_state`` before the
steps, the train step takes ``state_shardings``, and the gradients and
parameters saved are made whole again (``whole_like``,
``gather_state_dict``); ``local`` holds the elements of this rank's
parameters and Adam moments, ``sharded`` the names that were cut; after
the step every rank saves the state through ``save_checkpoint`` (rank 0
writes ``CASE_DIR/<case>_ckpt``), restores that whole checkpoint into its
shards, and records whether its shards came back bit for bit
(``restored``).

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


def tp_layers():
    """One layer of every tensor-parallel route, f64: a Conv2d and a
    ConvTranspose2d (column-parallel), a depthwise Conv2d and an embedding
    table (weight-gather), a Linear (column-parallel) and flax's attention
    (query/key/value cut on whole heads). ``forward(x, t) -> y``."""
    import torch.nn as nn

    from diffusiondepth_tpu_torch.models.common import conv2d_nhwc, conv_transpose2d_nhwc, linear
    from diffusiondepth_tpu_torch.models.necks.transformer import _MultiHeadAttention
    from diffusiondepth_tpu_torch.parallel import whole

    class Layers(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(8, 32, 3, 1, 1)
            self.deconv = nn.ConvTranspose2d(32, 32, 2, 2)
            self.dw = nn.Conv2d(32, 32, 3, 1, 1, groups=32)
            self.lin = nn.Linear(32, 32)
            self.embed = nn.Embedding(10, 32)
            self.attn = _MultiHeadAttention(32, 4)

        def forward(self, x, t):
            y = conv2d_nhwc(x, self.conv.weight, self.conv.bias, 1, 1)
            y = conv_transpose2d_nhwc(torch.relu(y), self.deconv.weight, self.deconv.bias, 2, 0, 0)
            y = conv2d_nhwc(y, self.dw.weight, self.dw.bias, 1, 1, groups=32)
            y = linear(y, self.lin, None) + whole(self.embed.weight)[t][:, None, None, :]
            tok = y.reshape(y.shape[0], -1, 32)
            return self.attn(tok, tok, tok)

    torch.manual_seed(0)
    return Layers().double()


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
    from diffusiondepth_tpu_torch.parallel import (
        activate, create_mesh, gather_state_dict, shard_batch, shard_state, state_sharding,
    )
    from diffusiondepth_tpu_torch.parallel.tensor import whole_like
    from diffusiondepth_tpu_torch.training.steps import make_eval_step, make_train_step
    from diffusiondepth_tpu_torch.training.train_state import create_train_state
    from diffusiondepth_tpu_torch.utils.checkpoint import (
        load_checkpoint, restore_state, save_checkpoint,
    )

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
        rank, ranks = mesh.data_index, mesh.data_size
        out = {}
        if case["name"] == "layers":
            dev = mesh.device
            layers = tp_layers().to(dev)
            shard_state(layers, state_sharding(layers, mesh, case["min_size"]))
            x = torch.from_numpy(case["x"]).to(dev).requires_grad_(True)
            y = layers(x, torch.from_numpy(case["t"]).to(dev))
            (y * torch.from_numpy(case["w"]).to(dev)).sum().backward()
            out = {"y": y.detach().cpu(), "dx": x.grad.cpu(),
                   "grads": {n: whole_like(p.grad, p).cpu()
                             for n, p in layers.named_parameters()},
                   "local": {n: p.numel() for n, p in layers.named_parameters()}}
            torch.save(out, os.path.join(case_dir, f"{case['name']}_{mesh.rank}.pt"))
            continue
        if case["name"] == "reductions":
            pred = shard_batch({"x": torch.from_numpy(case["pred"])}, mesh)["x"]
            gt = shard_batch({"x": torch.from_numpy(case["gt"])}, mesh)["x"]
            with activate(mesh):
                out["sig"] = sig_loss(pred, gt)
                out["metrics"] = evaluate_depth_metrics({"gt": gt}, {"pred": pred})
            out["local_metrics"] = evaluate_depth_metrics({"gt": gt}, {"pred": pred})
            torch.save(out, os.path.join(case_dir, f"{case['name']}_{mesh.rank}.pt"))
            continue
        dev = mesh.device
        cfg = Config.from_dict(case["config"])
        model = build_model(cfg, device=dev)
        model.load_state_dict(case["state_dict"])
        if case.get("inject") is not None:
            _inject(model, case["inject"], rank, ranks)
        sharding = None
        if case.get("min_size"):
            sharding = state_sharding(model, mesh, case["min_size"])
            shard_state(model, sharding)
            out["sharded"] = sharding.sharded
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
                               mesh=mesh, state_shardings=sharding)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in case["batch"].items()}
        gen = torch.Generator(dev).manual_seed(case["seed"])
        loss, lval, met = step(shard_batch(batch, mesh, cfg.accum_steps), gen)
        whole_sd = gather_state_dict(model)
        out.update(loss=loss, loss_val=lval, metric=met, comm=dict(step.comm),
                   grads={n: whole_like(p.grad, p).clone() for n, p in model.named_parameters()
                          if p.grad is not None},
                   params={n: whole_sd[n].detach().clone() for n, _ in model.named_parameters()},
                   buffers={n: b.clone() for n, b in model.named_buffers()},
                   local={n: (p.numel(), sum(v.numel() for v in state.optimizer.state[p].values()
                                              if torch.is_tensor(v)))
                          for n, p in model.named_parameters()})
        if sharding is not None:
            import torch.distributed as dist

            ckpt_dir = os.path.join(case_dir, f"{case['name']}_ckpt")
            path = save_checkpoint(ckpt_dir, 1, state, cfg, save_full=True,
                                   write=mesh.rank == 0)
            dist.barrier()
            held = [t.clone() for t in list(model.parameters())
                    + [v for st in state.optimizer.state.values() for v in st.values()]]
            restore_state(state, load_checkpoint(path))
            back = list(model.parameters()) + [v for st in state.optimizer.state.values()
                                               for v in st.values()]
            out["restored"] = all(torch.equal(a, b) for a, b in zip(held, back))
        torch.save(out, os.path.join(case_dir, f"{case['name']}_{mesh.rank}.pt"))


if __name__ == "__main__":
    case_dir, port, ranks = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from diffusiondepth_tpu_torch.parallel import launch

    launch(run_cases, [torch.device("cpu")] * ranks, port, (case_dir,))
