"""Training and evaluation entry point (port of ``diffusiondepth_tpu/main.py``).

    python -m diffusiondepth_tpu_torch.main --data_name KITTIDC ...

The same flags (``config.py``), the same models (``Diffusion_DCbase_``
and ``NLSPN``, the default), the same epoch loop and the same files as the
JAX package's ``main``. The eval passes fetch the outputs that the
summary class names in ``SAVE_KEYS`` (NLSPN's propagation internals) for
its panels and per-sample files:

* ``train``: per epoch, the training steps (``make_train_step``), the
  epoch's loss and metric logs, a checkpoint (``model_{epoch:05d}.ckpt``,
  full at ``--save_full`` or the final epoch), then a val pass and a test
  pass with their logs and panels. ``--resume --pretrain`` takes the args
  from the checkpoint and continues at its epoch + 1.
* ``test``: one pass over the test split, per-sample files with
  ``--save_image``, and the reference's "Average processing time" report
  (batch 0 and a ragged last batch left out of the timed region).

Both run on the card unless the caller passes ``device="cpu"``; the
command line has no device flag.

Ranks (``parallel/``): ``--mesh_shape data:N`` runs N data-parallel ranks,
one process per device, as JAX's ``data`` axis and the reference's
``mp.spawn``: with no launcher environment ``main`` spawns them and they
meet at ``localhost:--port``; under ``torchrun``'s environment each joins
that group. With no ``--mesh_shape`` the run takes every visible card
(one process without a group where there is one card); on the CPU it is
one process. A ``data:1`` mesh runs in this process as a one-rank group.
``--batch_size`` is the batch of one host; each rank loads and steps on
its rows. Rank 0 alone prints the logs and writes ``args.json``, the
source backup, the summaries, the checkpoints (a barrier follows each)
and the per-sample files; every rank restores a checkpoint. A spawned
run returns None; a worker that fails makes it raise. Batches come from the loader as numpy
arrays and go to the card from pinned memory. The random draws differ
from JAX's key splits: one ``torch.Generator`` on the device, seeded from
``seed``, feeds training (drop-path, the sampler's starting latent and
the ddim_loss noise and timesteps); a second, seeded from ``seed + epoch``,
feeds that epoch's val and test passes, and ``test`` draws from one seeded
from ``seed``.

``train`` and ``test`` return the ``TrainState``; its ``timings`` hold,
per training step, the seconds spent waiting on the loader (``wait_s``)
and the seconds of the step (``step_s``: the batch copy, the step and the
read-back of its loss and metric rows), the training loader's seconds per
batch (``load_s``), and per eval batch its seconds (``val_s``,
``test_s``).
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from .config import Config, parse_args
from .data import DataLoader, get as get_data
from .losses import LossComputer
from .models.diffusion_model import build_model
from .parallel.launch import run_ranks
from .parallel.mesh import barrier, broadcast_module, gather_rows, process_info
from .summary import get as get_summary
from .training.steps import make_eval_step, make_train_step
from .training.train_state import create_train_state
from .utils.checkpoint import (
    apply_checkpoint_args,
    load_checkpoint,
    load_checkpoint_args,
    restore_state,
    save_checkpoint,
)
from .utils.misc import backup_source_code


def check_args(args: Config) -> Config:
    """Resume: the args come from the checkpoint (``apply_checkpoint_args``)."""
    if args.pretrain and args.resume:
        assert os.path.exists(args.pretrain), f"missing checkpoint {args.pretrain}"
        ckpt_args = load_checkpoint_args(args.pretrain)
        if ckpt_args is not None:
            args = apply_checkpoint_args(ckpt_args, args)
    return args


def _device_batch(batch: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's arrays on ``dev``; to the card from pinned memory,
    without blocking the host."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_state(cfg: Config, dev: torch.device, steps_per_epoch: int):
    state = create_train_state(build_model(cfg, device=dev), cfg, steps_per_epoch)
    state.timings.update(wait_s=[], step_s=[], load_s=[], val_s=[], test_s=[])
    return state


def _host_output(pred: torch.Tensor, extras: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The eval step's pred and extras as f32 numpy arrays, for the writers."""
    return {k: v.detach().float().cpu().numpy() for k, v in {"pred": pred, **extras}.items()}


def _host_batch(batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """Every rank's rows of a loader batch, in rank order: the host batch
    (the batch itself without a mesh)."""
    if mesh is None or mesh.world_size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = gather_rows(t.to(mesh.device) if mesh.backend == "nccl" else t,
                                 mesh).cpu().numpy()
    return out


class _NoWriter:
    """The summary of a rank other than 0: it writes nothing."""

    def add(self, *args, **kwargs):
        pass

    def update(self, *args, **kwargs):
        pass

    def save(self, *args, **kwargs):
        pass


def _eval_pass(eval_step, loader, writer, dev, generator, times, mesh=None):
    """One pass over a split: metric rows to ``writer``; returns the last
    (host batch, output) for the panel."""
    last = None
    for batch in loader:
        t0 = time.perf_counter()
        pred, metric_val, extras = eval_step(_device_batch(batch, dev), generator=generator)
        writer.add(metric=metric_val.cpu().numpy())
        last = (batch, _host_output(pred, extras))
        times.append(time.perf_counter() - t0)
    if last is None:
        return None, None
    return _host_batch(last[0], mesh), last[1]


def _finish_profile(prof, profile_dir: str, dev: torch.device) -> None:
    """Stop the profiler, write its trace and print its table of the
    operators that took the most device time (CPU time on the CPU)."""
    _sync(dev)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    key = "self_device_time_total" if dev.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=20))


def train(args: Config, device=None):
    return run_ranks(_train, check_args(args), device, result=False)


def test(args: Config, device=None):
    """One pass over the test split with per-frame timing."""
    return run_ranks(_test, check_args(args), device, result=False)


def _train(cfg: Config, dev: torch.device, mesh):
    main_rank = mesh is None or mesh.is_main
    if main_rank:
        os.makedirs(cfg.save_dir, exist_ok=True)
        cfg.save_json(os.path.join(cfg.save_dir, "args.json"))
        backup_source_code(os.path.join(cfg.save_dir, "code"))
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"device: {dev} ({name})" + (f" | mesh: {mesh.axes}" if mesh else ""))

    # the host's shard of the dataset and this rank's rows of each batch
    shard = dict(process_info(), rank_index=mesh.local_rank,
                 rank_count=mesh.local_size) if mesh else {}
    data_cls = get_data(cfg)
    ds_train, ds_val, ds_test = (data_cls(cfg, m) for m in ("train", "val", "test"))
    loader_train = DataLoader(ds_train, cfg.batch_size, shuffle=True, drop_last=True,
                              num_threads=max(cfg.num_threads, 1), prefetch=cfg.prefetch,
                              seed=cfg.seed, accum_steps=cfg.accum_steps, **shard)
    loader_val = DataLoader(ds_val, cfg.test_batch_size, shuffle=False, num_threads=2,
                            seed=cfg.seed, **shard)
    loader_test = DataLoader(ds_test, cfg.test_batch_size, shuffle=False, num_threads=2,
                             seed=cfg.seed, **shard)
    for loader in (loader_train, loader_val, loader_test):
        loader.batches()  # a batch that does not divide over the ranks raises here

    steps_per_epoch = max(1, len(ds_train) // cfg.batch_size)
    state = _build_state(cfg, dev, steps_per_epoch)
    start_epoch = 1
    if cfg.pretrain:  # every rank restores
        ckpt = load_checkpoint(cfg.pretrain)
        restore_state(state, ckpt)
        if main_rank:
            print(f"loaded checkpoint {cfg.pretrain} (epoch {ckpt.get('epoch', '?')})")
        if cfg.resume:
            start_epoch = int(ckpt.get("epoch", 0)) + 1
        del ckpt
    broadcast_module(state.model, mesh)  # the ranks start from rank 0's weights

    if cfg.accum_steps > 1 and cfg.batch_size % cfg.accum_steps:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by accum_steps "
                         f"{cfg.accum_steps}")
    train_step = make_train_step(state.model, LossComputer(cfg), state.optimizer,
                                 accum_steps=cfg.accum_steps, mesh=mesh)
    summary_cls = get_summary(cfg)
    eval_step = make_eval_step(state.model, extra_keys=getattr(summary_cls, "SAVE_KEYS", ()),
                               mesh=mesh, gather=True)
    writer_train, writer_val, writer_test = (
        summary_cls(cfg.save_dir, m, cfg) if main_rank else _NoWriter()
        for m in ("train", "val", "test"))
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    times = state.timings

    for epoch in range(start_epoch, cfg.epochs + 1):
        loader_train.set_epoch(epoch)
        t0 = time.time()
        prof = None
        t_prev = time.perf_counter()
        for i, batch in enumerate(loader_train):
            t_got = time.perf_counter()
            # profiler window: steps 10-15 of the first epoch, on rank 0
            if cfg.profile_dir and main_rank and epoch == start_epoch and i == 10:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.start()
            loss, loss_val, metric_val = train_step(_device_batch(batch, dev), generator)
            writer_train.add(loss=loss_val.cpu().numpy(), metric=metric_val.cpu().numpy())
            if prof is not None and i == 15:
                prof = _finish_profile(prof, cfg.profile_dir, dev)
            if main_rank and i % cfg.log_every == 0:
                print(f"epoch {epoch} step {i}/{steps_per_epoch} "
                      f"loss {float(loss):.4f} ({time.time() - t0:.1f}s)")
            t_done = time.perf_counter()
            times["wait_s"].append(t_got - t_prev)
            times["step_s"].append(t_done - t_got)
            t_prev = t_done
        if prof is not None:  # an epoch of fewer than 16 steps
            prof = _finish_profile(prof, cfg.profile_dir, dev)
        times["load_s"].extend(loader_train.load_s)
        writer_train.update(epoch, None, None)

        if main_rank:
            save_full = cfg.save_full or epoch == cfg.epochs
            path = save_checkpoint(cfg.save_dir, epoch, state, cfg, save_full=save_full)
            print(f"saved {path}")
        barrier(mesh)

        eval_gen = torch.Generator(device=dev).manual_seed(cfg.seed + epoch)
        writer_val.update(epoch, *_eval_pass(eval_step, loader_val, writer_val, dev,
                                             eval_gen, times["val_s"], mesh))
        writer_test.update(epoch, *_eval_pass(eval_step, loader_test, writer_test, dev,
                                              eval_gen, times["test_s"], mesh))
    return state


def _test(cfg: Config, dev: torch.device, mesh):
    main_rank = mesh is None or mesh.is_main
    if main_rank:
        os.makedirs(cfg.save_dir, exist_ok=True)

    shard = dict(process_info(), rank_index=mesh.local_rank,
                 rank_count=mesh.local_size) if mesh else {}
    ds_test = get_data(cfg)(cfg, "test")
    loader = DataLoader(ds_test, cfg.test_batch_size, shuffle=False, num_threads=2,
                        seed=cfg.seed, **shard)
    state = _build_state(cfg, dev, max(1, len(ds_test)))
    if cfg.pretrain:
        restore_state(state, load_checkpoint(cfg.pretrain))
        if main_rank:
            print(f"loaded checkpoint {cfg.pretrain}")
    broadcast_module(state.model, mesh)

    summary_cls = get_summary(cfg)
    eval_step = make_eval_step(state.model, tta_flip=cfg.tta_flip,
                               extra_keys=getattr(summary_cls, "SAVE_KEYS", ()),
                               mesh=mesh, gather=True)
    writer = summary_cls(cfg.save_dir, "test", cfg) if main_rank else _NoWriter()
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    t_total, n, n_seen = 0.0, 0, 0
    for i, batch in enumerate(loader):
        dbatch = _device_batch(batch, dev)
        _sync(dev)
        t0 = time.time()
        pred, metric_val, extras = eval_step(dbatch, generator=generator)
        _sync(dev)
        t1 = time.time()
        bsz = pred.shape[0]  # the host batch
        state.timings["test_s"].append(t1 - t0)
        # the timed region leaves out batch 0 and a ragged last batch
        if i > 0 and bsz == cfg.test_batch_size:
            t_total += t1 - t0
            n += bsz
        writer.add(metric=metric_val.cpu().numpy())
        if cfg.save_image:
            # save() takes the dataset index of the batch's first sample
            writer.save(0, n_seen, _host_batch(batch, mesh), _host_output(pred, extras))
        n_seen += bsz
    writer.update(0, None, None)
    if n and main_rank:
        print(f"elapsed time : {t_total:.4f} sec, "
              f"Average processing time : {t_total / n:.4f} sec")
    return state


def main(args: Config, device=None):
    if args.test_only:
        test(args, device)
    else:
        train(args, device)
    print("done")


if __name__ == "__main__":
    main(parse_args())
