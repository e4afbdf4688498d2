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
command line has no device flag. Batches come from the loader as numpy
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
from .device import resolve_device
from .losses import LossComputer
from .models.diffusion_model import build_model
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


def _eval_pass(eval_step, loader, writer, dev, generator, times):
    """One pass over a split: metric rows to ``writer``; returns the last
    (batch, output) for the panel."""
    last = None
    for batch in loader:
        t0 = time.perf_counter()
        pred, metric_val, extras = eval_step(_device_batch(batch, dev), generator=generator)
        writer.add(metric=metric_val.cpu().numpy())
        last = (batch, _host_output(pred, extras))
        times.append(time.perf_counter() - t0)
    return last or (None, None)


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
    dev = resolve_device(device)
    cfg = check_args(args)
    os.makedirs(cfg.save_dir, exist_ok=True)
    cfg.save_json(os.path.join(cfg.save_dir, "args.json"))
    backup_source_code(os.path.join(cfg.save_dir, "code"))
    print(f"device: {dev} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})")

    data_cls = get_data(cfg)
    ds_train, ds_val, ds_test = (data_cls(cfg, m) for m in ("train", "val", "test"))
    loader_train = DataLoader(ds_train, cfg.batch_size, shuffle=True, drop_last=True,
                              num_threads=max(cfg.num_threads, 1), prefetch=cfg.prefetch,
                              seed=cfg.seed)
    loader_val = DataLoader(ds_val, cfg.test_batch_size, shuffle=False, num_threads=2,
                            seed=cfg.seed)
    loader_test = DataLoader(ds_test, cfg.test_batch_size, shuffle=False, num_threads=2,
                             seed=cfg.seed)

    steps_per_epoch = max(1, len(ds_train) // cfg.batch_size)
    state = _build_state(cfg, dev, steps_per_epoch)
    start_epoch = 1
    if cfg.pretrain:
        ckpt = load_checkpoint(cfg.pretrain)
        restore_state(state, ckpt)
        print(f"loaded checkpoint {cfg.pretrain} (epoch {ckpt.get('epoch', '?')})")
        if cfg.resume:
            start_epoch = int(ckpt.get("epoch", 0)) + 1
        del ckpt

    if cfg.accum_steps > 1 and cfg.batch_size % cfg.accum_steps:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by accum_steps "
                         f"{cfg.accum_steps}")
    train_step = make_train_step(state.model, LossComputer(cfg), state.optimizer,
                                 accum_steps=cfg.accum_steps)
    summary_cls = get_summary(cfg)
    eval_step = make_eval_step(state.model, extra_keys=getattr(summary_cls, "SAVE_KEYS", ()))
    writer_train, writer_val, writer_test = (summary_cls(cfg.save_dir, m, cfg)
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
            # profiler window: steps 10-15 of the first epoch
            if cfg.profile_dir and epoch == start_epoch and i == 10:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                                 if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.start()
            loss, loss_val, metric_val = train_step(_device_batch(batch, dev), generator)
            writer_train.add(loss=loss_val.cpu().numpy(), metric=metric_val.cpu().numpy())
            if prof is not None and i == 15:
                prof = _finish_profile(prof, cfg.profile_dir, dev)
            if i % cfg.log_every == 0:
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

        save_full = cfg.save_full or epoch == cfg.epochs
        path = save_checkpoint(cfg.save_dir, epoch, state, cfg, save_full=save_full)
        print(f"saved {path}")

        eval_gen = torch.Generator(device=dev).manual_seed(cfg.seed + epoch)
        writer_val.update(epoch, *_eval_pass(eval_step, loader_val, writer_val, dev,
                                             eval_gen, times["val_s"]))
        writer_test.update(epoch, *_eval_pass(eval_step, loader_test, writer_test, dev,
                                              eval_gen, times["test_s"]))
    return state


def test(args: Config, device=None):
    """One pass over the test split with per-frame timing."""
    dev = resolve_device(device)
    cfg = check_args(args)
    os.makedirs(cfg.save_dir, exist_ok=True)

    ds_test = get_data(cfg)(cfg, "test")
    loader = DataLoader(ds_test, cfg.test_batch_size, shuffle=False, num_threads=2,
                        seed=cfg.seed)
    state = _build_state(cfg, dev, max(1, len(ds_test)))
    if cfg.pretrain:
        restore_state(state, load_checkpoint(cfg.pretrain))
        print(f"loaded checkpoint {cfg.pretrain}")

    summary_cls = get_summary(cfg)
    eval_step = make_eval_step(state.model, tta_flip=cfg.tta_flip,
                               extra_keys=getattr(summary_cls, "SAVE_KEYS", ()))
    writer = summary_cls(cfg.save_dir, "test", cfg)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)

    t_total, n, n_seen = 0.0, 0, 0
    for i, batch in enumerate(loader):
        dbatch = _device_batch(batch, dev)
        bsz = batch["rgb"].shape[0]
        _sync(dev)
        t0 = time.time()
        pred, metric_val, extras = eval_step(dbatch, generator=generator)
        _sync(dev)
        t1 = time.time()
        state.timings["test_s"].append(t1 - t0)
        # the timed region leaves out batch 0 and a ragged last batch
        if i > 0 and bsz == cfg.test_batch_size:
            t_total += t1 - t0
            n += bsz
        writer.add(metric=metric_val.cpu().numpy())
        if cfg.save_image:
            # save() takes the dataset index of the batch's first sample
            writer.save(0, n_seen, batch, _host_output(pred, extras))
        n_seen += bsz
    writer.update(0, None, None)
    if n:
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
