"""Checkpoint save and restore (port of ``diffusiondepth_tpu/utils/checkpoint.py``).

Per epoch, ``{save_dir}/model_{epoch:05d}.ckpt`` written with
``torch.save``: ``state_dict`` (the model's weights and BatchNorm buffers,
on the CPU), ``step`` and ``epoch``, and ``opt_state`` (the optimizer's
moments and count) when ``save_full`` is set or at the final epoch. Beside
it, ``model_{epoch:05d}.args.json``: the run's ``Config``, as JAX writes
it. Resuming takes the args from the checkpoint, keeping a few from the
command line, then the weights, then the optimizer state.

The file format is the port's own (JAX writes flax msgpack); lifting a JAX
checkpoint into the port goes through ``utils/convert_jax_params.py``.

A tensor-parallel state (``parallel.shard_state``) is written whole: its
shards and their optimizer moments are gathered over the model group, so
the file loads into one process bit for bit; restoring a whole checkpoint
into a sharded state cuts each tensor to this rank's shard.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..config import Config
from ..parallel.tensor import (
    gather_optimizer_state, gather_state_dict, is_sharded, shard_optimizer_state,
    shard_state_dict,
)


def save_checkpoint(save_dir: str, epoch: int, state, args: Config,
                    save_full: bool = False, write: bool = True) -> str:
    """Write ``{save_dir}/model_{epoch:05d}.ckpt`` and its ``.args.json``.
    Returns the checkpoint's path. Under a sharded state every rank of the
    model group calls it (the gather is collective), and all but one pass
    ``write=False``."""
    payload: Dict[str, Any] = {
        "state_dict": {k: v.detach().cpu() for k, v in gather_state_dict(state.model).items()},
        "step": int(state.step),
        "epoch": int(epoch),
    }
    if save_full:
        opt = gather_optimizer_state(state.optimizer)
        opt["state"] = {i: {k: v.detach().cpu() if torch.is_tensor(v) else v
                            for k, v in st.items()} for i, st in opt["state"].items()}
        payload["opt_state"] = {"count": int(state.optimizer.count), "optimizer": opt}
    path = os.path.join(save_dir, f"model_{epoch:05d}.ckpt")
    if not write:
        return path
    os.makedirs(save_dir, exist_ok=True)
    torch.save(payload, path)
    with open(os.path.join(save_dir, f"model_{epoch:05d}.args.json"), "w") as f:
        json.dump(args.to_dict(), f, indent=2, default=str)
    return path


def load_checkpoint_args(path: str) -> Optional[Config]:
    """The ``Config`` of the checkpoint's sibling ``.args.json``, or None
    when there is none."""
    args_path = path.replace(".ckpt", ".args.json")
    if not os.path.exists(args_path):
        return None
    with open(args_path) as f:
        return Config.from_dict(json.load(f))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a checkpoint written by ``save_checkpoint`` onto the CPU; the
    sibling ``.args.json``, where there is one, is attached as ``args``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    args = load_checkpoint_args(path)
    if args is not None:
        payload["args"] = args
    return payload


def apply_checkpoint_args(ckpt_args: Config, cli_args: Config) -> Config:
    """Resume: the args come from the checkpoint, with test_only, pretrain,
    dir_data, resume and save_dir (and max_depth under force_maxdepth)
    kept from the command line."""
    new = Config.from_dict(ckpt_args.to_dict())
    new.test_only = cli_args.test_only
    new.pretrain = cli_args.pretrain
    new.dir_data = cli_args.dir_data
    new.resume = cli_args.resume
    new.save_dir = cli_args.save_dir
    if cli_args.force_maxdepth:
        new.max_depth = cli_args.max_depth
    return new


def restore_state(state, payload, strict: bool = True):
    """Load a checkpoint payload into a ``TrainState`` in place: weights and
    BatchNorm buffers, the optimizer state and count when present, and the
    step. Returns the state. A sharded state takes its shards of the
    checkpoint's whole tensors."""
    sharded = is_sharded(state.model)
    sd = payload["state_dict"]
    state.model.load_state_dict(shard_state_dict(state.model, sd) if sharded else sd,
                                strict=strict)
    if "opt_state" in payload:
        opt = payload["opt_state"]["optimizer"]
        state.optimizer.load_state_dict(shard_optimizer_state(state.optimizer, opt)
                                        if sharded else opt)
        state.optimizer.count = int(payload["opt_state"]["count"])
    state.step_offset = int(payload.get("step", 0)) - state.optimizer.count
    return state
