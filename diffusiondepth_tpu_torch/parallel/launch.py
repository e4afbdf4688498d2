"""Start the ranks of a run: one process per device, as the reference's
``mp.spawn`` does, or this process alone.

``run_ranks`` decides: inside a started process group (a spawned rank, or
the caller's) it runs this rank; under ``torchrun``'s environment it joins
that group; else ``--mesh_shape data:N`` asks for N ranks (on the CPU, N
processes; on the card, one per visible card, which the mesh must cover
as JAX's ``parse_mesh_shape`` requires), no ``--mesh_shape`` takes every
visible card (one process without a group where there is one card or the
CPU), and a single rank of an explicit mesh runs here as a one-rank group.

``launch`` spawns ``len(devices)`` workers that meet at
``tcp://localhost:<port>``; rank r runs on ``devices[r]`` (a card of its
own, the same card for ranks that share one, or the CPU). A worker that
raises or dies ends the others and makes ``launch`` raise. Each worker is
killed with the process that started it.
"""

from __future__ import annotations

import ctypes
import signal
import sys
from typing import Any, Callable, Sequence

import os

import torch

from .mesh import create_mesh, initialize_multihost, normalise_device, parse_mesh_shape, shutdown


def _die_with_parent() -> None:
    """Linux: deliver SIGKILL to this process when its parent exits."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def _worker(rank: int, fn: Callable, devices: Sequence[torch.device], port: int,
            args: tuple, results) -> None:
    _die_with_parent()
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_multihost(f"localhost:{port}", len(devices), rank, devices)
    try:
        out = fn(*args)
        if rank == 0:
            results.put(out)
    finally:
        shutdown()


def launch(fn: Callable, devices: Sequence[torch.device], port, args: tuple = ()) -> Any:
    """Run ``fn(*args)`` in one spawned process per device, inside a
    process group of ``len(devices)`` ranks; returns rank 0's result
    (which must pickle). ``fn`` must be importable by the workers (a
    module-level function)."""
    import torch.multiprocessing as mp

    devices = [normalise_device(d) for d in devices]
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_worker, args=(fn, devices, int(port), args, results),
                             nprocs=len(devices), join=False, start_method="spawn")
    out = None
    # read rank 0's result while the workers run: a result larger than the
    # pipe's buffer blocks its writer until it is read
    while not ctx.join(timeout=0.5):
        if not results.empty():
            out = results.get()
    if not results.empty():
        out = results.get()
    return out


def run_in_group(fn: Callable, device: torch.device, port, args: tuple = ()) -> Any:
    """Run ``fn(*args)`` in this process as the one rank of a process
    group on ``device`` (a ``data:1`` mesh), then end the group."""
    initialize_multihost(f"localhost:{port}", 1, 0, [device])
    try:
        return fn(*args)
    finally:
        shutdown()


def rank_devices(cfg, device=None) -> list:
    """The device of each rank of a run started here (see the module's
    docstring)."""
    from ..config import mesh_devices
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        n = mesh_devices(cfg.mesh_shape)
        parse_mesh_shape(cfg.mesh_shape, n)
        return [dev] * n
    n = torch.cuda.device_count()
    parse_mesh_shape(cfg.mesh_shape, n)
    if n == 1 and not cfg.mesh_shape:
        return [dev]
    return [torch.device("cuda", i) for i in range(n)]


def _in_group(fn: Callable, cfg, args: tuple) -> Any:
    """``fn`` on this rank of the started process group."""
    mesh = create_mesh(cfg.mesh_shape)
    return fn(cfg, mesh.device, mesh, *args)


def _spawned(fn: Callable, cfg, args: tuple) -> None:
    _in_group(fn, cfg, args)


def run_ranks(fn: Callable, cfg, device=None, args: tuple = (), result: bool = True) -> Any:
    """``fn(cfg, device, mesh, *args)`` on every rank that ``cfg`` asks
    for (``mesh`` None for one process outside a group). Returns ``fn``'s
    result where it ran in this process; from spawned ranks, rank 0's
    (which must pickle) when ``result``, else None."""
    from ..device import resolve_device

    if torch.distributed.is_initialized():
        return _in_group(fn, cfg, args)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # torchrun
        dev = resolve_device(device)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        if dev.type == "cuda":
            if local > torch.cuda.device_count():
                raise ValueError(f"{local} ranks on this host, {torch.cuda.device_count()} "
                                 "visible cards")
            devices = [torch.device("cuda", i) for i in range(local)]
            torch.cuda.set_device(devices[int(os.environ.get("LOCAL_RANK", 0))])
        else:
            devices = [dev] * local
        initialize_multihost(devices=devices)
        try:
            return _in_group(fn, cfg, args)
        finally:
            shutdown()
    devices = rank_devices(cfg, device)
    if len(devices) == 1 and not cfg.mesh_shape:
        return fn(cfg, devices[0], None, *args)
    if len(devices) == 1:
        return run_in_group(_in_group, devices[0], cfg.port, (fn, cfg, args))
    return launch(_in_group if result else _spawned, devices, cfg.port, (fn, cfg, args))
