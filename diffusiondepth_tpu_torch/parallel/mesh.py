"""The mesh of one process per device (port of
``diffusiondepth_tpu/parallel/mesh.py``).

JAX declares a mesh, shards the batch over its 'data' axis and lets GSPMD
insert the gradient all-reduce and the cross-replica BatchNorm sums. The
port runs one process per card under ``torch.distributed`` and computes
the same numbers by hand.

The ranks lie on the mesh as JAX lays its devices: C-order over the
spec's axes, in the spec's order, so rank r has the coordinates
``np.unravel_index(r, sizes)`` ("data:2,model:2" and "model:2,data:2"
differ). The ranks that share every coordinate but 'data' form a *data
group*, those that share every coordinate but 'model' a *model group*
(each created on every rank, in one order). The batch is sharded over
'data' only (JAX's ``P("data")``): the ranks of a model group hold the
same rows and draw the same numbers, and everything below reduces over
the data group. Tensor parallelism over 'model' (``state_sharding``) is
``parallel/tensor.py``'s.

* ``--batch_size`` is the batch of one host. With ``accum_steps`` micro-
  batches of m rows, data rank r of n on the host takes rows
  ``[i m + r m/n, i m + (r+1) m/n)`` of each micro-block i
  (``rank_rows``), so that its micro-batch i is its share of the global
  micro-batch i, as JAX's reshape of the sharded global batch gives it.
* BatchNorm takes (sum x, sum x^2, count) over the global batch, the loss
  terms that are batch means take global sums, the metrics take global
  masked sums: each through ``all_reduce_sum``, which autograd
  differentiates (its backward all-reduces the gradient).
* Every random draw is of the global (micro-)batch's shape, from a
  generator seeded the same on every rank; a rank keeps its data
  coordinate's rows (``draw_rows``). The generators stay in lockstep, and
  a run's numbers do not depend on the number of ranks.
* The parameters are replicated unless ``state_sharding`` cuts them:
  broadcast from rank 0 after build and restore, one bucketed all-reduce
  (sum) of the gradients over the data group per step.

A mesh is made active around a step (``activate``); with no active mesh,
or one whose data axis has a single rank, every helper here is the
identity, so a ``data:1`` mesh computes the no-mesh results bit for bit.

The backend is chosen from the device list before the process group
starts: NCCL where each rank has a card of its own, gloo on the CPU and
where ranks share a card (NCCL refuses two ranks on one device). Gloo
all-reduces and broadcasts CUDA tensors itself; its all_gather takes none,
so the gloo branch gathers host copies. A collective inside autograd's
backward (BatchNorm's, the losses') must see a CUDA tensor on a card: the
engine runs a CUDA node on the device's thread in one order on every rank,
while a node on a host copy would run on the CPU's thread, in an order
that depends on timing, and the ranks' collectives would part.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from ..ops.native import to_device

# how long a collective (the rendezvous too) may wait before it raises
TIMEOUT_S = 1800


def parse_mesh_shape(spec: Optional[str], n_devices: int) -> Dict[str, int]:
    """Parse "data:4,model:2" into an axis dict; default all-data."""
    if not spec:
        return {"data": n_devices}
    axes = {}
    for part in spec.split(","):
        name, size = part.split(":")
        axes[name.strip()] = int(size)
    total = int(np.prod(list(axes.values())))
    if total != n_devices:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n_devices}")
    return axes


def axis_ranks(axes: Dict[str, int], rank: int, axis: str) -> List[int]:
    """The ranks that share every coordinate of ``rank`` but ``axis``, in
    the order of that axis (JAX's C-order layout of the devices)."""
    if axis not in axes:
        return [rank]
    sizes = tuple(axes.values())
    coords = list(np.unravel_index(rank, sizes))
    i = list(axes).index(axis)
    out = []
    for c in range(sizes[i]):
        coords[i] = c
        out.append(int(np.ravel_multi_index(tuple(coords), sizes)))
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh: the axes, the world (one rank per
    device), this rank's device, the process group (None for a single
    process outside any group) and the groups of its data and model axes
    (None where the axis has one rank or there is no group)."""

    axes: Dict[str, int]
    rank: int
    world_size: int
    local_rank: int
    local_size: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.axes:
            return 0
        sizes = tuple(self.axes.values())
        return int(np.unravel_index(self.rank, sizes)[list(self.axes).index(axis)])

    @property
    def data_index(self) -> int:
        return self.coord("data")

    @property
    def data_size(self) -> int:
        return self.axes.get("data", 1)

    @property
    def model_index(self) -> int:
        return self.coord("model")

    @property
    def model_size(self) -> int:
        return self.axes.get("model", 1)

    def data_ranks(self) -> List[int]:
        return axis_ranks(self.axes, self.rank, "data")

    def model_ranks(self) -> List[int]:
        return axis_ranks(self.axes, self.rank, "model")

    @property
    def loader_index(self) -> int:
        """This rank's place among the data ranks of its host: which rows
        of the host batch it loads (``rank_rows``)."""
        hosts = self.world_size // self.local_size
        per_host = self.data_size // hosts
        if self.data_size % hosts or self.data_index // per_host != self.rank // self.local_size:
            raise ValueError(f"mesh {self.axes} over {hosts} hosts: a host must hold the "
                             "ranks of consecutive data coordinates (a data-major mesh)")
        return self.data_index % per_host

    @property
    def loader_count(self) -> int:
        """The data ranks of one host: the host batch divides over them."""
        return self.data_size // (self.world_size // self.local_size)


# the per-rank devices the process group was started with
_GROUP_DEVICES: Optional[List[torch.device]] = None


def visible_devices() -> List[torch.device]:
    """The devices a mesh may span: every visible card, or the CPU when no
    card is visible."""
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def normalise_device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


def choose_backend(devices: Sequence[torch.device]) -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU, or
    ranks that share a card)."""
    devs = [normalise_device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         devices: Optional[Sequence[torch.device]] = None) -> None:
    """Start the process group: ``env://`` under torchrun's environment,
    else ``tcp://coordinator_address`` with ``num_processes`` ranks, this
    one ``process_id``. ``devices`` is the device of each rank (under
    torchrun, of each rank on this host); the backend is chosen from it.
    Does nothing when the group is already started, as JAX's does."""
    global _GROUP_DEVICES
    if dist.is_initialized():
        return
    if devices is None:
        raise ValueError("initialize_multihost needs the device of each rank")
    devices = [normalise_device(d) for d in devices]
    backend = choose_backend(devices)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if _torchrun_env():
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        # rank q runs on its host's device of local rank q % (ranks per host)
        devices = [devices[q % len(devices)] for q in range(dist.get_world_size())]
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("outside torchrun, initialize_multihost needs the coordinator "
                             "address, the number of processes and this process's id")
        if len(devices) != num_processes:
            raise ValueError(f"{num_processes} processes, {len(devices)} devices")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    _GROUP_DEVICES = devices


def shutdown() -> None:
    """Destroy the process group started by ``initialize_multihost``."""
    global _GROUP_DEVICES
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP_DEVICES = None


def _local_layout() -> tuple:
    """(local rank, ranks on this host, host index, host count)."""
    if not dist.is_initialized():
        return 0, 1, 0, 1
    world, rank = dist.get_world_size(), dist.get_rank()
    if _torchrun_env():
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        local = int(os.environ.get("LOCAL_RANK", rank % local_size))
        return local, local_size, rank // local_size, world // local_size
    return rank, world, 0, 1


def process_info() -> Dict[str, int]:
    """Host-sharding identity for the input pipeline: this host's index and
    the number of hosts (under torchrun, the node rank and node count)."""
    _, _, host, hosts = _local_layout()
    return {"host_index": host, "host_count": hosts}


def create_mesh(mesh_shape: Optional[str] = None,
                devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The mesh of ``mesh_shape`` over ``devices`` (default: the devices
    of the started process group, else every visible device). The spec
    must cover every device, as JAX's ``parse_mesh_shape`` requires, and
    the devices must be the ranks of the process group: one process per
    device."""
    if devices is None:
        devices = _GROUP_DEVICES if dist.is_initialized() else visible_devices()
    devices = [normalise_device(d) for d in devices]
    axes = parse_mesh_shape(mesh_shape, len(devices))
    world = dist.get_world_size() if dist.is_initialized() else 1
    if len(devices) != world:
        raise ValueError(f"mesh {axes} spans {len(devices)} devices, but {world} process(es) "
                         "run: start one process per device (main --mesh_shape, or torchrun)")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local, local_size, _, _ = _local_layout()
    groups = {}
    if dist.is_initialized():
        for axis in ("data", "model"):
            groups[axis] = _axis_group(axes, rank, world, axis)
    return Mesh(axes, rank, world, local, local_size, devices[rank],
                dist.group.WORLD if dist.is_initialized() else None,
                dist.get_backend() if dist.is_initialized() else None,
                groups.get("data"), groups.get("model"))


def _axis_group(axes: Dict[str, int], rank: int, world: int, axis: str):
    """This rank's group along ``axis``: the world where the axis spans
    it, None where it has one rank; else every group of the axis is
    created, on every rank in the same order, and this rank's returned."""
    size = axes.get(axis, 1)
    if size == 1:
        return None
    if size == world:
        return dist.group.WORLD
    mine = None
    seen = set()
    for r in range(world):
        ranks = tuple(axis_ranks(axes, r, axis))
        if ranks in seen:
            continue
        seen.add(ranks)
        g = dist.new_group(list(ranks))
        if rank in ranks:
            mine = g
    return mine


# ---- the rows of a rank

def rank_rows(batch_size: int, accum_steps: int, rank: int, ranks: int) -> np.ndarray:
    """The rows of a host batch of ``batch_size`` that rank ``rank`` of
    ``ranks`` takes: its 1/ranks slice of each of the ``accum_steps``
    micro-blocks, in order. Raises where a micro-batch does not divide
    over the ranks."""
    if batch_size % accum_steps:
        raise ValueError(f"batch {batch_size} is not a multiple of accum_steps {accum_steps}")
    m = batch_size // accum_steps
    if m % ranks:
        raise ValueError(f"a micro-batch of {m} rows (batch {batch_size} / accum_steps "
                         f"{accum_steps}) does not divide over {ranks} ranks")
    per = m // ranks
    return np.concatenate([np.arange(i * m + rank * per, i * m + (rank + 1) * per)
                           for i in range(accum_steps)]).astype(np.int64)


def shard_batch(batch: Dict, mesh: Mesh, accum_steps: int = 1) -> Dict:
    """This rank's rows of a host batch (a dict of numpy arrays or
    tensors; entries without a batch axis are kept whole): those of its
    data coordinate, the same on every rank of its model group."""
    first = next(v for v in batch.values() if getattr(v, "ndim", 0) > 0)
    rows = rank_rows(first.shape[0], accum_steps, mesh.loader_index, mesh.loader_count)
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) == 0:
            out[k] = v
        elif torch.is_tensor(v):
            out[k] = v.index_select(0, to_device(rows, v.device))
        else:
            out[k] = v[rows]
    return out


# ---- the active mesh

@dataclasses.dataclass
class _Active:
    mesh: Mesh
    segments: int  # the local batch is this many blocks of the global one's


_ACTIVE: Optional[_Active] = None


@contextlib.contextmanager
def activate(mesh: Optional[Mesh], segments: int = 1) -> Iterator[None]:
    """Make ``mesh`` the one that BatchNorm, the losses, the metrics and
    the draws reduce over, for the body of the ``with``. ``segments``: the
    model's batch is that many blocks, each of which is this rank's rows
    of a block of the global batch (2 under flip-TTA: the batch and its
    mirror)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _Active(mesh, segments) if mesh is not None and mesh.world_size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Optional[Mesh]:
    """The active mesh when it has more than one rank, else None."""
    return _ACTIVE.mesh if _ACTIVE is not None else None


def data_mesh() -> Optional[Mesh]:
    """The active mesh when its data axis has more than one rank, else
    None: the batch is then split, and batch-level terms reduce."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.data_size > 1 else None


def local_share() -> float:
    """This rank's share of a batch-level term: its rows over the global
    rows (every data rank holds as many), 1 with no data-parallel mesh."""
    mesh = data_mesh()
    return 1.0 if mesh is None else 1.0 / mesh.data_size


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data group of the active mesh,
    differentiable (the backward all-reduces the gradient); ``t`` itself
    with no data-parallel mesh."""
    mesh = data_mesh()
    if mesh is None:
        return t
    return dist_nn.all_reduce(t, group=mesh.data_group)


def draw_rows(draw: Callable[..., torch.Tensor], shape: Sequence[int], dim: int = 0,
              **kwargs) -> torch.Tensor:
    """``draw(shape, **kwargs)`` (``torch.randn``, ``torch.rand``, ...) of
    this rank's rows: under an active mesh the draw is of the global
    batch's shape along ``dim`` and the rank keeps its data coordinate's
    rows (the ranks of a model group draw alike), so every rank's
    generator advances as one process's would."""
    act = _ACTIVE
    if act is None or act.mesh.data_size == 1:
        return draw(tuple(shape), **kwargs)
    n, r, seg = act.mesh.data_size, act.mesh.data_index, act.segments
    shape = list(shape)
    per = shape[dim] // seg
    shape[dim] *= n
    full = draw(tuple(shape), **kwargs)
    if seg == 1:
        return full.narrow(dim, r * per, per).contiguous()
    rows = torch.cat([torch.arange(s * per * n + r * per, s * per * n + (r + 1) * per)
                      for s in range(seg)]).to(full.device)
    return full.index_select(dim, rows)


# ---- parameters and gradients

def broadcast_module(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Every parameter and buffer of ``module`` from rank 0, in place."""
    if mesh is None or mesh.world_size == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=mesh.group)


# the largest bucket of the gradient all-reduce
BUCKET_BYTES = 64 << 20


def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Optional[Mesh],
                     bucket_bytes: int = BUCKET_BYTES) -> Dict[str, float]:
    """Sum the gradients of ``params`` over the data group, in place: each
    bucket of at most ``bucket_bytes`` is flattened into one buffer,
    all-reduced and copied back. Parameters without a
    gradient are left out (the same on every rank: the ranks run one
    code path); a sharded parameter's gradient is its shard's. Returns
    the bytes reduced and the seconds it took."""
    grads = [p.grad for p in params if p.grad is not None]
    if mesh is None or mesh.data_size == 1 or not grads:
        return {"bytes": 0, "seconds": 0.0}
    t0 = time.perf_counter()
    total = 0
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal total
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.data_group)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        total += flat.numel() * flat.element_size()

    for g in grads:
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > bucket_bytes or g.dtype != bucket[0].dtype):
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += nbytes
    if bucket:
        flush()
    if grads[0].device.type == "cuda":
        torch.cuda.synchronize(grads[0].device)
    return {"bytes": total, "seconds": time.perf_counter() - t0}


def gather_rows(t: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """The rows (along ``dim``) of ``t`` from every rank of the data
    group, concatenated in data order (the host batch's order for a step
    without accumulation), on ``t``'s device."""
    if mesh is None or mesh.data_size == 1:
        return t
    src = t.detach().contiguous()
    if mesh.backend == "gloo":  # gloo's all_gather takes no CUDA tensor
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.data_size)]
    dist.all_gather(parts, src, group=mesh.data_group)
    return torch.cat(parts, dim).to(t.device)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.group is not None and mesh.world_size > 1:
        dist.barrier(group=mesh.group)
