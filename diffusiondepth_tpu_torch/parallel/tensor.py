"""Tensor parallelism over the mesh's 'model' axis (port of JAX's
``state_sharding``, ``diffusiondepth_tpu/parallel/mesh.py``).

JAX shards a parameter over 'model' when the axis has k > 1 devices, the
parameter has at least two dims and ``min_size`` elements, and its last
(output-feature) axis divides by k; everything else, the batch statistics
and the step stay replicated, and Adam's moments follow their parameter.
GSPMD then places the collectives. The port applies the same rule to each
tensor's JAX-layout shape (``jax_layouts``) and writes its collectives
itself:

* ``state_sharding(state, mesh, min_size)`` -> a ``StateSharding``: for
  each parameter name its ``ShardSpec`` (the torch dim that JAX's last
  axis lands on under ``utils/convert_jax_params.py``: dim 0 of a Linear
  or Conv2d weight, dim 1 of a ConvTranspose2d weight, the last dim of an
  embedding or a bare parameter) or None;
* ``shard_state(state, sharding)`` cuts a whole state into this
  rank's shards in place (JAX's ``device_put``): each sharded parameter
  and its optimizer moments keep chunk j of k along that dim, j the
  rank's model coordinate; ``gather_state_dict`` /
  ``gather_optimizer_state`` give them back whole (``device_get``), and
  ``shard_state_dict`` cuts a whole checkpoint for a sharded model;
* where a layer goes through ``models/common.py``'s ``linear``,
  ``conv2d_nhwc`` (``groups == 1``) or ``conv_transpose2d_nhwc`` with a
  sharded weight, it is column-parallel: each rank computes its output
  features with its shard (``copy_to_model`` then ``gather_from_model``:
  the activations are NHWC, so the features are the last dim), the bias
  is added to the gathered output; in the backward each rank keeps its
  slice of dY and dX is all-reduced over the model group;
* every other reader of a sharded weight (a hand-written kernel that takes
  the whole weight, as K1/K5 do, an embedding table, a grouped conv)
  calls ``whole``: the forward all-gathers the shards over the model
  group, the backward keeps this rank's slice of the whole gradient (the
  model group holds the same rows, so nothing is reduced over 'model').

The ranks of a model group compute everything else alike, on the same
rows; ``sync_whole_grads`` broadcasts the replicated parameters'
gradients from the group's first rank so that their copies stay bit-equal
whatever the order of a backward's atomics.

Collectives on a card go through the device's stream in autograd's order:
under NCCL ``all_gather_into_tensor``; under gloo (ranks sharing a card)
an all-reduce of a zero-filled buffer of the whole size, since gloo's
all_gather takes no CUDA tensor and a host copy inside the backward would
run on the CPU's thread, in an order that differs by rank. ``COMM`` counts
the bytes of each kind of collective (``reset_comm``); with ``TIMED`` set
each collective is synchronised and its seconds are added too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import Mesh

# kind -> [bytes, seconds]: "act_gather" (a column-parallel layer's output,
# bytes of the whole output), "dx_allreduce" (its input gradient),
# "weight_gather" (bytes of the whole weight), "grad_allreduce" (the data
# group's, filled by training/steps.py), "grad_broadcast" (sync_whole_grads)
COMM: Dict[str, List[float]] = {}
TIMED = False


def reset_comm() -> None:
    COMM.clear()
    for kind in ("act_gather", "dx_allreduce", "weight_gather", "grad_allreduce",
                 "grad_broadcast"):
        COMM[kind] = [0, 0.0]


reset_comm()


def count_comm(kind: str, nbytes: int, seconds: float = 0.0) -> None:
    COMM[kind][0] += int(nbytes)
    COMM[kind][1] += seconds


# ---- the rule, on JAX-layout shapes

@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a tensor splits over 'model': ``dim`` is the torch dim that
    JAX's last axis lands on, ``jax_shape`` the JAX shape and ``k`` the
    model size. Rank j of the model group holds chunk j of k along
    ``dim``, contiguous. For flax's (C, heads, head_dim) attention kernels
    JAX cuts head_dim and rank j's chunk holds whole heads instead: a
    column-parallel layer computes the same output whichever of its output
    features a rank owns, and the gathered whole tensor is the same."""

    dim: int
    jax_shape: Tuple[int, ...]
    k: int

    def shard(self, t: torch.Tensor, j: int) -> torch.Tensor:
        """Rank j's shard of the whole tensor ``t``."""
        per = t.shape[self.dim] // self.k
        return t.narrow(self.dim, j * per, per)


def _jax_layout(module: nn.Module, pname: str, p: torch.Tensor):
    """(JAX shape, torch dim of its last axis) of parameter ``pname`` of
    ``module``, the inverse of ``utils/convert_jax_params.py``'s layout
    rules."""
    sh = shard_info(p)
    shape = sh.whole_shape if sh is not None else tuple(p.shape)
    heads = getattr(module, "jax_kernel_heads", None)
    if heads is not None and isinstance(module, nn.Linear):
        # flax MultiHeadDotProductAttention's query/key/value: kernel
        # (C, heads, head_dim), bias (heads, head_dim)
        o = shape[0]
        if pname == "weight":
            return (shape[1], heads, o // heads), 0
        return (heads, o // heads), 0
    if pname == "weight" and isinstance(module, nn.Linear):
        return (shape[1], shape[0]), 0
    if pname == "weight" and isinstance(module, nn.ConvTranspose2d):
        i, o, kh, kw = shape
        return (kh, kw, i, o), 1
    if pname == "weight" and len(shape) == 4:  # Conv2d and the deformable convs: OIHW
        o, i, kh, kw = shape
        return (kh, kw, i, o), 0
    # embeddings, norms, biases and bare parameters keep JAX's layout
    return shape, max(len(shape) - 1, 0)


def jax_layouts(model: nn.Module) -> Dict[str, tuple]:
    """name -> (JAX shape, torch dim) of every parameter."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = _jax_layout(mod, pname, p)
    return out


@dataclasses.dataclass
class StateSharding:
    """The counterpart of JAX's tree of ``NamedSharding``: for each
    parameter name its ``ShardSpec``, None where it is replicated. The
    optimizer moments follow their parameter; buffers and the step count
    are replicated."""

    specs: Dict[str, Optional[ShardSpec]]
    mesh: Mesh

    @property
    def sharded(self) -> List[str]:
        return [n for n, s in self.specs.items() if s is not None]

    def local_numel(self, model: nn.Module) -> int:
        """Elements of the parameters one rank holds once sharded."""
        total = 0
        for n, p in model.named_parameters():
            sh = shard_info(p)
            numel = int(np.prod(sh.whole_shape)) if sh is not None else p.numel()
            total += numel // self.specs[n].k if self.specs.get(n) else numel
        return total


def _model_of(state) -> nn.Module:
    return state if isinstance(state, nn.Module) else state.model


def state_sharding(state, mesh: Mesh, min_size: int = 2**16) -> StateSharding:
    """JAX's rule (``state_sharding``), on each parameter's JAX-layout
    shape: sharded over 'model' when the axis has k > 1 ranks, ndim >= 2,
    at least ``min_size`` elements and the last axis % k == 0. ``state``
    is a ``TrainState`` or a model, whole."""
    model = _model_of(state)
    k = mesh.model_size
    specs: Dict[str, Optional[ShardSpec]] = {}
    for name, (jshape, dim) in jax_layouts(model).items():
        size = int(np.prod(jshape)) if jshape else 1
        if k > 1 and len(jshape) >= 2 and size >= min_size and jshape[-1] % k == 0:
            specs[name] = ShardSpec(dim, jshape, k)
        else:
            specs[name] = None
    return StateSharding(specs, mesh)


# ---- a parameter's shard

@dataclasses.dataclass(eq=False)
class _Shard:
    """What a sharded parameter carries (``p.tp_shard``)."""

    spec: ShardSpec
    index: int  # this rank's model coordinate
    whole_shape: Tuple[int, ...]
    group: Optional[object]
    backend: Optional[str]


def shard_info(t: torch.Tensor) -> Optional[_Shard]:
    return getattr(t, "tp_shard", None)


def is_sharded(model: nn.Module) -> bool:
    return any(shard_info(p) is not None for p in model.parameters())


def _optimizer_of(state):
    return None if isinstance(state, nn.Module) else getattr(state, "optimizer", None)


@torch.no_grad()
def shard_state(state, sharding: StateSharding) -> None:
    """Cut a whole ``TrainState`` (or model) into this rank's shards in
    place: each parameter of ``sharding`` keeps its chunk of the model
    coordinate, and so do its optimizer moments; its gradient is dropped.
    Every rank must hold the same whole state (broadcast it first)."""
    model, opt = _model_of(state), _optimizer_of(state)
    mesh = sharding.mesh
    params = dict(model.named_parameters())
    for name, spec in sharding.specs.items():
        p = params[name]
        if spec is None or shard_info(p) is not None:
            continue
        whole_shape = tuple(p.shape)
        p.data = spec.shard(p.data, mesh.model_index).clone()
        p.grad = None
        p.tp_shard = _Shard(spec, mesh.model_index, whole_shape, mesh.model_group,
                            mesh.backend)
        if opt is not None:
            for key, v in opt.state.get(p, {}).items():
                if torch.is_tensor(v) and tuple(v.shape) == whole_shape:
                    opt.state[p][key] = spec.shard(v, mesh.model_index).clone()


def check_sharded_as(model: nn.Module, sharding: StateSharding) -> None:
    """Raise unless ``model``'s parameters are cut as ``sharding`` says."""
    for name, p in model.named_parameters():
        spec, sh = sharding.specs.get(name), shard_info(p)
        if (spec is None) != (sh is None) or (sh is not None and sh.spec != spec):
            raise ValueError(f"{name}: the model is not sharded as state_shardings says "
                             "(call shard_state first)")


# ---- collectives over the model group

def _sync(t: torch.Tensor) -> None:
    if TIMED and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _all_gather(x: torch.Tensor, sh: _Shard) -> torch.Tensor:
    """(k, *x.shape): every model rank's ``x``, in model order."""
    k = sh.spec.k
    x = x.contiguous()
    if sh.backend == "nccl":
        out = x.new_empty((k,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x, group=sh.group)
        return out
    if x.device.type == "cpu":
        parts = [torch.empty_like(x) for _ in range(k)]
        dist.all_gather(parts, x, group=sh.group)
        return torch.stack(parts)
    # gloo on a card: each rank fills its slot of a zero buffer, one sum
    out = x.new_zeros((k,) + tuple(x.shape))
    out[sh.index] = x
    dist.all_reduce(out, group=sh.group)
    return out


def _gather_along(x: torch.Tensor, dim: int, sh: _Shard, kind: str) -> torch.Tensor:
    """The whole tensor from every model rank's shard ``x`` along ``dim``."""
    _sync(x)
    t0 = time.perf_counter()
    parts = _all_gather(x, sh)
    whole = torch.cat(parts.unbind(0), dim)
    _sync(whole)
    count_comm(kind, whole.numel() * whole.element_size(), time.perf_counter() - t0)
    return whole


def _take(g: torch.Tensor, dim: int, sh: _Shard) -> torch.Tensor:
    """This rank's chunk of the whole ``g`` along ``dim``."""
    per = g.shape[dim] // sh.spec.k
    return g.narrow(dim, sh.index * per, per).contiguous()


class _CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: the identity forward; the
    backward sums dX over the model group."""

    @staticmethod
    def forward(ctx, x, sh):
        ctx.sh = sh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same gradient tensor to another
        # branch (the two inputs of an add), which the in-place sum would
        # change
        g = g.clone(memory_format=torch.contiguous_format)
        _sync(g)
        t0 = time.perf_counter()
        dist.all_reduce(g, group=ctx.sh.group)
        _sync(g)
        count_comm("dx_allreduce", g.numel() * g.element_size(), time.perf_counter() - t0)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The output of a column-parallel layer: every rank's features
    gathered along the last dim; the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, y, sh):
        ctx.sh = sh
        return _gather_along(y, y.ndim - 1, sh, "act_gather")

    @staticmethod
    def backward(ctx, g):
        return _take(g, g.ndim - 1, ctx.sh), None


class _WeightGather(torch.autograd.Function):
    """A sharded weight made whole: all-gathered over the model group; the
    backward keeps this rank's slice of the whole gradient."""

    @staticmethod
    def forward(ctx, w, sh):
        ctx.sh = sh
        return _gather_along(w, sh.spec.dim, sh, "weight_gather")

    @staticmethod
    def backward(ctx, g):
        return _take(g, ctx.sh.spec.dim, ctx.sh), None


def whole(p: torch.Tensor) -> torch.Tensor:
    """``p`` itself, or its whole tensor where it is a shard (the
    weight-gather route), differentiable."""
    sh = shard_info(p)
    return p if sh is None else _WeightGather.apply(p, sh)


def copy_to_model(x: torch.Tensor, sh: _Shard) -> torch.Tensor:
    return _CopyToModel.apply(x, sh)


def gather_from_model(y: torch.Tensor, sh: _Shard) -> torch.Tensor:
    return _GatherFromModel.apply(y, sh)


# ---- gradients, checkpoints

@torch.no_grad()
def sync_whole_grads(params, mesh: Optional[Mesh]) -> None:
    """Broadcast the gradients of the replicated (not sharded) parameters
    from the first rank of the model group, in one flat buffer per dtype."""
    if mesh is None or mesh.model_size == 1 or mesh.model_group is None:
        return
    grads = [p.grad for p in params if p.grad is not None and shard_info(p) is None]
    if not grads:
        return
    src = mesh.model_ranks()[0]
    t0 = time.perf_counter()
    for dt in sorted({g.dtype for g in grads}, key=str):
        bucket = [g for g in grads if g.dtype == dt]
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.broadcast(flat, src, group=mesh.model_group)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        count_comm("grad_broadcast", flat.numel() * flat.element_size())
    if grads[0].device.type == "cuda":
        torch.cuda.synchronize(grads[0].device)
    COMM["grad_broadcast"][1] += time.perf_counter() - t0


@torch.no_grad()
def _whole_value(t: torch.Tensor, sh: _Shard) -> torch.Tensor:
    parts = _all_gather(t.detach(), sh)
    return torch.cat(parts.unbind(0), sh.spec.dim)


def whole_like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``t`` (a gradient or a moment of ``p``'s shape) made whole as ``p``
    is sharded: a collective over the model group; ``t`` where ``p`` is
    whole."""
    sh = shard_info(p)
    return t if sh is None else _whole_value(t, sh)


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard made whole (a collective
    over the model group where the model is sharded: every rank of the
    group calls it)."""
    sd = model.state_dict()
    for name, p in model.named_parameters():
        sh = shard_info(p)
        if sh is not None:
            sd[name] = _whole_value(p, sh)
    return sd


def gather_optimizer_state(optimizer) -> Dict:
    """``optimizer.state_dict()`` with the moments of sharded parameters
    made whole (collective, as ``gather_state_dict``)."""
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, st in sd["state"].items():
        sh = shard_info(params[i])
        if sh is None:
            continue
        sd["state"][i] = {k: _whole_value(v, sh) if torch.is_tensor(v) and v.ndim else v
                          for k, v in st.items()}
    return sd


def shard_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to this rank's shards of ``model``."""
    out = dict(sd)
    for name, p in model.named_parameters():
        sh = shard_info(p)
        if sh is not None and name in out and tuple(out[name].shape) == sh.whole_shape:
            out[name] = sh.spec.shard(out[name], sh.index)
    return out


def shard_optimizer_state(optimizer, sd: Dict) -> Dict:
    """A whole optimizer state dict cut to this rank's shards."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    out = dict(sd, state=dict(sd["state"]))
    for i, st in sd["state"].items():
        sh = shard_info(params[int(i)])
        if sh is None:
            continue
        out["state"][i] = {k: sh.spec.shard(v, sh.index)
                           if torch.is_tensor(v) and tuple(v.shape) == sh.whole_shape else v
                           for k, v in st.items()}
    return out
