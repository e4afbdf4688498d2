"""Train and eval step factories (port of
``diffusiondepth_tpu/training/steps.py``).

Loss normalisation is the JAX package's: the per-sample masked losses are
summed over the batch and the sum is divided by the global batch size, so
with accumulation the summed micro-batch gradients are divided by the
global batch once, before the single optimizer update.

With a data-parallel ``mesh`` (``parallel/mesh.py``) each rank steps on its
rows of the global batch (``shard_batch``, or the loader's rank slice)
with the mesh active: BatchNorm, the batch-level loss terms, the metrics
and the draws are the global batch's. The gradients are summed over the
ranks in one bucketed all-reduce after the accumulation and divided by
the global batch, and every rank applies the same optimizer update; the
loss and its row are all-reduced. JAX's ``data`` axis computes the same
(``diffusiondepth_tpu/training/steps.py``); the port reduces by hand
rather than through ``DistributedDataParallel``, which averages where JAX
sums and divides by the global batch, hooks ``forward`` and wants every
parameter used.

With a 'model' axis the batch is split over 'data' only: the ranks of a
model group step on the same rows, and the all-reduce runs over the data
group. ``state_shardings`` (``parallel.state_sharding``, the model cut by
``parallel.shard_state``) keeps each sharded parameter and its optimizer
moments as this rank's shard through the update, as JAX's jit does with
its ``in_shardings``: a sharded layer computes only its shard's outputs
(``parallel/tensor.py``), its gradient is this rank's slice of the whole
one, and the optimizer's elementwise update runs on the shards. The
replicated parameters' gradients are then broadcast over the model group,
so that its copies stay bit-equal.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..metrics.depth_metrics import evaluate_depth_metrics
from ..parallel.mesh import Mesh, activate, all_reduce_grads, all_reduce_sum, gather_rows
from ..parallel.tensor import COMM, StateSharding, check_sharded_as, sync_whole_grads
from ..trace import span


def make_train_step(model, loss_computer, optimizer, accum_steps: int = 1,
                    mesh: Optional[Mesh] = None,
                    state_shardings: Optional[StateSharding] = None) -> Callable:
    """Returns ``train_step(batch, generator=None) -> (loss, loss_val,
    metric_val)``.

    Runs the model in training mode on the device its parameters live on
    (the batch too): BatchNorm on batch statistics, drop-path and the DDIM
    draws from ``generator`` (a ``torch.Generator`` on that device), the
    self-diffusion ``ddim_loss``. ``accum_steps`` > 1 splits the batch
    into that many micro-batches, runs them one after the other (the
    BatchNorm running statistics are updated by each in turn) and
    accumulates their gradients before one optimizer step.

    Under ``mesh`` the batch is this rank's rows and every rank calls the
    step with a generator seeded alike; the returned loss, loss row and
    metric row are the global batch's, and ``train_step.comm`` holds the
    last step's gradient all-reduce over the data group (bytes, seconds).
    ``state_shardings``: the model is sharded so (module docstring)."""
    world = 1 if mesh is None else mesh.data_size
    if state_shardings is not None:
        check_sharded_as(model, state_shardings)

    def reduce_grads():
        params = list(model.parameters())
        comm = all_reduce_grads(params, mesh)
        COMM["grad_allreduce"][0] += comm["bytes"]
        COMM["grad_allreduce"][1] += comm["seconds"]
        sync_whole_grads(params, mesh)
        return comm

    def micro(mb: Dict[str, torch.Tensor], generator):
        out = model(mb, generator=generator)
        loss_sum, loss_val = loss_computer(mb, out)
        return loss_sum, loss_val, out["pred"]

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        with activate(mesh):
            return _step(batch, generator)

    def _step(batch, generator):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        batch_size = batch["rgb"].shape[0] * world  # the global batch
        if accum_steps > 1:
            if batch["rgb"].shape[0] % accum_steps:
                raise ValueError(f"batch {batch['rgb'].shape[0]} is not a multiple of "
                                 f"{accum_steps}")
            m = batch["rgb"].shape[0] // accum_steps
            loss_sum, loss_val, preds = 0.0, 0.0, []
            for i in range(accum_steps):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                l_sum, lval, pred = micro(mb, generator)
                l_sum.backward()
                loss_sum = loss_sum + l_sum.detach()
                loss_val = loss_val + lval.detach()
                preds.append(pred.detach())
            train_step.comm = reduce_grads()
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(batch_size)
            pred = torch.cat(preds)
        else:
            loss_sum, loss_val, pred = micro(batch, generator)
            (loss_sum / batch_size).backward()
            train_step.comm = reduce_grads()
            loss_sum, loss_val, pred = loss_sum.detach(), loss_val.detach(), pred.detach()
        optimizer.step()
        with torch.no_grad():
            metric_val = evaluate_depth_metrics(batch, {"pred": pred})
            loss_sum, loss_val = all_reduce_sum(loss_sum), all_reduce_sum(loss_val)
        return loss_sum / batch_size, loss_val / batch_size, metric_val

    train_step.comm = {"bytes": 0, "seconds": 0.0}
    return train_step


def _gather_extra(v: torch.Tensor, rows: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's rows of an output entry: (B, ...) entries along axis
    0, the stacked (T, B, ...) ones (NLSPN's ``pred_inter``) along axis 1,
    entries without a batch axis (``gamma``) as they are."""
    if v.ndim >= 1 and v.shape[0] == rows:
        return gather_rows(v, mesh, 0)
    if v.ndim >= 2 and v.shape[1] == rows:
        return gather_rows(v, mesh, 1)
    return v


def _hflip_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mirror every 4-D (NHWC) entry along W, the TTA flip."""
    return {k: torch.flip(v, dims=(2,)) if torch.is_tensor(v) and v.ndim == 4 else v
            for k, v in batch.items()}


def make_eval_step(model, tta_flip: bool = False, extra_keys: Sequence[str] = (),
                   mesh: Optional[Mesh] = None, gather: bool = False) -> Callable:
    """Returns ``eval_step(batch, generator=None, init_latent=None) ->
    (pred, metric_row, extras)``.

    Puts the model in eval mode at each call and runs it under
    ``torch.no_grad`` on the device its parameters live on (the batch's
    tensors must be there too). The starting
    latent comes from ``generator`` (a ``torch.Generator`` on that device)
    unless ``init_latent`` fixes it. No ddim_loss is computed at eval.
    ``extras`` holds the model output's entries named in ``extra_keys``
    (NLSPN's propagation internals for its summary, ``SAVE_KEYS``); a key
    the output lacks, or holds as None, is left out.

    ``tta_flip=True`` is the leaderboard protocol's flip ensemble: every
    entry of the batch is concatenated with its mirror along W (entries
    that are not images with themselves) into one batch of 2B, and
    pred = (pred[:B] + flip(pred[B:])) / 2. A given ``init_latent`` must
    then have 2B rows, the first B for the batch and the rest for its
    mirror. The metric row is computed on the original batch.

    Under ``mesh`` the batch (and a given ``init_latent``) is this rank's
    rows; the starting latent is this rank's rows of the global batch's
    draw (under flip-TTA, of the global batch and of its mirror), the
    metric row is the global batch's, and with ``gather`` pred and the
    extras are every data rank's rows in data order (the host batch's).
    A model sharded by ``parallel.shard_state`` runs its sharded layers as
    training does; the result is the whole state's (JAX replicates the
    state for eval).

    Under a ``torch.profiler`` session a call records the spans of
    ``trace.py``: ``request`` around it all, and the model's own inside."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  init_latent: Optional[torch.Tensor] = None):
        with span("request"):
            with span("eval_mode"):  # a walk over every module: milliseconds on the host
                model.eval()  # a train step between two eval steps puts it in training mode
            with activate(mesh, segments=2 if tta_flip else 1):
                if tta_flip:
                    b = batch["rgb"].shape[0]
                    flipped = _hflip_batch(batch)
                    both = {k: torch.cat([v, flipped[k]]) if torch.is_tensor(v) and v.ndim >= 1
                            else v for k, v in batch.items()}
                    if init_latent is not None and init_latent.shape[0] != 2 * b:
                        raise ValueError(f"flip-TTA runs a batch of {2 * b}: init_latent has "
                                         f"{init_latent.shape[0]} rows")
                    out = model(both, init_latent=init_latent, generator=generator)
                    out = dict(out, pred=0.5 * (out["pred"][:b]
                                                + torch.flip(out["pred"][b:], dims=(2,))))
                else:
                    out = model(batch, init_latent=init_latent, generator=generator)
                with span("metrics"):
                    metric_val = evaluate_depth_metrics(batch, out)
            extras = {k: out[k] for k in extra_keys if out.get(k) is not None}
            pred = out["pred"]
            if gather:
                b = pred.shape[0]
                pred = gather_rows(pred, mesh)
                extras = {k: _gather_extra(v, b, mesh) for k, v in extras.items()}
            return pred, metric_val, extras

    return eval_step
