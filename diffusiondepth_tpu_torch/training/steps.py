"""Train and eval step factories (port of
``diffusiondepth_tpu/training/steps.py``).

Loss normalisation is the JAX package's: the per-sample masked losses are
summed over the batch and the sum is divided by the global batch size, so
with accumulation the summed micro-batch gradients are divided by the
global batch once, before the single optimizer update.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..metrics.depth_metrics import evaluate_depth_metrics


def make_train_step(model, loss_computer, optimizer, accum_steps: int = 1) -> Callable:
    """Returns ``train_step(batch, generator=None) -> (loss, loss_val,
    metric_val)``.

    Runs the model in training mode on the device its parameters live on
    (the batch too): BatchNorm on batch statistics, drop-path and the DDIM
    draws from ``generator`` (a ``torch.Generator`` on that device), the
    self-diffusion ``ddim_loss``. ``accum_steps`` > 1 splits the batch
    into that many micro-batches, runs them one after the other (the
    BatchNorm running statistics are updated by each in turn) and
    accumulates their gradients before one optimizer step."""

    def micro(mb: Dict[str, torch.Tensor], generator):
        out = model(mb, generator=generator)
        loss_sum, loss_val = loss_computer(mb, out)
        return loss_sum, loss_val, out["pred"]

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        batch_size = batch["rgb"].shape[0]
        if accum_steps > 1:
            if batch_size % accum_steps:
                raise ValueError(f"batch {batch_size} is not a multiple of {accum_steps}")
            m = batch_size // accum_steps
            loss_sum, loss_val, preds = 0.0, 0.0, []
            for i in range(accum_steps):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                l_sum, lval, pred = micro(mb, generator)
                l_sum.backward()
                loss_sum = loss_sum + l_sum.detach()
                loss_val = loss_val + lval.detach()
                preds.append(pred.detach())
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(batch_size)
            pred = torch.cat(preds)
        else:
            loss_sum, loss_val, pred = micro(batch, generator)
            (loss_sum / batch_size).backward()
            loss_sum, loss_val, pred = loss_sum.detach(), loss_val.detach(), pred.detach()
        optimizer.step()
        with torch.no_grad():
            metric_val = evaluate_depth_metrics(batch, {"pred": pred})
        return loss_sum / batch_size, loss_val / batch_size, metric_val

    return train_step


def _hflip_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mirror every 4-D (NHWC) entry along W, the TTA flip."""
    return {k: torch.flip(v, dims=(2,)) if torch.is_tensor(v) and v.ndim == 4 else v
            for k, v in batch.items()}


def make_eval_step(model, tta_flip: bool = False, extra_keys: Sequence[str] = ()) -> Callable:
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
    mirror. The metric row is computed on the original batch."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  init_latent: Optional[torch.Tensor] = None):
        model.eval()  # a train step between two eval steps puts it in training mode
        if tta_flip:
            b = batch["rgb"].shape[0]
            flipped = _hflip_batch(batch)
            both = {k: torch.cat([v, flipped[k]]) if torch.is_tensor(v) and v.ndim >= 1 else v
                    for k, v in batch.items()}
            if init_latent is not None and init_latent.shape[0] != 2 * b:
                raise ValueError(f"flip-TTA runs a batch of {2 * b}: init_latent has "
                                 f"{init_latent.shape[0]} rows")
            out = model(both, init_latent=init_latent, generator=generator)
            out = dict(out, pred=0.5 * (out["pred"][:b] + torch.flip(out["pred"][b:], dims=(2,))))
        else:
            out = model(batch, init_latent=init_latent, generator=generator)
        metric_val = evaluate_depth_metrics(batch, out)
        extras = {k: out[k] for k in extra_keys if out.get(k) is not None}
        return out["pred"], metric_val, extras

    return eval_step
