"""Eval step factory (port of ``make_eval_step`` in
``diffusiondepth_tpu/training/steps.py``, without flip-TTA). The train step
is the next slice."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..metrics.depth_metrics import evaluate_depth_metrics


def make_eval_step(model) -> Callable:
    """Returns ``eval_step(batch, generator=None, init_latent=None) ->
    (pred, metric_row, extras)``.

    Runs the model in eval mode under ``torch.no_grad`` on the device its
    parameters live on (the batch's tensors must be there too). The starting
    latent comes from ``generator`` (a ``torch.Generator`` on that device)
    unless ``init_latent`` fixes it. No ddim_loss is computed at eval.
    ``extras`` is empty: no output of this slice's model needs it."""
    model.eval()

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  init_latent: Optional[torch.Tensor] = None):
        out = model(batch, init_latent=init_latent, generator=generator)
        metric_val = evaluate_depth_metrics(batch, out)
        return out["pred"], metric_val, {}

    return eval_step
