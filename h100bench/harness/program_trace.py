"""The program's own spans over the traced slice: the records of
``diffusiondepth_tpu_torch.trace``, which the program keeps for the last
``torch.profiler`` session (the traced slice is the run's last). A program
without that tracer, or a run without a traced slice, gives None, and the
metrics that read it are left out of the line."""

from __future__ import annotations

import importlib
from typing import Callable, List, Optional


def spans(ctx) -> Optional[list]:
    if ctx["kind"] != "eval" or not ctx.get("trace"):
        return None
    try:
        tracer = importlib.import_module("diffusiondepth_tpu_torch.trace")
    except ImportError:
        return None
    return tracer.spans()


def mean_of(ctx, name: str, value: Callable) -> Optional[float]:
    """The mean of ``value(span)`` over the program's spans called
    ``name`` in the traced slice (one a request for the eval path's
    spans), or None where there is none."""
    records = spans(ctx)
    values: List[float] = [value(s) for s in records or () if s.name == name]
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None
