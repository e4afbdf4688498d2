"""Summary writers (port of ``diffusiondepth_tpu/summary``): the text epoch
logs ``loss_{mode}.txt`` / ``metric_{mode}.txt`` in the reference's line
format, ``scalars_{mode}.jsonl``, TensorBoard event files, epoch panels and
per-sample files (KITTI submission PNGs); NLSPN's adds its gamma scalar,
confidence panel and propagation dumps."""

from __future__ import annotations

from .diffusion_dcbase_summary import Diffusion_DCbase_Summary
from .nlspn_summary import NLSPNSummary


def get(args):
    """The summary class of ``args.model_name`` (``<model_name>Summary``)."""
    name = args.model_name + "Summary"
    if name in ("Diffusion_DCbase_Summary", "Diffusion_DCx4base_Summary"):
        return Diffusion_DCbase_Summary
    if name == "NLSPNSummary":
        return NLSPNSummary
    raise NotImplementedError(name)


__all__ = ["get", "Diffusion_DCbase_Summary", "NLSPNSummary"]
