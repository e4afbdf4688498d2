"""MPViT's encoders' share of their roofline: the least time their needed
work could take on the card, the larger of its FLOPs over the bf16 peak and
its bytes over the HBM bandwidth (configuration ``mhca``, counted once by
``reference/work.py::mhca_work``), for the traffic's frames of a request,
over ``mhca_ms.eval``'s reading, the encoders' device ms a request."""

from pathlib import Path

from harness import bench


def read(ctx):
    work = ctx["config"].get("mhca")
    if work is None or ctx["peak"] is None:
        return None
    ms = bench._load(Path(__file__).with_name("mhca_ms.eval.py"), "h100bench_metric").read(ctx)
    if not ms:
        return None
    frames = ctx["traffic"]["batch"]
    least_s = max(work["flops_per_frame"] * frames / ctx["peak"]["bf16_flops"],
                  work["bytes_per_frame"] * frames / ctx["peak"]["hbm_bytes_per_s"])
    return 100.0 * least_s / (1e-3 * ms)
