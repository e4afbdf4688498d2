"""Frames completed over the whole window's wall time (host clock)."""

from harness.stats import rate


def read(ctx):
    if ctx["kind"] != "eval" or not ctx.get("requests"):
        return None
    return rate(ctx["frames"], ctx["window_s"])
