"""The 90th percentile (nearest rank) of every request's latency in the
window, from submission to the synchronised result (host clock)."""

from harness.stats import percentile


def read(ctx):
    if ctx["kind"] != "eval" or not ctx.get("latency_s"):
        return None
    return 1e3 * percentile(ctx["latency_s"], 90)
