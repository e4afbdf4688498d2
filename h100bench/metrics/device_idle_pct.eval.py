"""Share of the traced slice's wall time in which no device operation ran:
one minus the union of the kernel, copy and set intervals of the
``torch.profiler`` trace over the slice."""


def read(ctx):
    t = ctx["trace"]
    if ctx["kind"] != "eval" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
