"""Mean host time of the program's span ``request`` (the eval step, entry
to return, no synchronise) in the traced slice: how long Python takes to
enqueue a whole request, against the traced request's latency."""

from harness.program_trace import mean_of


def read(ctx):
    return mean_of(ctx, "request", lambda s: s.host_ms)
