"""Mean host time of the program's span ``backbone`` per request in the
traced slice: how long Python takes to enqueue the backbone. Read beside
``backbone_ms.eval``, its device time: host at or above device means the
backbone is launch-bound."""

from harness.program_trace import mean_of


def read(ctx):
    return mean_of(ctx, "backbone", lambda s: s.host_ms)
