"""Mean number of copies of host data to the card per request: the change
of the program's counter ``h2d_copies`` over its span ``request`` in the
traced slice."""

from harness.program_trace import mean_of


def read(ctx):
    return mean_of(ctx, "request", lambda s: s.counters.get("h2d_copies"))
