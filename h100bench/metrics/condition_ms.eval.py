"""Mean device time of the condition per request: the program's span
``condition`` (the depth encode, the HAHI neck, the FPN and the condition's
upsampling), CUDA events the program records in the traced slice."""

from harness.program_trace import mean_of


def read(ctx):
    return mean_of(ctx, "condition", lambda s: s.device_ms)
