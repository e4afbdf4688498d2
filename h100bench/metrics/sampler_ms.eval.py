"""Mean device time of the DDIM sampler per request: CUDA events recorded
by a wrapper around the program's head ``_sample`` (all steps, from the
condition to the refined latent)."""


def read(ctx):
    ms = ctx["spans"].get("sampler") if ctx["kind"] == "eval" else None
    return sum(ms) / len(ms) if ms else None
