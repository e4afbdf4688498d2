"""Mean device time of the backbone's forward per request: CUDA events
recorded by forward hooks on the program's ``model.depth_backbone``."""


def read(ctx):
    ms = ctx["spans"].get("backbone") if ctx["kind"] == "eval" else None
    return sum(ms) / len(ms) if ms else None
