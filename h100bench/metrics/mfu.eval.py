"""The whole request's share of the card's bf16 peak: the configuration's
frozen forward FLOPs per frame times the frames of the window, over the
window's wall time and the peak of peaks.json."""


def read(ctx):
    if ctx["kind"] != "eval" or not ctx.get("requests") or ctx["peak"] is None:
        return None
    flops = ctx["config"]["flops"]["forward_per_frame"] * ctx["frames"]
    return 100.0 * flops / (ctx["window_s"] * ctx["peak"]["bf16_flops"])
