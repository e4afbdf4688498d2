"""The sampler's share of its roofline: the least time its needed work could
take on the card, the larger of its FLOPs over the bf16 peak and its bytes
over the HBM bandwidth (configuration ``sampler``, counted once by the
benchmark's reference), over the measured ``sampler`` span. It counts the
work the algorithm needs, so it reads alike whatever implements the sampler."""


def read(ctx):
    ms = ctx["spans"].get("sampler") if ctx["kind"] == "eval" else None
    if not ms or ctx["peak"] is None:
        return None
    frames = ctx["traffic"]["batch"]
    s = ctx["config"]["sampler"]
    least_s = max(s["flops_per_frame"] * frames / ctx["peak"]["bf16_flops"],
                  s["bytes_per_frame"] * frames / ctx["peak"]["hbm_bytes_per_s"])
    return 100.0 * least_s / (1e-3 * sum(ms) / len(ms))
