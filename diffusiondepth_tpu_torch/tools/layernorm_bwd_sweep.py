"""Time K10 (``csrc/layernorm_bwd.cu``) on the card under other plans than
``layernorm_bwd_plan``'s, and split a call's device time between its main
kernel and its column reduce (``torch.profiler``); then K10's ring against
its wide variant, and K9's one-program row against its looped variant
(``csrc/layernorm.py``), at widths around where each switches. Needs one
CUDA card:

    python -m diffusiondepth_tpu_torch.tools.layernorm_bwd_sweep

Prints one JSON line per (shape, plan) and per shape's split, one per
width of the variant comparisons, then the host's cost of one eager call
by part. Times are CUDA-graph replays of 100 calls (ms per call), the way
``chip_smoke.py`` times K9 and K10.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from ..ops import layernorm as ln
from ..ops import native

SHAPES = ((1276, 1536), (1276, 3072), (5016, 768), (5016, 1536), (20064, 384),
          (20064, 768), (79904, 192))


def graph_ms(fn, n=100, reps=3) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


def launcher(x2, dy2, mean, inv, scale, plan):
    """A call of the C launch function under ``plan`` (x2's width a
    multiple of 8), into fresh outputs; returns (fn, dx, dsdb)."""
    m, c = x2.shape
    dx = torch.empty_like(x2)
    part = torch.empty((plan.ctas, 2, c), dtype=torch.float32, device=x2.device)
    dsdb = torch.empty((2, c), dtype=torch.float32, device=x2.device)

    def fn():
        native.check(ln.layernorm_bwd_launch(plan, x2, dy2, mean, inv, scale, c, dx, dsdb, part),
                     "layernorm_bwd")
    return fn, dx, dsdb


def _inputs(g, m, c):
    dev = g.device
    x2 = (torch.randn(m, c, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    dy2 = torch.randn(m, c, generator=g, device=dev).to(torch.bfloat16)
    scale = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    _, mean, inv = ln.layernorm_fwd(x2, scale, torch.zeros_like(scale), 1e-5)
    return x2, dy2, scale, mean, inv


def compare_variants(g, sms):
    """K10's ring against its wide variant where both hold a row (pitch <=
    4096), and K9's one-program row against its looped variant up to
    16384 columns: ms of each, the bound (bytes at 3.35 TB/s), and whether
    the two give the same y, mean, inv (K9) or dx within one bf16 step and
    dscale within 1e-3 (K10)."""
    for m, c in ((2048, 2048), (1024, 3072), (1024, 4096)):
        x2, dy2, scale, mean, inv = _inputs(g, m, c)
        ring = ln.layernorm_bwd_plan(m, c, sms)
        wide = ring._replace(rows_per_stage=1, stages=0, threads_per_row=ln.LN_BWD_WIDE_THREADS,
                             vectors_per_thread=-(-c // 8 // ln.LN_BWD_WIDE_THREADS),
                             ring_offset=0, stage_bytes=0, dy_offset=0, smem_bytes=0,
                             variant="wide")
        (f_r, dx_r, s_r), (f_w, dx_w, s_w) = (launcher(x2, dy2, mean, inv, scale, p)
                                              for p in (ring, wide))
        f_r()
        f_w()
        torch.cuda.synchronize()
        print(json.dumps({"k10": [m, c], "ring_ms": graph_ms(f_r), "wide_ms": graph_ms(f_w),
                          "bound_ms": 1e3 * (6 * m * c + 8 * m + 12 * c) / 3.35e12,
                          "dx_err": (dx_r.float() - dx_w.float()).abs().max().item(),
                          "dsdb_rel_err": ((s_r - s_w).abs().max() / s_r.abs().max()).item()}),
              flush=True)
    k9 = native.triton_module("layernorm")
    for m, c in ((1024, 3080), (1024, 4100), (1024, 8192), (512, 9000), (512, 16384)):
        x2, _, scale, _, _ = _inputs(g, m, c)
        bias = 0.1 * torch.ones_like(scale)
        outs, ms = {}, {}
        for wide in (False, True):
            y = torch.empty_like(x2)
            st = torch.empty(2, m, device=x2.device)

            def fn(wide=wide, y=y, st=st):
                k9.fwd_launch(x2, scale, bias, 1e-5, y, st[0], st[1], wide=wide)
            fn()
            outs[wide] = (y, st)
            ms["wide_ms" if wide else "one_program_ms"] = graph_ms(fn)
        torch.cuda.synchronize()
        print(json.dumps({"k9": [m, c], **ms, "bound_ms": 1e3 * (4 * m * c + 8 * m + 8 * c)
                          / 3.35e12, "same_y": bool(torch.equal(outs[False][0], outs[True][0])),
                          "stats_rel_err": ((outs[False][1] - outs[True][1]).abs()
                                            / outs[False][1].abs()).max().item()}), flush=True)


def _device_ctx(dev):
    def fn():
        with torch.cuda.device(dev):
            pass
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("layernorm_bwd_sweep needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, c in SHAPES:
        x2, dy2, scale, mean, inv = _inputs(g, m, c)
        p = ln.layernorm_bwd_plan(m, c, sms)
        tpr = p.threads_per_row
        ref_fn, ref_dx, _ = launcher(x2, dy2, mean, inv, scale, p)
        ref_fn()
        # the split of one call between the two kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                ref_fn()
            torch.cuda.synchronize()
        split = {e.key[:40]: e.self_device_time_total / e.count / 1e3
                 for e in prof.key_averages() if e.self_device_time_total > 0}
        # the same bytes through PyTorch's elementwise add: x and dy read, one
        # bf16 (M, C) written, as K10 reads and writes
        out = torch.empty_like(x2)
        add_ms = graph_ms(lambda: torch.add(x2, dy2, out=out))
        print(json.dumps({"shape": [m, c], "plan": [p.ctas, p.rows_per_stage, p.stages, tpr],
                          "plan_ms": graph_ms(ref_fn), "split_ms": split, "add_ms": add_ms}),
              flush=True)
        variants = [(min(sms // 2, m), p.rows_per_stage, p.stages)]
        for k in (1, 2):
            for s in (2, 3, 4, 6):
                variants.append((min(sms, m), ln.LN_BWD_CONSUMERS // tpr * k, s))
        for ctas, r, s in variants:
            smem = ln.layernorm_bwd_smem_bytes(r, s, c, tpr)
            if smem > ln.LN_BWD_SMEM_LIMIT:
                continue
            fn, dx, _ = launcher(x2, dy2, mean, inv, scale,
                                 p._replace(ctas=ctas, rows_per_stage=r, stages=s,
                                            smem_bytes=smem))
            fn()
            torch.cuda.synchronize()
            print(json.dumps({"shape": [m, c], "ctas": ctas, "R": r, "S": s, "ms": graph_ms(fn),
                              "dx_equal": bool(torch.equal(dx, ref_dx))}), flush=True)
    compare_variants(g, sms)
    # the host's cost of one eager call at (5016, 768), by part (no sync)
    m, c = 5016, 768
    x2 = torch.randn(m, c, device=dev).to(torch.bfloat16)
    mean = torch.zeros(m, device=dev)
    scale = torch.ones(c, device=dev)
    n = 2000
    parts = {
        "call": lambda: ln.layernorm_bwd(x2, x2, mean, mean, scale),
        "check_tensors": lambda: native.check_tensors("k", ((x2, (m, c), torch.bfloat16),
                                                             (mean, (m,), torch.float32)),
                                                      x2.device),
        "empty_x3": lambda: [torch.empty_like(x2), torch.empty((2, c), device=dev),
                             torch.empty((132, 2, c), device=dev)],
        "cuda_device_ctx": _device_ctx(x2.device),
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
    }
    host = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"host_us_per_call": host}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
