"""The port's tracer (``diffusiondepth_tpu_torch/trace.py``): the spans of
the eval path under a ``torch.profiler`` session, nothing without one, the
counters' deltas on the spans, and the exporter's events; on the card
(marked ``cuda``: they skip without a CUDA device), the clock of the
profiler's trace, the host-to-card copies of a request at the benchmark's
shapes against the trace's copies, and a span's device time against CUDA
events. On a machine with a card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffusiondepth_tpu_torch import Config, build_model, make_eval_step, trace
from diffusiondepth_tpu_torch.diffusion.ddim import DDIMSchedule
from diffusiondepth_tpu_torch.ops import native
from diffusiondepth_tpu_torch.ops.resize import resize_bilinear
from diffusiondepth_tpu_torch.tools import analyze_trace

STEPS = 3
# family -> (backbone_module, backbone_name, head, head_in_channels)
MICRO = {
    "swin": ("swin", "swin_micro", "DDIMDepthEstimate_Swin_ADDHAHI", [32, 64, 128, 256]),
    "res18": ("mmbev_resnet", "mmbev_res18", "DDIMDepthEstimate_Res", None),
}
# name -> parent of every span of the eval path
TREE = {"request": None, "eval_mode": "request", "backbone": "request",
        **{f"backbone.stage{i}": "backbone" for i in range(4)},
        "condition": "request", "condition.encode": "condition", "condition.neck": "condition",
        "condition.fpn": "condition", "condition.upsample": "condition",
        "sampler": "request", "sampler.tables": "sampler", "sampler.step": "sampler",
        "sampler.denoise": "sampler.step", "sampler.update": "sampler.step",
        "decode": "request", "metrics": "request"}


def micro_step(family):
    module, name, head, channels = MICRO[family]
    cfg = Config(model_name="Diffusion_DCbase_", backbone_module=module, backbone_name=name,
                 head_specify=head, inference_steps=STEPS,
                 **({"head_in_channels": channels} if channels else {})).finalize()
    return make_eval_step(build_model(cfg, device="cpu"))


def micro_batch(b=2, h=64, w=96):
    g = torch.Generator().manual_seed(0)
    return {"rgb": torch.randn(b, h, w, 3, generator=g),
            "gt": torch.rand(b, h, w, 1, generator=g) * 8 + 1}


@pytest.fixture(scope="module")
def traced():
    """family -> (spans of one profiled eval step, the counters' change
    over the call); one warm call before each."""
    out = {}
    for family in MICRO:
        step, batch = micro_step(family), micro_batch()
        step(batch, generator=torch.Generator().manual_seed(1))
        before = trace.counts()
        with profile(activities=[ProfilerActivity.CPU]):
            step(batch, generator=torch.Generator().manual_seed(1))
        after = trace.counts()
        out[family] = (trace.spans(), {k: after[k] - before[k] for k in after})
    return out


@pytest.mark.parametrize("family", sorted(MICRO))
def test_eval_step_span_tree(traced, family):
    """One request; every span of the eval path under its parent, inside
    its parent's interval, in the request's id; one ``sampler.step`` (with
    one denoise and one update) a DDIM step; the four backbone stages;
    the HAHI neck only where the head has one."""
    spans, _ = traced[family]
    names = [s.name for s in spans]
    assert names.count("request") == 1 and spans[0].name == "request"
    assert names.count("sampler.step") == STEPS
    assert names.count("sampler.denoise") == names.count("sampler.update") == STEPS
    assert ("condition.neck" in names) == (family == "swin")
    assert set(TREE) - {"condition.neck"} <= set(names) <= set(TREE)
    assert len({s.request for s in spans}) == 1
    for s in spans:
        assert s.host_start_ns < s.host_end_ns
        assert s.device_ms is None  # no card
        if s.parent is None:
            assert s.name == "request"
            continue
        parent = spans[s.parent]
        assert parent.name == TREE[s.name] and parent.index < s.index
        assert parent.host_start_ns <= s.host_start_ns <= s.host_end_ns <= parent.host_end_ns
    children = [s for s in spans if s.parent == 0]
    assert [s.name for s in children] == ["eval_mode", "backbone", "condition", "sampler",
                                          "decode", "metrics"]
    assert all(a.host_end_ns <= b.host_start_ns for a, b in zip(children, children[1:]))


@pytest.mark.parametrize("family", sorted(MICRO))
def test_request_span_holds_the_counters_change(traced, family):
    """The ``request`` span's counters are the change of every counter over
    the eval step (no copy to a card and no launch on the CPU)."""
    spans, change = traced[family]
    assert set(spans[0].counters) == set(trace.COUNTER_NAMES)
    assert spans[0].counters == change
    assert change["h2d_copies"] == change["h2d_bytes"] == 0


def test_no_profiler_no_record_and_no_event(monkeypatch):
    """Without a profiler session ``span`` returns the one shared no-op
    object, makes no CUDA event (even with CUDA initialised) and appends no
    record, through a whole eval step too."""
    step = micro_step("res18")
    with profile(activities=[ProfilerActivity.CPU]):
        pass  # a session that records nothing: the records start empty

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert trace.span("a") is trace.span("b") is trace.OFF
    with trace.span("a") as rec:
        assert rec is None
    step(micro_batch(), generator=torch.Generator().manual_seed(0))
    assert trace.spans() == []


def test_counter_deltas_sit_on_their_spans(monkeypatch):
    """Copies through ``to_device`` to another device than the host (here
    the meta device) and kernel launches count on every open span, each
    span seeing the change over its own interval; a copy on the host and
    a tensor already off the host count nothing."""
    monkeypatch.setitem(native.LAUNCHES, "conv_link", native.LAUNCHES["conv_link"])
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("request"):
            native.to_device(np.zeros(3, np.float32), "meta")
            with trace.span("inner"):
                on_meta = native.to_device([1.0, 2.0], "meta", torch.bfloat16)
                native.LAUNCHES["conv_link"] += 2
            native.to_device(np.zeros(5), "cpu")
            native.to_device(on_meta, "meta")
    request, inner = trace.spans()
    assert inner.parent == request.index and inner.request == request.request
    assert (inner.counters["h2d_copies"], inner.counters["h2d_bytes"]) == (1, 4)
    assert inner.counters["launches.conv_link"] == 2
    assert (request.counters["h2d_copies"], request.counters["h2d_bytes"]) == (2, 16)
    assert request.counters["launches.conv_link"] == 2
    assert sum(request.counters.values()) == 2 + 16 + 2


def test_constants_copy_once_per_key_device_and_dtype(monkeypatch):
    """A constant made on the host is copied once per (key, device, dtype):
    two resizes of one shape copy their two matrices once, a resize in
    another dtype copies its own; the sampler's tables (the timesteps and
    the DDIM-step rows, as the head's ``_sample`` takes them) once each,
    whatever the number of lookups. On the host they equal the numpy
    tables."""
    monkeypatch.setattr(native, "_CONSTANTS", {})
    sched = DDIMSchedule()
    x = torch.zeros(2, 3, 5, 4, device="meta")
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("request"):
            for _ in range(2):
                resize_bilinear(x, (6, 10))
                sched.table_on("meta", "timesteps", 4, "biased")
                sched.table_on("meta", "sched", 4, "biased")
            with trace.span("bf16"):
                resize_bilinear(x.to(torch.bfloat16), (6, 10), align_corners=True)
                resize_bilinear(x.to(torch.bfloat16), (6, 10), align_corners=True)
    request, bf16 = trace.spans()
    assert request.counters["h2d_copies"] == 2 + 2 + 2 and bf16.counters["h2d_copies"] == 2
    assert request.counters["h2d_bytes"] == 4 * (6 * 3 + 10 * 5) + 8 * 4 + 4 * 16 + 2 * (
        6 * 3 + 10 * 5)
    tables = sched.inference_tables(4, sched.biased_timesteps(4))
    np.testing.assert_array_equal(sched.table_on("cpu", "sched", 4, "biased").numpy(),
                                  tables.sched())
    np.testing.assert_array_equal(sched.table_on("cpu", "timesteps", 4, "biased").numpy(),
                                  tables.timesteps)


def test_constant_made_while_compiling_is_not_kept(monkeypatch):
    """While a program is traced (``torch.compiler.is_compiling``) a
    constant is made anew, and neither kept nor taken from what was kept:
    no tensor of a trace outlives it."""
    monkeypatch.setattr(native, "_CONSTANTS", {})
    made = []

    def make():
        made.append(1)
        return [1.0, 2.0]

    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    native.constant(("k",), make, "cpu")
    assert native._CONSTANTS == {} and len(made) == 1
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    kept = native.constant(("k",), make, "cpu")
    assert native.constant(("k",), make, "cpu") is kept and len(made) == 2
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert native.constant(("k",), make, "cpu") is not kept and len(made) == 3
    assert list(native._CONSTANTS.values()) == [kept]


def test_new_session_starts_afresh():
    """The records are those of the last session; each outermost span
    opens a new request id."""
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("request"):
            pass
    first = trace.spans()[0].request
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span("request"):
                with trace.span("x"):
                    pass
    spans = trace.spans()
    assert [s.name for s in spans] == ["request", "x", "request", "x"]
    assert [s.request for s in spans] == [first + 1, first + 1, first + 2, first + 2]
    assert [s.parent for s in spans] == [None, 0, None, 2]


def test_merge_into_writes_user_annotations_on_the_base_time(tmp_path):
    """``merge_into`` adds one ``user_annotation`` event a span, on the
    file's ``baseTimeNanoseconds``, to a trace stripped of the session's own
    annotations; each lands where the session's ``record_function`` event
    of the same span lay (within 1 ms on this host) and the file stays
    valid JSON."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("request"):
            with trace.span("inner"):
                time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    native_events = {e["name"]: e for e in data["traceEvents"]
                     if e.get("cat") == "user_annotation"}
    assert {"request", "inner"} <= set(native_events)
    data["traceEvents"] = [e for e in data["traceEvents"] if e.get("cat") != "user_annotation"]
    path.write_text(json.dumps(data))
    assert trace.merge_into(str(path)) == 2
    merged = json.loads(path.read_text())
    assert merged["baseTimeNanoseconds"] == data["baseTimeNanoseconds"]
    ours = [e for e in merged["traceEvents"] if e.get("cat") == "user_annotation"]
    base = data["baseTimeNanoseconds"]
    for e, s in zip(ours, trace.spans()):
        assert e["ph"] == "X" and e["name"] == s.name and e["args"]["request"] == s.request
        assert e["ts"] == (s.host_start_ns - base) / 1e3
        assert e["dur"] == pytest.approx(s.host_ms * 1e3)
        ref = native_events[s.name]
        assert abs(e["ts"] - ref["ts"]) < 1e3
        assert abs(e["ts"] + e["dur"] - ref["ts"] - ref["dur"]) < 1e3


def test_analyze_trace_labels_gaps_by_saved_spans(tmp_path, capsys):
    """``analyze_trace --spans`` merges saved spans into a device-only trace
    and labels each gap between device operations by the innermost span at
    its middle; the idle share is one minus the union over first to last
    operation."""
    base = 1_700_000_000_000_000_000
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": ts, "dur": d}
          for ts, d in [(0.0, 10.0), (5.0, 10.0), (40.0, 10.0), (52.0, 8.0)]]
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 7,
               "ts": 100.0, "dur": 10.0})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": base, "traceEvents": ev}))

    def rec(name, index, parent, a_us, b_us):
        return trace.Span(name, 1, index, parent, base + int(a_us * 1e3), base + int(b_us * 1e3))

    spans = [rec("request", 0, None, 0, 120), rec("sampler", 1, 0, 14, 45),
             rec("sampler.tables", 2, 1, 16, 30), rec("decode", 3, 0, 61, 110)]
    trace.save(str(tmp_path / "spans.json"), spans)
    assert analyze_trace.main([str(path), "--spans", str(tmp_path / "spans.json")]) == 0
    out = capsys.readouterr().out
    busy, window = 15 + 10 + 8 + 10, 110.0
    assert f"-- device idle: {100 * (1 - busy / window):.2f}% of 0.110 ms" in out
    lines = out.splitlines()
    at = lines.index(next(s for s in lines if s.startswith("-- device idle")))
    assert lines[at + 1:] == [f"{0.040:10.3f} ms  at 60.0 us  decode",
                              f"{0.025:10.3f} ms  at 15.0 us  sampler.tables",
                              f"{0.002:10.3f} ms  at 50.0 us  request"]
    events = analyze_trace.load_events(str(path))
    assert analyze_trace.idle(events)[2][0][3] == analyze_trace.OUTSIDE
    # the copy that ends the longest gap was launched 45 us before the device
    # started it: the gap is labelled 45 us earlier on the host's clock
    ev[-1]["args"] = {"correlation": 7}
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 1,
               "tid": 1, "ts": 55.0, "dur": 3.0, "args": {"correlation": 7}})
    path.write_text(json.dumps({"baseTimeNanoseconds": base, "traceEvents": ev}))
    events = analyze_trace.load_events(str(path), str(tmp_path / "spans.json"))
    assert analyze_trace.idle(events)[2][0] == (40.0, 60.0, 100.0, "sampler")


# ---- on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def device_only(fn, path):
    """Run ``fn`` under a profiler session of device activity alone; write
    its trace to ``path`` without any annotation the session recorded
    itself, so that only ``merge_into``'s spans label it."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    data["traceEvents"] = [e for e in data["traceEvents"] if e.get("cat") != "user_annotation"]
    path.write_text(json.dumps(data))
    return data["traceEvents"]


@pytest.mark.cuda
def test_span_clock_is_the_trace_clock(dev, tmp_path):
    """A span around a 5 ms sleep between two short kernels, merged into a
    device-only trace, labels the trace's longest idle gap, covers at least
    90% of it and lies nowhere more than 100 us outside it. Launches before
    them take the session's first-call costs (the first launch under the
    profiler returns milliseconds after its kernel has run)."""
    x = torch.ones(1024, device=dev)
    x.add_(1)
    torch.cuda.synchronize()

    def work():
        for _ in range(10):
            x.add_(1)
        torch.cuda.synchronize()
        x.add_(1)
        with trace.span("sleep"):
            time.sleep(0.005)
        x.add_(1)

    path = tmp_path / "trace.json"
    device_only(work, path)
    assert trace.merge_into(str(path)) == 1
    events = analyze_trace.load_events(str(path))
    _, _, gaps = analyze_trace.idle(events)
    us, a, b, label = gaps[0]
    assert label == "sleep"
    # on the host's clock: the gap ends where the host launched the kernel
    # that ends it (the profiler's device timestamps may stand off it)
    (after,) = [e for e in events if e.get("cat") == "kernel" and float(e["ts"]) == b]
    (launch,) = [e for e in events if e.get("cat") in analyze_trace.LAUNCH_CATS
                 and e.get("args", {}).get("correlation") == after["args"]["correlation"]]
    shift = b - float(launch["ts"])
    a, b = a - shift, b - shift
    s = next(e for e in events if e.get("cat") == "user_annotation")
    s0, s1 = float(s["ts"]), float(s["ts"]) + float(s["dur"])
    assert min(s1, b) - max(s0, a) >= 0.9 * us
    assert s0 >= a - 100 and s1 <= b + 100


@pytest.mark.cuda
def test_span_device_ms_agrees_with_cuda_events(dev):
    """A span's device ms and CUDA events recorded just outside it, around
    the same 20 products of 4096x4096 bf16 matrices, agree within 2%. The
    card is kept busy before them, so that the host's cost of opening the
    span does not leave it idle between the two start events."""
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    a @ a
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(20):
            a @ a
        start.record()
        with trace.span("products"):
            for _ in range(20):
                a @ a
        end.record()
        torch.cuda.synchronize()
    (s,) = trace.spans()
    assert s.device_ms == pytest.approx(start.elapsed_time(end), rel=0.02)


CELLS = {  # the benchmark's configurations (h100bench/configs), batch 8 at 352x1216
    "swinl": dict(backbone_module="swin", backbone_name="swin_large_naive_l4w722422k",
                  head_specify="DDIMDepthEstimate_Swin_ADDHAHI"),
    "res50": dict(backbone_module="mmbev_resnet", backbone_name="mmbev_res50",
                  head_specify="DDIMDepthEstimate_Res"),
    "mpvit": dict(backbone_module="mpvit", backbone_name="mpvit_small",
                  head_specify="DDIMDepthEstimate_MPVIT_ADDHAHI"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_h2d_copies_count_the_traces_copies(dev, cell, tmp_path):
    """Over a request of each benchmark configuration at its cells' shapes
    (batch 8, 352x1216, 20 steps, bf16, a given starting latent), the
    ``request`` span's ``h2d_copies`` equals the device-only trace's
    host-to-device copies: on the first request after the constants on the
    card are dropped, some, and on the next, none."""
    cfg = Config(model_name="Diffusion_DCbase_", inference_steps=20, opt_level="O1",
                 seed=5, **CELLS[cell]).finalize()
    step = make_eval_step(build_model(cfg, device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"rgb": torch.randn(8, 352, 1216, 3, generator=g, device=dev),
             "gt": torch.rand(8, 352, 1216, 1, generator=g, device=dev) * 79 + 1}
    init = torch.randn(8, 176, 608, 16, generator=g, device=dev)
    step(batch, init_latent=init)
    native._CONSTANTS.clear()
    for first in (True, False):
        events = device_only(lambda: step(batch, init_latent=init), tmp_path / "trace.json")
        htod = [e for e in events if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                and "HtoD" in e["name"]]
        (request,) = [s for s in trace.spans() if s.name == "request"]
        assert request.counters["h2d_copies"] == len(htod)
        assert (len(htod) > 0) == first, (first, len(htod))
