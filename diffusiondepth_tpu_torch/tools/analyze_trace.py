"""Device-timeline breakdown of a ``torch.profiler`` Chrome trace, with no
TensorBoard: the port of ``diffusiondepth_tpu/tools/analyze_trace.py``.

``main --profile_dir D`` writes ``D/trace.json`` (``main.py``
``_finish_profile``), as does ``prof.export_chrome_trace`` generally. This
reads the trace's complete events and prints:

* the total device time: the sum of the ``kernel`` events (CUDA kernels),
  and the ``gpu_memcpy`` events' time and count;
* the top kernels by device time, with their instance counts (a kernel of
  the sampler shows n = steps x its calls per step);
* the categories: kernel names with trailing indices stripped, summed;
* the device's idle share: one minus the union of the kernel, copy and set
  intervals over the time from the first device operation's start to the
  last one's end, and the ten longest gaps between device operations,
  each labelled by the innermost program span running on the host at its
  middle (``diffusiondepth_tpu_torch/trace.py``: ``user_annotation``
  events), or "outside every program span"; the gap is placed on the
  host's clock by the launch of the operation that ends it (``idle``).

A session that records host activity (``main``'s) holds the program's
spans itself. For a trace of device activity alone, save the spans after
the session with ``trace.save(path)`` and pass ``--spans path``: they are
merged on the trace's ``baseTimeNanoseconds``.

A trace taken on the CPU has no kernel events; the same summary is then
made of its host operators (``cpu_op`` events), which the output says.

CLI:  python -m diffusiondepth_tpu_torch.tools.analyze_trace D [--top 40] [--spans S]
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

_TRAILING_IDX = re.compile(r"[.\d]+$")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside every program span"


def find_trace_file(path: str) -> str:
    """``path`` may be the trace file or a directory; a directory resolves
    to the newest ``*.json`` or ``*.json.gz`` beneath it."""
    if os.path.isfile(path):
        return path
    hits = [f for pat in ("*.json", "*.json.gz")
            for f in glob.glob(os.path.join(path, "**", pat), recursive=True)]
    if not hits:
        raise FileNotFoundError(f"no trace (*.json, *.json.gz) under {path}")
    return max(hits, key=os.path.getmtime)


def load_events(trace_file: str, spans_file: Optional[str] = None) -> List[dict]:
    """The complete ('X') events of a Chrome trace, with the program spans
    saved in ``spans_file`` (``trace.save``) added on its base time."""
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    events = [e for e in events if e.get("ph") == "X"]
    if spans_file:
        from ..trace import chrome_events

        with open(spans_file) as f:
            records = json.load(f)
        base = int(data.get("baseTimeNanoseconds", 0)) if isinstance(data, dict) else 0
        events += chrome_events(records, base)
    return events


def breakdown(events: List[dict], cat: str) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """(total us, us by name, instances by name) of the events of ``cat``;
    the total is ``sum`` over the events in the trace's order."""
    durs = []
    dur: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for e in events:
        if e.get("cat") == cat:
            durs.append(float(e.get("dur", 0)))
            dur[e["name"]] += durs[-1]
            cnt[e["name"]] += 1
    return sum(durs), dur, cnt


def union(intervals) -> List[Tuple[float, float]]:
    """Merge (start, end) intervals into disjoint ones, in order."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def span_at(events: List[dict], t: float) -> str:
    """The name of the shortest ``user_annotation`` running at ``t`` (us)."""
    inside = [e for e in events if e.get("cat") == "user_annotation"
              and float(e["ts"]) <= t <= float(e["ts"]) + float(e.get("dur", 0))]
    return min(inside, key=lambda e: float(e.get("dur", 0)))["name"] if inside else OUTSIDE


def idle(events: List[dict], top: int = 10):
    """(busy us, us from the first device operation's start to the last
    one's end, the ``top`` longest gaps as (us, start, end, label)), the
    gaps in device time. Each gap is labelled on the host's clock: the
    profiler's device timestamps can stand off the host's and drift from
    it by milliseconds within a session, so the gap is first moved to
    end where the host launched the operation that ends it (the CUDA
    runtime or driver call of the same ``correlation``); where the trace
    has no such call it is labelled where it lies."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev])
    if not busy:
        return 0.0, 0.0, []
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    starts = {float(e["ts"]): launched.get(e.get("args", {}).get("correlation")) for e in dev}
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])), reverse=True)
    out = []
    for us, a, b in gaps[:top]:
        shift = b - starts[b] if starts.get(b) is not None else 0.0
        out.append((us, a, b, span_at(events, 0.5 * (a + b) - shift)))
    return sum(b - a for a, b in busy), busy[-1][1] - busy[0][0], out


def summarize(trace_file: str, top: int = 40, spans_file: Optional[str] = None) -> str:
    events = load_events(trace_file, spans_file)
    total, dur, cnt = breakdown(events, "kernel")
    out = [f"trace: {trace_file}"]
    if dur:
        out.append(f"device (kernel) time: {total / 1000:.3f} ms in {sum(cnt.values())} kernels")
        what = "kernels"
    else:
        total, dur, cnt = breakdown(events, "cpu_op")
        out.append(f"no kernel events (a CPU trace); host operators: {total / 1000:.3f} ms "
                   f"in {sum(cnt.values())} calls")
        what = "host operators"
    copies, _, ncopy = breakdown(events, "gpu_memcpy")
    if ncopy:
        out.append(f"memcpy: {copies / 1000:.3f} ms in {sum(ncopy.values())} copies")
    out.append(f"-- top {top} {what} (ms, n = instances) --")
    for name, us in collections.Counter(dur).most_common(top):
        out.append(f"{us / 1000:10.3f} ms  n={cnt[name]:6d}  {name[:100]}")
    cats: Dict[str, float] = collections.Counter()
    for name, us in dur.items():
        cats[_TRAILING_IDX.sub("", name)] += us
    out.append("-- categories --")
    for name, us in cats.most_common(25):
        out.append(f"{us / 1000:10.3f} ms  {name[:100]}")
    busy, window, gaps = idle(events)
    if window > 0:
        out.append(f"-- device idle: {100 * (1 - busy / window):.2f}% of {window / 1000:.3f} ms "
                   f"(first to last device operation); the {len(gaps)} longest gaps --")
        for us, a, _, label in gaps:
            out.append(f"{us / 1000:10.3f} ms  at {a:.1f} us  {label[:100]}")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("path", help="profile dir (or its trace.json)")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--spans", default=None,
                   help="program spans saved by trace.save, for a trace of device activity alone")
    args = p.parse_args(argv)
    print(summarize(find_trace_file(args.path), top=args.top, spans_file=args.spans))
    return 0


if __name__ == "__main__":
    sys.exit(main())
