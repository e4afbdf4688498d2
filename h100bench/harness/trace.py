"""Reading a ``torch.profiler`` Chrome trace of a slice: device busy time as
the union of the device operations' intervals, the idle gaps between them
labelled by what the host was doing (where the trace holds host events),
and the device operations that took most time.

Device operations are the events of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``. The slice's length is the host clock's,
between two synchronisations; the trace holds the slice's device work and
nothing else, so the time before its first and after its last operation is
idle too (``slice edges``).
"""

from __future__ import annotations

import collections
import json
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
EDGES = "slice edges: before the first and after the last device operation"


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merge (start, end) intervals into disjoint ones, in order."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], slice_s: float, top: int = 10) -> Dict:
    """busy_s, window_s (the slice), the kernel counts, the ``top`` device
    operations by time and the ``top`` longest idle gaps. Times in the trace
    are microseconds."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        raise ValueError("no device operation in the trace")
    busy = union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in dev])
    by_name: Dict[str, float] = collections.Counter()
    counts: Dict[str, int] = collections.Counter()
    for e in dev:
        by_name[e["name"]] += float(e.get("dur", 0)) * 1e-6
        counts[e["name"]] += 1
    busy_s = sum(b - a for a, b in busy) * 1e-6
    span_s = (busy[-1][1] - busy[0][0]) * 1e-6
    window_s = max(slice_s, span_s)
    host = [e for e in events if e.get("cat") in HOST_CATS]
    longest = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])), reverse=True)
    gaps = [(us * 1e-6, _label(host, a, b)) for us, a, b in longest[:top]]
    gaps.append((window_s - span_s, EDGES))
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernel_counts": dict(counts),
        "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[name, s] for s, name in sorted(gaps, reverse=True)[:top]],
    }


def _label(host: List[dict], a: float, b: float) -> str:
    """The innermost host event running at the middle of the gap (a, b)."""
    mid = 0.5 * (a + b)
    inside = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e.get("dur", 0))]
    if not inside:
        return "host: outside any traced CUDA call (Python, CPU work)"
    e = min(inside, key=lambda e: float(e.get("dur", 0)))
    return f"{e.get('cat')}: {e['name']}"[:120]
