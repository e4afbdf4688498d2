"""Device-timeline breakdown of a ``torch.profiler`` Chrome trace, with no
TensorBoard: the port of ``diffusiondepth_tpu/tools/analyze_trace.py``.

``main --profile_dir D`` writes ``D/trace.json`` (``main.py``
``_finish_profile``), as does ``prof.export_chrome_trace`` generally. This
reads the trace's complete events and prints:

* the total device time: the sum of the ``kernel`` events (CUDA kernels),
  and the ``gpu_memcpy`` events' time and count;
* the top kernels by device time, with their instance counts (a kernel of
  the sampler shows n = steps x its calls per step);
* the categories: kernel names with trailing indices stripped, summed.

A trace taken on the CPU has no kernel events; the same summary is then
made of its host operators (``cpu_op`` events), which the output says.

CLI:  python -m diffusiondepth_tpu_torch.tools.analyze_trace D [--top 40]
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
from typing import Dict, List, Tuple

_TRAILING_IDX = re.compile(r"[.\d]+$")


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


def load_events(trace_file: str) -> List[dict]:
    """The complete ('X') events of a Chrome trace."""
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


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


def summarize(trace_file: str, top: int = 40) -> str:
    events = load_events(trace_file)
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
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("path", help="profile dir (or its trace.json)")
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args(argv)
    print(summarize(find_trace_file(args.path), top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
