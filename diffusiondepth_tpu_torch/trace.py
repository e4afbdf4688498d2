"""The port's tracer: named spans over its layers and counters of its work.

Spans record only while a ``torch.profiler`` session runs (PyTorch's own
fast flag, ``torch.autograd.profiler._is_profiler_enabled``); otherwise
``span(name)`` returns one shared no-op context that records nothing and
makes no CUDA event. There is no other switch. A recorded span holds

* its name, the request it belongs to (one identifier for every span
  opened inside one outermost span: the eval step's ``request``), and the
  index of its parent in ``spans()``;
* its host start and end in nanoseconds on the host clock of the
  profiler's Chrome trace: a host event's ``ts`` (microseconds) plus the
  file's ``baseTimeNanoseconds`` is Unix-epoch time, ``time.time_ns()``
  (on an H100 a span opened just after a kernel launch starts 7-18 us
  after the launch call's end in the trace);
* on the card, its device milliseconds, from a pair of CUDA events;
* the change of every counter (``counts()``) over its interval.

While recording, each span also enters ``torch.profiler.record_function``,
so a session that records host activity shows it in its timeline. The
records are kept in memory, cleared when a profiler session starts, and
read with ``spans()`` after the session. ``merge_into`` adds them to a
Chrome trace as ``user_annotation`` events, on that file's base time: a
reader that labels a device idle gap by the innermost host event then puts
it down to a program span, in a trace of device activity alone too. The
trace's device timestamps are CUPTI's, and on an H100 they stood off the
host clock by up to half a millisecond at a session's start and drifted
from it by 1-8 ms a second within sessions of about two seconds; a reader
puts a device operation on the host clock by its launch (the runtime call
of the same ``correlation``), as ``tools/analyze_trace.py`` does.

The counters are ``ops/native.py``'s, always on, plain integer
increments: ``H2D["h2d_copies"]`` and ``H2D["h2d_bytes"]``, counted by
``native.to_device``, which every per-call copy of host data to the card
goes through, and the kernel launches of ``LAUNCHES`` (the family
``launches``).

Spans are meant for one thread: the one that runs the program.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler

from .ops.native import H2D, LAUNCHES

COUNTER_NAMES = (*H2D, *(f"launches.{k}" for k in LAUNCHES))


def counts() -> Dict[str, int]:
    """Every counter's value now, under ``COUNTER_NAMES``."""
    return dict(zip(COUNTER_NAMES, _snapshot()))


def _snapshot():
    return (*H2D.values(), *LAUNCHES.values())


@dataclasses.dataclass
class Span:
    name: str
    request: int
    index: int
    parent: Optional[int]
    host_start_ns: int
    host_end_ns: int = 0
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None

    @property
    def host_ms(self) -> float:
        return 1e-6 * (self.host_end_ns - self.host_start_ns)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_RECORDS: List[Span] = []
_STACK: List["_Recording"] = []
_UNREAD: List["_Recording"] = []  # closed, counters and device time not yet read
_next_request = 0


def clear() -> None:
    """Drop every record (done when a profiler session starts)."""
    _RECORDS.clear()
    _STACK.clear()
    _UNREAD.clear()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Recording:
    """One span while it records: the counters and the CUDA events are read
    into its ``Span`` by ``spans()``, after the session, not here."""

    __slots__ = ("rec", "function", "counts", "events")

    def __init__(self, name: str):
        global _next_request
        parent = _STACK[-1].rec if _STACK else None
        if parent is None:
            _next_request += 1
        self.rec = Span(name, parent.request if parent else _next_request, len(_RECORDS),
                        parent.index if parent else None, time.time_ns())
        self.function = _autograd_profiler.record_function(name)
        self.events = None

    def __enter__(self):
        _RECORDS.append(self.rec)
        _STACK.append(self)
        self.function.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.counts = _snapshot()
        return self.rec

    def __exit__(self, *exc):
        self.counts = (self.counts, _snapshot())
        if self.events is not None:
            self.events[1].record()
        self.function.__exit__(*exc)
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        self.rec.host_end_ns = time.time_ns()
        _UNREAD.append(self)
        return False


def span(name: str):
    """A context over one part of the program (module docstring); the
    shared no-op ``OFF`` while no profiler session runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Recording(name)


def spans() -> List[Span]:
    """The records since the last profiler session started, in the order
    they were opened. On the card this synchronises once to read the
    device times of spans closed since the last call."""
    if any(r.events is not None for r in _UNREAD):
        torch.cuda.synchronize()
    for r in _UNREAD:
        (c0, c1), rec = r.counts, r.rec
        rec.counters = {k: b - a for k, a, b in zip(COUNTER_NAMES, c0, c1)}
        if r.events is not None:
            rec.device_ms = r.events[0].elapsed_time(r.events[1])
    _UNREAD.clear()
    return list(_RECORDS)


def chrome_events(records: Sequence, base_ns: int, pid=0, tid=0) -> List[dict]:
    """``records`` (``Span``s or their ``as_dict()``) as complete Chrome
    trace events of category ``user_annotation``, in microseconds from
    ``base_ns``; a span's request, parent, device ms and counters go
    into its ``args``."""
    out = []
    for r in records:
        r = r.as_dict() if isinstance(r, Span) else r
        args = {"request": r["request"], "parent": r["parent"], "device_ms": r["device_ms"],
                **{k: v for k, v in r["counters"].items() if v}}
        out.append({"ph": "X", "cat": "user_annotation", "name": r["name"], "pid": pid,
                    "tid": tid, "ts": (r["host_start_ns"] - base_ns) / 1e3,
                    "dur": (r["host_end_ns"] - r["host_start_ns"]) / 1e3, "args": args})
    return out


def merge_into(chrome_trace_path: str, records: Optional[Sequence] = None) -> int:
    """Add ``records`` (default ``spans()``) to the Chrome trace at
    ``chrome_trace_path`` (as ``export_chrome_trace`` writes it) as
    ``user_annotation`` events on the file's ``baseTimeNanoseconds``, on
    the process and thread of its host events (else of its first event);
    returns how many were added."""
    with open(chrome_trace_path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation",
                                                  "cuda_runtime", "python_function")]
    first = host[0] if host else (events[0] if events else {})
    added = chrome_events(spans() if records is None else records,
                          int(data.get("baseTimeNanoseconds", 0)),
                          first.get("pid", 0), first.get("tid", 0))
    events.extend(added)
    with open(chrome_trace_path, "w") as f:
        json.dump(data, f)
    return len(added)


def save(path: str, records: Optional[Sequence[Span]] = None) -> None:
    """Write ``records`` (default ``spans()``) as a JSON list of their
    ``as_dict()``, for ``tools/analyze_trace.py --spans``."""
    with open(path, "w") as f:
        json.dump([r.as_dict() for r in (spans() if records is None else records)], f)


def _clearing(start):
    def on_profiler_start():
        start()
        clear()

    on_profiler_start.clears_port_spans = True
    return on_profiler_start


# Every torch.profiler session, whatever starts it, calls this module
# function of PyTorch's when it starts recording (it sets the flag that
# ``span`` reads): the records start afresh there.
_start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
if _start is not None and not getattr(_start, "clears_port_spans", False):
    _autograd_profiler._run_on_profiler_start = _clearing(_start)
