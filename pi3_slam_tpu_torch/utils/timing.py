"""Wall-clock stage timing and the port's span recorder.

:class:`TimingStats` keeps per-stage totals, counts and averages, printed
sorted by total (port of ``pi3_slam_tpu/utils/timing.py``). Its
:meth:`TimingStats.track` and the module's :func:`span` are also the port's
one span recorder. The recorder is off unless a ``torch.profiler`` session
records (the creator's ``--profile-dir`` runs one) or :func:`enable_spans`
turned it on; off, a :func:`span` costs a flag test and nothing is kept.
On, every span that opens is appended when it closes to one bounded,
process-wide buffer: its name, start and end on ``time.perf_counter_ns``,
its id, its parent's id (the innermost recorded span open on the same
thread), its chunk id (given, else its parent's), its native thread id and
its clock anchor.

A span's anchor is the (``perf_counter_ns``, ``time_ns``) pair read when it
opened, so spans of different profiler sessions each map through a pair of
their own; :func:`clock_anchor` is the newest. :func:`trace_us` maps a time
through an anchor onto a ``torch.profiler`` Chrome trace's ``ts``
(microseconds from the Unix time floored to 7,889,238 s, the trace's
``baseTimeNanoseconds``), and :func:`add_spans_to_trace` writes the spans
into such a trace as ``user_annotation`` events, so that Perfetto shows them
above the kernels and ``tools/trace_summary`` charges them the device time
of the launches inside them.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict

import torch.autograd.profiler as _autograd_profiler

# spans kept: the oldest are dropped beyond it
MAX_SPANS = 1 << 16
# the interval Chrome traces of torch.profiler count their time from
TRACE_BASE_INTERVAL_S = 7889238

# appended and copied whole under the interpreter lock (deque.append and
# deque.copy run in C), so no span is lost and a reader never sees it mid-way
_buffer: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
# native thread id -> the low 32 bits of its pthread id, which is how a trace
# names a thread whose native id the profiler did not learn (its CUDA calls)
_pthread_ids: Dict[int, int] = {}
_forced = False
_anchor: tuple | None = None  # the newest recorded span's


def spans_on() -> bool:
    """Whether a span opened now is recorded."""
    return _forced or _autograd_profiler._is_profiler_enabled


def enable_spans(on: bool = True) -> None:
    """Record spans (``on``) whether or not a profiler session records."""
    global _forced
    _forced = on


def clock_anchor() -> tuple | None:
    """(``perf_counter_ns``, ``time_ns``) read when the newest recorded span
    opened; None before any was."""
    return _anchor


def recorded_spans() -> list:
    """The spans recorded so far, oldest first by start, as dicts: ``name``,
    ``start_ns``, ``end_ns`` (``perf_counter_ns``), ``id``, ``parent`` (id or
    None), ``chunk`` (int, tuple of ints for a dp group, or None), ``thread``,
    ``anchor`` (the (``perf_counter_ns``, ``time_ns``) pair read at its open)."""
    return sorted(({k: getattr(s, k) for k in Span.__slots__ if k != "_stats"}
                   for s in _buffer.copy()),
                  key=lambda s: s["start_ns"])


class Span:
    """One timed block (the context manager of :meth:`TimingStats.track`
    and :func:`span`); its times are read after the block."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "chunk", "thread", "anchor",
                 "_stats")

    def __init__(self, name: str, chunk=None, stats: "TimingStats | None" = None):
        self.name, self.chunk, self._stats = name, chunk, stats
        self.id = None

    def __enter__(self) -> "Span":
        global _anchor
        if _forced or _autograd_profiler._is_profiler_enabled:
            self.anchor = _anchor = (time.perf_counter_ns(), time.time_ns())
            try:
                stack = _local.stack
            except AttributeError:  # the thread's first span
                stack = _local.stack = []
                _local.thread = threading.get_native_id()
                _pthread_ids[_local.thread] = threading.get_ident() & 0xFFFFFFFF
            parent = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = parent.id if parent is not None else None
            if self.chunk is None and parent is not None:
                self.chunk = parent.chunk
            self.thread = _local.thread
            stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._stats is not None:
            self._stats.record(self.name, self.seconds)
            self._stats = None
        if self.id is not None:
            stack = _local.stack
            if stack[-1] is self:
                stack.pop()
            else:  # closed out of order (a generator left open)
                stack.remove(self)
            _buffer.append(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Off:
    """The span of a recorder that is off: nothing timed, nothing kept."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def span(name: str, chunk=None):
    """A recorded span around the block where the recorder is on, else a
    no-op; ``with span(...) as s`` gives the :class:`Span` or None. Code that
    holds no :class:`TimingStats` (the models, MoGe, the loader) uses it;
    ``chunk`` names the chunk where no enclosing span does (a loader thread)."""
    if _forced or _autograd_profiler._is_profiler_enabled:
        return Span(name, chunk)
    return _OFF


def trace_us(ns: int, anchor: tuple, base_ns: int | None = None) -> float:
    """A ``perf_counter_ns`` time on a torch.profiler Chrome trace's clock:
    microseconds from ``base_ns`` (the trace's ``baseTimeNanoseconds``;
    default the Unix time of ``anchor`` floored to 7,889,238 s)."""
    perf_ns, unix_ns = anchor
    if base_ns is None:
        step = TRACE_BASE_INTERVAL_S * 1_000_000_000
        base_ns = unix_ns // step * step
    return (ns - perf_ns + unix_ns - base_ns) / 1e3


def add_spans_to_trace(path: str) -> int:
    """Write the recorded spans that overlap the traced window of the Chrome
    trace at ``path`` into it as ``user_annotation`` events, each mapped
    through its own anchor and clipped to the window. A span sits on its
    thread as the trace names it: the native id, or where the trace's events
    name the thread by its pthread id only, that. ``args`` hold the span's
    id, parent and chunk, and ``threads``: both ids of its thread (a trace
    may put the thread's CUDA calls on either lane). Returns how many."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    timed = [e for e in events if "dur" in e and "ts" in e]
    if not timed:
        return 0
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    base = trace.get("baseTimeNanoseconds")
    named = {e.get("tid") for e in timed}

    def tid(native):
        alias = _pthread_ids.get(native)
        return alias if native not in named and alias in named else native

    added = 0
    for s in recorded_spans():
        t0 = max(lo, trace_us(s["start_ns"], s["anchor"], base))
        t1 = min(hi, trace_us(s["end_ns"], s["anchor"], base))
        if t1 <= t0:
            continue
        chunk = list(s["chunk"]) if isinstance(s["chunk"], tuple) else s["chunk"]
        events.append({"ph": "X", "cat": "user_annotation", "name": s["name"], "pid": os.getpid(),
                       "tid": tid(s["thread"]), "ts": t0, "dur": t1 - t0,
                       "args": {"span_id": s["id"], "parent": s["parent"], "chunk": chunk,
                                "threads": [s["thread"], _pthread_ids[s["thread"]]]}})
        added += 1
    with open(path, "w") as f:
        json.dump(trace, f)
    return added


class TimingStats:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def track(self, name: str, chunk=None) -> Span:
        """Time the block into the totals under ``name``; where the recorder
        is on, also a span (``chunk``: as for :func:`span`). ``with
        track(...) as s`` gives the :class:`Span`, whose times are set
        whether or not it was recorded."""
        return Span(name, chunk, self)

    def statistics(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "avg_ms": 1000.0 * self.totals[k] / max(1, self.counts[k]),
            }
            for k in self.totals
        }

    def print_statistics(self) -> None:
        stats = self.statistics()
        if not stats:
            return
        print("Timing (sorted by total):")
        for k in sorted(stats, key=lambda k: -stats[k]["total_s"]):
            s = stats[k]
            print(f"  {k:20s} total {s['total_s']:8.3f}s  n={s['count']:4d}  avg {s['avg_ms']:8.2f}ms")
