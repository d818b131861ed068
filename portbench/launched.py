"""The device time of the kernels the program launched inside its own spans.

A kernel belongs to a span when its launch, the ``cuda_runtime`` or
``cuda_driver`` event of the trace with the kernel's ``correlation`` id,
lies inside one of the span's intervals, the program's recorded spans laid
onto the trace by their clock anchors (``spans.on_trace``). So a kernel
counts where the host enqueued it, whenever the card ran it: the heads'
kernels count under the heads' spans though the card runs them later.

Frozen with the benchmark: a later change to the program cannot move the
rule. A program that recorded none of the spans in the trace's window (one
without them, or without the recorder) reads None.
"""

from __future__ import annotations

from bisect import bisect_right

from . import spans, trace

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def kernel_seconds_in_spans(events: list, names: tuple, specs: list | None = None):
    """(device seconds, launches) of the kernel events launched inside a
    program span named in ``names``: every kernel, or those any of ``specs``
    (``kernels/<operation>/*.json``) names. None where no such span lies in
    the trace's window."""
    got = spans.program_spans()
    timed = [e for e in events if "dur" in e and "ts" in e]
    if got is None or not timed:
        return None
    lo = min(e["ts"] for e in timed)
    hi = max(e["ts"] + e["dur"] for e in timed)
    inside = sorted((s["ts"], s["end"]) for s in spans.on_trace(*got)
                    if s["name"] in names and s["end"] > lo and s["ts"] < hi)
    if not inside:
        return None
    starts = [a for a, _ in inside]
    launched = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATEGORIES and "ts" in e:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = e["ts"]
    total, n = 0.0, 0
    for e in timed:
        if e.get("cat") != "kernel" or (specs and not any(trace.spec_matches(s, e)
                                                           for s in specs)):
            continue
        t = launched.get((e.get("args") or {}).get("correlation"))
        if t is None:
            continue
        i = bisect_right(starts, t) - 1
        if i >= 0 and t <= inside[i][1]:
            total += e["dur"]
            n += 1
    return total / 1e6, n
