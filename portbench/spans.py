"""The program's own spans on the trace's clock, and the device's idle time
of a traced slice charged to the creator's stage the host was in.

While a ``torch.profiler`` session records, the program keeps spans inside
its chunk loop (``pi3_slam_tpu_torch.utils.timing``: name, start and end on
``time.perf_counter_ns``, id, parent id, chunk id, thread) and a
(``perf_counter_ns``, ``time_ns``) anchor: each span's own, read at its
open, where the program keeps one, else the newest. A trace's ``ts`` is
microseconds of Unix time from the Unix time floored to 7,889,238 s (its
``baseTimeNanoseconds``), so the anchor lays the spans onto the trace with
no marker. Each idle microsecond of the traced window (the window and the
busy union as ``trace.device_timeline`` takes them) is charged to the
innermost span of the creator's thread that covers it, and rolled up by
that span and its ancestors into one of six stages (``STAGES``); idle time
under no creator stage (between stages, before the first, after the last)
is ``unattributed``. The six sum to the idle share.

Frozen with the benchmark: a later change to the program cannot move the
rule. A program that keeps no spans (one without the recorder, or none
recorded) reads None.
"""

from __future__ import annotations

# the creator's stage spans -> the stage their idle time is charged to; the
# children of creator.dispatch other than the upload (creator.keypoints,
# pi3.*, step.post, moge.forward) fall to the launch through it
STAGES = {"creator.loader_wait": "loader_wait", "creator.upload": "upload",
          "creator.dispatch": "launch", "creator.finish": "finish", "creator.sync": "finish",
          "creator.result": "finish", "creator.save": "save"}
BUCKETS = ("loader_wait", "upload", "launch", "finish", "save", "unattributed")
# the interval torch.profiler's Chrome traces count their time from
BASE_INTERVAL_NS = 7889238 * 1_000_000_000
# the harness's own host spans, laid onto the trace after its timeline
HARNESS_PREFIX = "portbench."


def program_spans():
    """(spans, anchor) the program recorded, or None where it recorded none."""
    try:
        from pi3_slam_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "recorded_spans", None)
    anchor = getattr(timing, "clock_anchor", None)
    if read is None or anchor is None:
        return None
    spans, a = read(), anchor()
    if not spans or a is None:
        return None
    return spans, a


def on_trace(spans: list, anchor: tuple, base_ns: int | None = None) -> list:
    """The spans with ``ts`` and ``end`` in trace microseconds, each mapped
    through its own ``anchor`` where it has one, else through ``anchor``:
    ``base_ns`` the trace's base, default the anchor's Unix time floored to
    the interval."""
    if base_ns is None:
        base_ns = anchor[1] // BASE_INTERVAL_NS * BASE_INTERVAL_NS
    out = []
    for s in spans:
        perf_ns, unix_ns = s.get("anchor") or anchor
        shift = unix_ns - perf_ns - base_ns
        out.append({**s, "ts": (s["start_ns"] + shift) / 1e3, "end": (s["end_ns"] + shift) / 1e3})
    return out


def _trace_window_and_busy(events: list):
    """(start, end) of every timed event of the trace but the harness's own
    spans, and the union of the device intervals, in trace microseconds."""
    from .trace import _union, device_intervals

    timed = [e for e in events if "dur" in e and "ts" in e
             and not (e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith(HARNESS_PREFIX))]
    if not timed:
        return None, []
    lo = min(e["ts"] for e in timed)
    hi = max(e["ts"] + e["dur"] for e in timed)
    return (lo, hi), _union(device_intervals(events))


def _idle(window, busy):
    """The stretches of the window with no device work."""
    lo, hi = window
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def _segments(spans: list, window) -> list:
    """(start, end, stage) stretches of the window, each under one
    innermost creator-thread span, the stage read from it and its
    ancestors."""
    lo, hi = window
    threads = {s["thread"] for s in spans if s["name"] in STAGES or s["name"] == "chunk"}
    mine = [s for s in spans if s["thread"] in threads]
    by_id = {s["id"]: s for s in mine}

    def stage(s):
        while s is not None:
            if s["name"] in STAGES:
                return STAGES[s["name"]]
            s = by_id.get(s["parent"])
        return "unattributed"

    inside = [s for s in mine if s["end"] > lo and s["ts"] < hi]
    cuts = sorted({lo, hi, *(min(max(t, lo), hi) for s in inside for t in (s["ts"], s["end"]))})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        cover = [s for s in inside if s["ts"] <= a and s["end"] >= b]
        inner = max(cover, key=lambda s: (s["ts"], -s["end"]), default=None)
        out.append((a, b, stage(inner)))
    return out


def idle_by_stage(events: list, spans: list, anchor: tuple, base_ns: int | None = None):
    """{bucket: idle seconds} over the traced window and the window's
    seconds, or None where no span lies in the window."""
    window, busy = _trace_window_and_busy(events)
    if window is None:
        return None
    mapped = on_trace(spans, anchor, base_ns)
    if not any(s["end"] > window[0] and s["ts"] < window[1] for s in mapped):
        return None
    charged = dict.fromkeys(BUCKETS, 0.0)
    segs = _segments(mapped, window)
    i = 0
    for a, b in _idle(window, busy):
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            s0, s1, bucket = segs[j]
            charged[bucket] += (min(b, s1) - max(a, s0)) / 1e6
            j += 1
    return {"idle_s": charged, "window_s": (window[1] - window[0]) / 1e6}


def read_share(run, bucket: str):
    """100 x the idle seconds charged to ``bucket`` over the traced window,
    or None (no trace, or no program span in it). The split is computed once
    a run."""
    if run.events is None:
        return None
    cached = getattr(run, "idle_by_stage", None)
    if cached is None or cached[0] is not run.events:
        got = program_spans()
        split = None if got is None else idle_by_stage(run.events, *got)
        cached = (run.events, split)
        run.idle_by_stage = cached
    split = cached[1]
    if split is None or split["window_s"] <= 0:
        return None
    return 100.0 * split["idle_s"][bucket] / split["window_s"]
