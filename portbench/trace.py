"""Readers of a torch.profiler Chrome trace.

``device_timeline`` and ``summarize`` are frozen copies of the port's
``slam/chunk_creator.device_timeline`` and ``tools/trace_summary.summarize``:
the traced window spans every timed event, device busy time is the union of
the GPU's kernel, memcpy and memset intervals, and device time is summed by
kernel name. ``kernel_seconds`` sums the device time of the kernels that a
set of kernel specs (``portbench/kernels/<operation>/*.json``) names, and
``idle_gaps`` names the longest stretches with no device work by the host
span that covered them.
"""

from __future__ import annotations

import gzip
import json
import re
from collections import defaultdict

# Chrome-trace categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _timed(events: list) -> list:
    return [e for e in events if "dur" in e and "ts" in e]


def device_intervals(events: list) -> list:
    """Sorted (start_us, end_us) of every device event."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in _timed(events)
                  if e.get("cat") in DEVICE_CATEGORIES)


def _union(intervals: list) -> list:
    merged = []
    for start, stop in intervals:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return merged


def device_timeline(events: list) -> dict:
    """Traced window, device-busy time and idle share: the window spans every
    timed event (host and device), busy is the union of the device's kernel,
    memcpy and memset intervals."""
    timed = _timed(events)
    if not timed:
        return {"window_s": 0.0, "busy_s": 0.0, "idle_share": 1.0}
    window = max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)
    busy = sum(stop - start for start, stop in _union(device_intervals(events)))
    window_s, busy_s = window / 1e6, busy / 1e6
    return {"window_s": window_s, "busy_s": busy_s,
            "idle_share": 1.0 - busy_s / window_s if window_s > 0 else 1.0}


def summarize(events: list) -> dict:
    """{name: us} of device time by operation name."""
    by_op = defaultdict(float)
    for e in _timed(events):
        if e.get("cat") in DEVICE_CATEGORIES:
            by_op[e["name"]] += e["dur"]
    return dict(by_op)


def spec_matches(spec: dict, event: dict) -> bool:
    """Whether a kernel event is one that ``spec`` names: ``name`` is a
    regular expression searched in the kernel's name; ``grid``, where given,
    is [x, y, z] of the launch with null for any."""
    if event.get("cat") != "kernel" or not re.search(spec["name"], event.get("name", "")):
        return False
    want = spec.get("grid")
    if want is None:
        return True
    got = (event.get("args") or {}).get("grid")
    return got is not None and all(w is None or w == g for w, g in zip(want, got))


def kernel_seconds(events: list, specs: list) -> tuple[float, int]:
    """(seconds, launches) of the kernel events any of ``specs`` names."""
    total, n = 0.0, 0
    for e in _timed(events):
        if any(spec_matches(s, e) for s in specs):
            total += e["dur"]
            n += 1
    return total / 1e6, n


def top_device_ops(events: list, n: int = 10) -> list:
    by_op = summarize(events)
    return [[name, us / 1e6] for name, us in sorted(by_op.items(), key=lambda kv: -kv[1])[:n]]


def host_span_events(events: list, spans: list, t_mark: float, mark_bytes: int) -> list:
    """Host spans (name, start, end) on the host clock as trace events, laid
    onto the trace's timeline by the marker: a host-to-device copy of
    ``mark_bytes`` issued at ``t_mark``, whose runtime call the trace holds
    at its own time. [] where the trace holds no marker."""
    corr = [(e.get("args") or {}).get("correlation") for e in events
            if e.get("cat") == "gpu_memcpy" and (e.get("args") or {}).get("bytes") == mark_bytes]
    calls = [e for e in events if e.get("cat") == "cuda_runtime" and corr
             and (e.get("args") or {}).get("correlation") == corr[0]]
    if not calls:
        return []
    zero = calls[0]["ts"] - t_mark * 1e6
    return [{"cat": "user_annotation", "ph": "X", "name": name, "ts": zero + t0 * 1e6,
             "dur": (t1 - t0) * 1e6} for name, t0, t1 in spans]


def idle_gaps(events: list, n: int = 10, host_prefix: str = "portbench.") -> list:
    """The n longest stretches between device events, each named by the
    innermost host span (a ``user_annotation`` event whose name starts with
    ``host_prefix``) that covers its middle, else 'unannotated'."""
    busy = _union(device_intervals(events))
    spans = [e for e in _timed(events)
             if e.get("cat") == "user_annotation" and e["name"].startswith(host_prefix)]
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        cover = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
        name = min(cover, key=lambda s: s["dur"])["name"] if cover else "unannotated"
        gaps.append([name, (b - a) / 1e6])
    return sorted(gaps, key=lambda g: -g[1])[:n]
