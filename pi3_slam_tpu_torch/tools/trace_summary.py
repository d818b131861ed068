"""Summarize a torch.profiler trace: device time by kernel, top-N table.

Port of the JAX package's ``tools/trace_summary.py`` for the port's traces:
``--profile-dir <dir>`` of the creator and the online CLI writes
``chunk_trace.json`` (a Chrome trace of one chunk) there. This reads the
newest trace under the directory (or the file given) and prints, in the JAX
tool's layout:

* the device total over the GPU's kernel, memcpy and memset events, and the
  host slices in total (every other timed event; nested slices count each);
* device time by category (kernel / memcpy / memset, in place of XLA's
  ``hlo_category``);
* the top-N device ops by time, with their count and share;
* where the trace holds spans (``user_annotation`` events: the program's
  spans that ``--profile-dir`` merges in, ``record_function`` blocks), a
  table by span name: host seconds, count, and the device seconds of the
  kernels, copies and sets whose launch call (a ``cuda_runtime`` or
  ``cuda_driver`` event, matched by correlation id) lies inside the span on
  the span's thread, under either id the trace gives that thread.

    python -m pi3_slam_tpu_torch.tools.trace_summary <profile_dir> [top_n]

No GPU and no tensorboard needed: it reads JSON on the host.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from bisect import bisect_left, bisect_right
from collections import defaultdict

# Chrome-trace categories of device work -> the table's category
DEVICE_CATEGORIES = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
SPAN_CATEGORY = "user_annotation"
# host events that launch device work, tied to it by correlation id
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def find_trace(root: str) -> str:
    """``root`` itself when it is a file, else the newest (by name)
    ``chunk_trace.json`` or other ``*.json`` / ``*.json.gz`` trace under it."""
    if os.path.isfile(root):
        return root
    for pattern in ("chunk_trace.json", "*.pt.trace.json", "*.json", "*.json.gz"):
        hits = sorted(glob.glob(os.path.join(root, "**", pattern), recursive=True))
        if hits:
            return hits[-1]
    raise FileNotFoundError(f"no trace .json under {root}")


def by_span(events: list) -> dict:
    """{span name: {'host_us', 'count', 'device_us'}} over the trace's spans:
    the device time is that of the device events whose launch call lies
    inside the span, on its thread (a span counts its children's launches).
    A trace names a thread by its native id where the profiler learned it
    and by its pthread id elsewhere, the CUDA calls of one thread sometimes
    on both lanes; the program's merged spans list both ids in
    ``args['threads']``, and any span on either lane matches both."""
    device_us = defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES and "dur" in e:
            device_us[(e.get("args") or {}).get("correlation")] += e["dur"]
    launches = sorted((e["ts"], e.get("tid"), device_us[c]) for e in events
                      if e.get("cat") in LAUNCH_CATEGORIES and "ts" in e
                      and (c := (e.get("args") or {}).get("correlation")) in device_us)
    starts = [t for t, _, _ in launches]
    spans = [e for e in events
             if e.get("cat") == SPAN_CATEGORY and e.get("ph") == "X" and "dur" in e]
    lanes = defaultdict(set)
    for e in spans:
        ids = set((e.get("args") or {}).get("threads") or ()) | {e.get("tid")}
        for t in ids:
            lanes[t] |= ids
    table = defaultdict(lambda: {"host_us": 0.0, "count": 0, "device_us": 0.0})
    for e in spans:
        row = table[e["name"]]
        row["host_us"] += e["dur"]
        row["count"] += 1
        mine = lanes[e.get("tid")]
        lo, hi = bisect_left(starts, e["ts"]), bisect_right(starts, e["ts"] + e["dur"])
        row["device_us"] += sum(us for _, tid, us in launches[lo:hi] if tid in mine)
    return dict(table)


def summarize(path: str) -> dict:
    """{'device_by_op': {name: us}, 'device_count': {name: n}, 'category_of':
    {name: category}, 'by_category': {category: us}, 'device_total_us',
    'host_total_us', 'by_span': :func:`by_span`} of a Chrome trace."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    dev_by_op = defaultdict(float)
    dev_count = defaultdict(int)
    cat_of = {}
    by_cat = defaultdict(float)
    host_total = 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = DEVICE_CATEGORIES.get(e.get("cat"))
        if cat is None:
            host_total += e["dur"]
            continue
        name = e["name"]
        dev_by_op[name] += e["dur"]
        dev_count[name] += 1
        cat_of[name] = cat
        by_cat[cat] += e["dur"]
    return {"device_by_op": dict(dev_by_op), "device_count": dict(dev_count),
            "category_of": cat_of, "by_category": dict(by_cat),
            "device_total_us": sum(dev_by_op.values()), "host_total_us": host_total,
            "by_span": by_span(events)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    path = find_trace(argv[0])
    top_n = int(argv[1]) if len(argv) > 1 else 30
    print(f"trace: {path}")
    s = summarize(path)
    dev_total = s["device_total_us"]
    print(f"device leaf total: {dev_total / 1e3:.1f} ms   host slices total: "
          f"{s['host_total_us'] / 1e3:.1f} ms")
    print("\nby category:")
    for c, d in sorted(s["by_category"].items(), key=lambda kv: -kv[1]):
        if d > dev_total * 0.002:
            print(f"  {c:30s} {d / 1e3:8.1f} ms {100 * d / max(dev_total, 1e-9):5.1f}%")
    print(f"\n{'device op':58s} {'ms':>9s} {'x':>5s} {'%':>6s}  category")
    for name, dur in sorted(s["device_by_op"].items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"{name[:58]:58s} {dur / 1e3:9.2f} {s['device_count'][name]:5d} "
              f"{100 * dur / max(dev_total, 1e-9):6.1f}  {s['category_of'][name][:24]}")
    if s["by_span"]:
        print(f"\n{'span':40s} {'host s':>9s} {'x':>5s} {'device s':>9s}")
        for name, row in sorted(s["by_span"].items(), key=lambda kv: -kv[1]["host_us"]):
            print(f"{name[:40]:40s} {row['host_us'] / 1e6:9.4f} {row['count']:5d} "
                  f"{row['device_us'] / 1e6:9.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
