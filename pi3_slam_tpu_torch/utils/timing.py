"""Wall-clock stage timing: per-stage totals, counts and averages, printed
sorted by total. Port of ``pi3_slam_tpu/utils/timing.py``."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class TimingStats:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    @contextlib.contextmanager
    def track(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

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
