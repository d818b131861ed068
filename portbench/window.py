"""The measured window, driven by the stamps of the chunks a run completes.

Warm-up: the first ``warmup`` completions (the process's first chunk builds
and loads kernels; the second still finds lazy set-up). Their end is the end
of set-up. In a traced run the next ``trace_chunks`` completions run under
the profiler, which stops before the window opens. The window opens at a
completion and closes at the first completion ``seconds`` or more after it;
every chunk completed in between, and all the time, is the window's.
"""

from __future__ import annotations

import time


class Window:
    def __init__(self, seconds: float, warmup: int, trace_chunks: int = 0,
                 start_trace=None, stop_trace=None):
        self.seconds = seconds
        self.warmup = warmup
        self.trace_chunks = trace_chunks
        self.start_trace, self.stop_trace = start_trace, stop_trace
        self.done = 0  # completions so far
        self.setup_end = None  # perf_counter at the end of warm-up
        self.traced = []  # chunk records completed under the profiler
        self.t_open = self.t_close = None
        self.chunks = []  # chunk records completed in the window
        self.closed = False

    def completed(self, t: float, record: dict) -> bool:
        """Note a completion stamped at ``t``; True once the window closed."""
        self.done += 1
        if self.done <= self.warmup:
            if self.done == self.warmup:
                self.setup_end = t
                self._after_warmup(t)
            return False
        if self.t_open is None:  # a traced chunk
            self.traced.append(record)
            if len(self.traced) == self.trace_chunks:
                self.stop_trace()
                self.t_open = time.perf_counter()
            return False
        self.chunks.append(record)
        if t - self.t_open >= self.seconds:
            self.t_close = t
            self.closed = True
        return self.closed

    def _after_warmup(self, t: float):
        if self.trace_chunks:
            self.start_trace()
        else:
            self.t_open = t

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open
