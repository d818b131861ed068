"""Per-frame timestamps from image filenames or video metadata. Port of
``pi3_slam_tpu/utils/timestamps.py``: a 16-19 digit run in the filename is
nanoseconds, 10-13 digits are seconds / milliseconds scaled to ns; a
(video_path, frame_idx) tuple is frame_idx / fps; otherwise the file's mtime,
and the frame index as the last resort.
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence

_DIGITS = re.compile(r"(\d{10,19})")


def _filename_timestamp_ns(path: str):
    stem = os.path.splitext(os.path.basename(path))[0]
    m = _DIGITS.search(stem)
    if not m:
        return None
    val = int(m.group(1))
    n = len(m.group(1))
    if 16 <= n <= 19:  # already nanoseconds
        return val
    if n == 10:  # seconds
        return val * 1_000_000_000
    if n in (12, 13):  # milliseconds
        return val * 1_000_000
    if n == 11:
        return val * 100_000_000
    return None


_VIDEO_FPS_CACHE: dict = {}


def _video_fps(video_path: str) -> float:
    if video_path not in _VIDEO_FPS_CACHE:
        import cv2

        cap = cv2.VideoCapture(video_path)
        try:
            fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        finally:
            cap.release()
        _VIDEO_FPS_CACHE[video_path] = fps
    return _VIDEO_FPS_CACHE[video_path]


def extract_timestamps_from_paths(paths: Sequence) -> List[int]:
    """Per-frame timestamps in nanoseconds."""
    out: List[int] = []
    for p in paths:
        if isinstance(p, tuple):
            video_path, frame_idx = p
            out.append(int(frame_idx / _video_fps(str(video_path)) * 1e9))
            continue
        ts = _filename_timestamp_ns(str(p))
        if ts is None:
            try:
                ts = int(os.path.getmtime(p) * 1e9)
            except OSError:
                ts = len(out)  # last resort: the frame index
        out.append(ts)
    return out
