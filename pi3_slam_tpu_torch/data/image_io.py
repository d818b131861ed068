"""Image and video-frame loading and sizing.

Port of ``pi3_slam_tpu/data/image_io.py``:

* ``calculate_target_size`` scales the first image (or the video's frame
  size) under the pixel budget, snapped to multiples of 14;
* images load as (3, H, W) uint8 (the device step normalises them: a
  quarter of a float32 upload); downscaling uses OpenCV's INTER_AREA,
  upscaling INTER_LINEAR;
* a frame is an image path or a (video_path, frame_idx) tuple. Video frames
  decode through one persistent OpenCV decoder per thread (an LRU of four),
  read sequentially (grab ahead over small gaps, seek only for jumps); a
  chunk of one video's frames decodes in one sorted pass
  (``load_video_frames_bulk``). OpenCV is needed only once a video is
  opened.
"""

from __future__ import annotations

import math
import threading
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

try:
    import cv2

    # the prefetch loader already decodes files in parallel
    cv2.setNumThreads(0)
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def _require_cv2():
    if not _HAS_CV2:
        raise ImportError("video input needs OpenCV (the cv2 module), which is not installed")
    return cv2


def _probe_video(video_path: str, *props) -> list:
    """Metadata properties through a decoder that is released at once (a
    probe must not pin a persistent reader on the calling thread)."""
    cap = cv2.VideoCapture(str(video_path))
    try:
        if not cap.isOpened():
            raise IOError(f"failed to open video {video_path}")
        return [cap.get(p) for p in props]
    finally:
        cap.release()


def _first_image_dims(path) -> Tuple[int, int]:
    """(W, H) of an image path or a (video_path, frame_idx) tuple."""
    if isinstance(path, tuple):
        cv = _require_cv2()
        w, h = _probe_video(path[0], cv.CAP_PROP_FRAME_WIDTH, cv.CAP_PROP_FRAME_HEIGHT)
        return (int(w), int(h))
    with Image.open(path) as im:
        return im.size


def calculate_target_size(first_image_path, pixel_limit: int = 255000) -> Tuple[int, int]:
    """(H, W) target size: scaled under pixel_limit, multiples of 14."""
    W_orig, H_orig = _first_image_dims(first_image_path)
    scale = math.sqrt(pixel_limit / (W_orig * H_orig)) if W_orig * H_orig > 0 else 1
    W_target, H_target = W_orig * scale, H_orig * scale
    k, m = round(W_target / 14), round(H_target / 14)
    while (k * 14) * (m * 14) > pixel_limit:
        if k / m > W_target / H_target:
            k -= 1
        else:
            m -= 1
    return (max(1, m) * 14, max(1, k) * 14)


def _resize(img: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Resize an HWC image: INTER_AREA when downscaling, else linear."""
    h, w = img.shape[:2]
    th, tw = target_hw
    if (h, w) == (th, tw):
        return img
    if _HAS_CV2:
        interp = cv2.INTER_AREA if (th < h or tw < w) else cv2.INTER_LINEAR
        return cv2.resize(img, (tw, th), interpolation=interp)
    return np.asarray(Image.fromarray(img).resize((tw, th), Image.BILINEAR))


# counts VideoCapture constructions (tests read it)
VIDEO_OPEN_COUNT = {"n": 0}

# a forward gap this small is cheaper to grab() through than to seek (a seek
# restarts decoding at the previous keyframe)
_GRAB_AHEAD_MAX = 64
_READER_CACHE_MAX = 4  # open decoders kept per thread


class _VideoReader:
    """One persistent cv2.VideoCapture, read sequentially where it can."""

    def __init__(self, path: str):
        VIDEO_OPEN_COUNT["n"] += 1
        self.path = path
        self.cap = _require_cv2().VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"failed to open video {path}")
        self.next_idx = 0

    def read(self, frame_idx: int) -> np.ndarray:
        """Decode frame_idx -> RGB uint8 (H, W, 3)."""
        gap = frame_idx - self.next_idx
        if 0 < gap <= _GRAB_AHEAD_MAX:
            for _ in range(gap):
                self.cap.grab()
        elif gap != 0:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, int(frame_idx))
        ok, frame = self.cap.read()
        if not ok:
            # one retry through an explicit seek (some containers misreport
            # the position after long grab runs)
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, int(frame_idx))
            ok, frame = self.cap.read()
        if not ok:
            raise IOError(f"failed to read frame {frame_idx} from {self.path}")
        self.next_idx = frame_idx + 1
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def close(self):
        self.cap.release()


_thread_videos = threading.local()


def _video_reader(path: str) -> _VideoReader:
    """The calling thread's persistent reader of ``path`` (a VideoCapture is
    not thread-safe, so each loader thread owns its decoders), kept in a
    per-thread LRU of _READER_CACHE_MAX."""
    cache = getattr(_thread_videos, "cache", None)
    if cache is None:
        cache = _thread_videos.cache = {}
    reader = cache.pop(path, None)  # re-inserted below as the most recent
    if reader is None:
        if len(cache) >= _READER_CACHE_MAX:
            cache.pop(next(iter(cache))).close()  # the least recently used
        reader = _VideoReader(path)
    cache[path] = reader
    return reader


def read_video_frame(video_path: str, frame_idx: int) -> np.ndarray:
    """One RGB uint8 (H, W, 3) frame through the thread's persistent decoder."""
    return _video_reader(str(video_path)).read(int(frame_idx))


def _to_chw(img: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "uint8":
        return np.ascontiguousarray(img.transpose(2, 0, 1))
    return img.astype(np.float32).transpose(2, 0, 1) / 255.0


def load_video_frames_bulk(
    video_path: str,
    frame_indices: Sequence[int],
    target_hw: Tuple[int, int] | None = None,
    undistorter=None,
    dtype="float32",
) -> np.ndarray:
    """Frames of one video in one sequential pass -> (N, 3, H, W), float32 in
    [0, 1] or uint8: the indices are read in sorted order on one decoder and
    returned in the order asked; undistortion runs per frame before the
    resize."""
    order = np.argsort(np.asarray(frame_indices, np.int64), kind="stable")
    reader = _video_reader(str(video_path))
    out = [None] * len(frame_indices)
    for i in order:
        img = reader.read(int(frame_indices[i]))
        if undistorter is not None:
            img = undistorter.undistort_image(img)
        if target_hw is not None:
            img = _resize(img, target_hw)
        out[i] = _to_chw(img, dtype)
    return np.stack(out)


def load_image(path, target_hw: Tuple[int, int] | None = None, undistorter=None) -> np.ndarray:
    """One image or (video_path, frame_idx) frame -> (3, H, W) uint8."""
    if isinstance(path, tuple):
        img = read_video_frame(*path)
    else:
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
    if undistorter is not None:
        img = undistorter.undistort_image(img)
    if target_hw is not None:
        img = _resize(img, target_hw)
    return _to_chw(img, "uint8")


def load_images(paths: Sequence, target_hw: Tuple[int, int], undistorter=None) -> np.ndarray:
    """A chunk of frames -> (N, 3, H, W) uint8; a chunk of one video's
    frames goes through the bulk sequential decoder."""
    if len(paths) > 1 and all(isinstance(p, tuple) for p in paths) and len(
            {p[0] for p in paths}) == 1:
        return load_video_frames_bulk(paths[0][0], [p[1] for p in paths], target_hw,
                                      undistorter, dtype="uint8")
    return np.stack([load_image(p, target_hw, undistorter) for p in paths])


def list_video_frames(video_path: str, skip_start: int = 0, skip_end: int = 0, stride: int = 1):
    """[(video_path, frame_idx), ...] from skip_start to the frame count less
    skip_end, every stride-th frame (the online CLI's video mode)."""
    n = int(_probe_video(video_path, _require_cv2().CAP_PROP_FRAME_COUNT)[0])
    return [(str(video_path), i) for i in range(skip_start, n - skip_end, stride)]
