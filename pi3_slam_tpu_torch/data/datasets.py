"""Chunk windowing and threaded prefetch.

Port of ``pi3_slam_tpu/data/datasets.py``: host threads decode and resize
the next chunks while the device runs the current one, and hand them over
in order.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Sequence, Tuple

from ..utils.timing import span
from .image_io import load_images


def chunk_windows(n_frames: int, chunk_length: int, overlap: int) -> List[Tuple[int, int]]:
    """[start, end) windows with stride chunk_length - overlap, >= 2 frames each."""
    out = []
    start = 0
    while start < n_frames:
        end = min(start + chunk_length, n_frames)
        if end - start >= 2:
            out.append((start, end))
        start += chunk_length - overlap
    return out


class ChunkDataset:
    """Map-style dataset over chunk windows of image paths or (video_path,
    frame_idx) tuples; yields dicts with (N, 3, H, W) uint8 images, paths,
    and the window indices."""

    def __init__(
        self,
        image_paths: Sequence,
        chunk_length: int,
        overlap: int,
        target_size: Tuple[int, int],
        undistorter=None,
    ):
        self.image_paths = list(image_paths)
        self.target_size = target_size
        self.undistorter = undistorter
        self.windows = chunk_windows(len(self.image_paths), chunk_length, overlap)

    def __len__(self) -> int:
        return len(self.windows)

    def __getitem__(self, idx: int) -> dict:
        start, end = self.windows[idx]
        paths = self.image_paths[start:end]
        with span("loader.decode", chunk=idx):  # on the prefetch threads
            images = load_images(paths, self.target_size, self.undistorter)
        # a video frame is named "<video_path>#<frame_idx>"
        return {"chunk_idx": idx, "start": start, "end": end, "images": images,
                "paths": [f"{p[0]}#{p[1]}" if isinstance(p, tuple) else p for p in paths]}


class PrefetchLoader:
    """Threaded look-ahead iterator over a dataset, delivering items in order."""

    def __init__(self, dataset, num_workers: int = 2, prefetch: int = 2):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        if n == 0:
            return
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        idx_q: queue.Queue = queue.Queue()
        for i in range(n):
            idx_q.put(i)
        error: list = []

        def worker():
            while True:
                try:
                    i = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    item = self.dataset[i]
                except Exception as e:  # handed to the consumer
                    error.append(e)
                    return
                out_q.put((i, item))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        # in-order delivery with an out-of-order side buffer
        results: dict = {}
        next_idx = 0
        received = 0
        while received < n:
            if error:
                raise error[0]
            try:
                i, item = out_q.get(timeout=0.5)
            except queue.Empty:
                if not any(t.is_alive() for t in threads) and out_q.empty() and not error:
                    raise RuntimeError("prefetch workers died before finishing")
                continue
            received += 1
            results[i] = item
            while next_idx in results:
                yield results.pop(next_idx)
                next_idx += 1
