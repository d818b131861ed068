"""The frames a cell's sequence is made of.

``make_frames`` is a frozen copy of the port's
``tools/perf_pipeline.make_frames``: moving crops of one noise texture,
written as PNGs (decoding them is real loader work). The set of distinct
frames is fixed by the traffic mix, is written once into a directory of
``TMPDIR`` and kept there; ``make_sequence`` lays the sequence a run gives
the program out as distinct per-index names, symlinks onto that set in an
order drawn from the seed, so every seed sends the same frames in another
order.
"""

from __future__ import annotations

import os
import shutil

import numpy as np


def make_frames(d: str, n: int, height: int = 480, width: int = 640) -> list:
    """Synthetic moving-texture PNGs. Frames that exist are kept; the missing
    ones are encoded on a few threads (PIL releases the GIL while it
    compresses)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (height, width * 2, 3)).astype(np.uint8)
    paths = [os.path.join(d, f"frame_{i:05d}.png") for i in range(n)]

    def write(i):
        off = (3 * i) % width
        tmp = paths[i] + ".part"
        Image.fromarray(base[:, off : off + width]).save(tmp, format="PNG")
        os.replace(tmp, paths[i])

    missing = [i for i, p in enumerate(paths) if not os.path.exists(p)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(write, missing))
    return paths


def sequence_order(seed: int, n_distinct: int, length: int) -> np.ndarray:
    """Indices into the distinct frames for a sequence of ``length``: whole
    permutations of the set drawn from the seed, one after another."""
    rng = np.random.default_rng([abs(seed), 1 if seed < 0 else 0, 17])
    reps = -(-length // n_distinct)
    return np.concatenate([rng.permutation(n_distinct) for _ in range(reps)])[:length]


def make_sequence(d: str, frames: list, order: np.ndarray) -> list:
    """Symlinks ``d/seq_<i>.png`` -> frames[order[i]], ``d`` made anew."""
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    paths = []
    for i, j in enumerate(order):
        p = os.path.join(d, f"seq_{i:06d}.png")
        os.symlink(frames[j], p)
        paths.append(p)
    return paths
