"""Reconstruction containers on disk (``--save-per-chunk``).

Port of ``save_reconstruction`` / ``load_reconstruction`` of
``pi3_slam_tpu/sfm/serialization.py``: the same npz keys, so either package
reads the other's files.
"""

from __future__ import annotations

import os

import numpy as np

from .reconstruction import ChunkReconstruction

_ARRAYS = ("rotations", "centers", "intrinsics", "points", "colors", "track_frame", "track_kp",
           "track_uv", "track_valid", "obs_frame", "obs_uv", "obs_valid")


def save_reconstruction(recon: ChunkReconstruction, path: str) -> None:
    """Write a ChunkReconstruction to a compressed .npz."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, frame_names=np.asarray(recon.frame_names),
                        image_width=recon.image_width, image_height=recon.image_height,
                        **{k: getattr(recon, k) for k in _ARRAYS})


def load_reconstruction(path: str) -> ChunkReconstruction:
    with np.load(path, allow_pickle=False) as z:
        return ChunkReconstruction(
            frame_names=[str(n) for n in z["frame_names"]],
            image_width=int(z["image_width"]),
            image_height=int(z["image_height"]),
            **{k: z[k] for k in _ARRAYS},
        )
