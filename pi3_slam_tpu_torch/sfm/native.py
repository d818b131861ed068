"""Host bookkeeping of the SfM path in numpy: cross-chunk track matching and
observation assembly.

Port of ``pi3_slam_tpu/sfm/native.py``. The JAX package runs these in a C++
library (``cpp/sfmcore.cpp``) when it builds, with numpy versions of the same
semantics beside it; the port keeps the numpy versions only and loads no
native code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def match_tracks(
    track_frame_a: np.ndarray,
    track_uv_a: np.ndarray,
    track_valid_a: np.ndarray,
    track_frame_b: np.ndarray,
    track_uv_b: np.ndarray,
    track_valid_b: np.ndarray,
    frame_map_b_to_a: np.ndarray,
    quantize: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Common tracks of two reconstructions: live tracks whose owner frames
    correspond (``frame_map_b_to_a``, -1 = none) and whose keypoint uv agree
    after rounding to ``quantize`` pixels. Returns (index in a, index in b),
    in b's order; where two tracks of a share a key the first one is kept,
    as ``cpp/sfmcore.cpp`` does."""
    qa = np.round(np.asarray(track_uv_a, np.float64) / quantize).astype(np.int64)
    qb = np.round(np.asarray(track_uv_b, np.float64) / quantize).astype(np.int64)
    fmap = np.asarray(frame_map_b_to_a)
    index: dict = {}
    for t in np.nonzero(np.asarray(track_valid_a) > 0)[0]:
        index.setdefault((int(track_frame_a[t]), int(qa[t, 0]), int(qa[t, 1])), int(t))
    ia, ib = [], []
    for t in np.nonzero(np.asarray(track_valid_b) > 0)[0]:
        fb = int(track_frame_b[t])
        if fb < 0 or fb >= len(fmap) or fmap[fb] < 0:
            continue
        hit = index.get((int(fmap[fb]), int(qb[t, 0]), int(qb[t, 1])))
        if hit is not None:
            ia.append(hit)
            ib.append(int(t))
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def build_observations(
    points: np.ndarray,  # (N, K, 3) world points of each frame's keypoints
    r_cw: np.ndarray,  # (N, 3, 3)
    centers: np.ndarray,  # (N, 3)
    intr: np.ndarray,  # (N, 4) fx fy cx cy
    cand: np.ndarray,  # (N, C) candidate frames, -1 padded
    width: float,
    height: float,
    obs_frame: np.ndarray,  # (N*K, M) int, slot 0 prefilled
    obs_uv: np.ndarray,  # (N*K, M, 2) float64
    obs_valid: np.ndarray,  # (N*K, M) float64
) -> None:
    """Fill observation slots 1..C in place: each frame's keypoint points
    projected into its candidate frames, valid where in front of the camera
    and inside the image."""
    n, k = points.shape[:2]
    for f in range(n):
        c = cand[f][cand[f] >= 0]
        if c.size == 0:
            continue
        xc = np.einsum("cij,ckj->cki", r_cw[c], points[f][None] - centers[c][:, None])
        z = xc[..., 2]
        z_safe = np.where(np.abs(z) < 1e-12, 1e-12, z)
        u = intr[c, 0][:, None] * xc[..., 0] / z_safe + intr[c, 2][:, None]
        v = intr[c, 1][:, None] * xc[..., 1] / z_safe + intr[c, 3][:, None]
        inb = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        rows = slice(f * k, (f + 1) * k)
        obs_frame[rows, 1 : 1 + c.size] = c[None, :]
        obs_uv[rows, 1 : 1 + c.size, 0] = u.T
        obs_uv[rows, 1 : 1 + c.size, 1] = v.T
        obs_valid[rows, 1 : 1 + c.size] = inb.T
