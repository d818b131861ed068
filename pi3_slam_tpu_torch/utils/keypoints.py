"""Grid keypoints. Port of ``grid_spacing`` / ``grid_keypoints`` from
``pi3_slam_tpu/utils/keypoints.py`` (that module imports JAX): auto spacing
sqrt(effective_area / max_kp) clamped to [8, min(H, W) / 4], 5% margins, and
a subsample to max_kp seeded by (H, W), so every frame of every chunk at one
resolution gets the same keypoint set.
"""

from __future__ import annotations

import numpy as np


def grid_spacing(H: int, W: int, max_num_keypoints: int) -> int:
    margin = min(H, W) * 0.05
    eff_h = H - 2 * margin
    eff_w = W - 2 * margin
    if eff_h <= 0 or eff_w <= 0:
        return max(H, W)
    s = int(np.sqrt((eff_h * eff_w) / max_num_keypoints))
    return max(8, min(s, min(H, W) // 4))


def grid_keypoints(H: int, W: int, max_num_keypoints: int = 1000) -> np.ndarray:
    """(K, 2) float32 (x, y) grid keypoint coordinates for an HxW image."""
    s = grid_spacing(H, W, max_num_keypoints)
    margin = min(H, W) * 0.05
    xs = np.arange(margin, W - margin, s)
    ys = np.arange(margin, H - margin, s)
    if len(xs) == 0 or len(ys) == 0:
        return np.array([[W // 2, H // 2]], dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)
    if len(coords) > max_num_keypoints:
        rng = np.random.default_rng(H * 1_000_003 + W)  # deterministic per size
        idx = rng.permutation(len(coords))[:max_num_keypoints]
        coords = coords[np.sort(idx)]
    return coords
