"""Keypoint extraction: grid and ALIKED. Port of
``pi3_slam_tpu/utils/keypoints.py``.

Grid keypoints: auto spacing sqrt(effective_area / max_kp) clamped to
[8, min(H, W) / 4], 5% margins, and a subsample to max_kp seeded by (H, W), so
every frame of every chunk at one resolution gets the same keypoint set.
``ALIKEDExtractor`` runs the port's ALIKED (``models/aliked.py``) on a
converted checkpoint; ``create_keypoint_extractor`` falls back to grid
keypoints with a printed warning when no checkpoint is given, as the JAX
factory does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


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


def _colors(images, keypoints: np.ndarray, device) -> np.ndarray:
    """uint8 (N, K, 3) colours sampled bilinearly at the keypoints."""
    from ..ops.interpolate import grid_sample_frames

    imgs = torch.as_tensor(images, device=device)
    maps = (imgs.float() / 255.0 if imgs.dtype == torch.uint8 else imgs.float()).permute(0, 2, 3, 1)
    cols = grid_sample_frames(maps, torch.as_tensor(keypoints, device=device), mode="bilinear")
    return (cols * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()


class GridKeypointExtractor:
    """Grid keypoints and their colours; the same keypoints for every frame
    of one size."""

    def __init__(self, max_num_keypoints: int = 1000, device="cuda"):
        self.max_num_keypoints = max_num_keypoints
        self.device = torch.device(device)

    def extract_with_colors(self, images) -> Dict[str, np.ndarray]:
        """images (N, 3, H, W) float [0, 1] or uint8 -> {'keypoints' (N, K, 2),
        'colors' (N, K, 3) uint8}."""
        N, _, H, W = images.shape
        kp = grid_keypoints(H, W, self.max_num_keypoints)
        kps = np.broadcast_to(kp[None], (N, kp.shape[0], 2)).astype(np.float32)
        return {"keypoints": kps, "colors": _colors(images, kps, self.device)}


class ALIKEDExtractor:
    """Learned keypoints and descriptors from a converted ALIKED ``.npz``
    (``tools/convert_checkpoint.py --model aliked``), on ``device``. Frames
    are run ``frame_batch`` at a time, which bounds the full-resolution
    multi-scale maps in device memory; the frames are independent, so the
    batching changes no output."""

    def __init__(self, checkpoint_path: str, max_num_keypoints: int = 1000,
                 detection_threshold: float = 0.005, frame_batch: int = 8, device="cuda"):
        from ..models.aliked import aliked_state_from_jax, build_aliked
        from ..models.convert import load_aliked_checkpoint

        tree, cfg = load_aliked_checkpoint(checkpoint_path)
        self.cfg = dataclasses.replace(cfg, detection_threshold=detection_threshold)
        self.device = torch.device(device)
        self.model = build_aliked(self.cfg, aliked_state_from_jax(tree), self.device)
        self.max_num_keypoints = max_num_keypoints
        self.frame_batch = max(1, frame_batch)

    def extract(self, images) -> Dict[str, np.ndarray]:
        """images (N, 3, H, W) float [0, 1] or uint8, numpy or a tensor (one
        on the device is used where it lies) -> {'keypoints' (N, K, 2),
        'descriptors' (N, K, dim), 'scores' (N, K), 'valid' (N, K)} on the
        host."""
        from ..models.aliked import aliked_extract

        images = torch.as_tensor(images)
        parts = []
        for start in range(0, images.shape[0], self.frame_batch):
            batch = images[start:start + self.frame_batch].to(self.device, non_blocking=True)
            out = aliked_extract(self.model, batch, self.max_num_keypoints)
            parts.append({k: v.cpu().numpy() for k, v in out.items()})
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def extract_with_colors(self, images) -> Dict[str, np.ndarray]:
        out = self.extract(images)
        out["colors"] = _colors(images, out["keypoints"], self.device)
        return out


def create_keypoint_extractor(kind: str = "grid", **kwargs):
    """'grid' or 'aliked'. ALIKED needs converted weights
    (``aliked_checkpoint_path``); without them it prints the JAX package's
    warning and returns grid keypoints (the reference's ALIKED -> grid
    degradation), never silently."""
    if kind not in ("grid", "aliked"):
        raise ValueError(f"unknown keypoint extractor: {kind}")
    device = kwargs.pop("device", "cuda")
    ckpt = kwargs.pop("aliked_checkpoint_path", None)
    threshold = kwargs.pop("detection_threshold", 0.005)
    if kind == "aliked":
        if ckpt:
            return ALIKEDExtractor(ckpt, max_num_keypoints=kwargs.get("max_num_keypoints", 1000),
                                   detection_threshold=threshold, device=device)
        print("ALIKED weights unavailable (pass --aliked-path with a converted "
              "checkpoint); falling back to grid keypoints")
    return GridKeypointExtractor(device=device, **kwargs)
