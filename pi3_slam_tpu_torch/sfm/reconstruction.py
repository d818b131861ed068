"""Chunk reconstruction: fixed-shape track / observation arrays from a chunk's
keypoints and Pi3 geometry, then bundle adjustment and outlier pruning.

Port of ``pi3_slam_tpu/sfm/reconstruction.py``. Every keypoint spawns a track
holding its Pi3 world point; its observations are the keypoint in its own
frame plus the point's projection into earlier frames and the next
max_obs // 2 frames where in bounds. The "subsampled" fan spreads the earlier
frames evenly over the max_observations_per_track budget (a fixed width M);
the "unbounded" fan takes every earlier frame (the reference's literal fan).

The container is numpy on the host; the solves run on the device the caller
names (``device``), in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .ba import BAProblem, make_problem, prune_outlier_tracks, reprojection_errors, run_bundle_adjust
from .native import build_observations


@dataclasses.dataclass
class ChunkReconstruction:
    """One chunk's reconstruction on the host (numpy)."""

    frame_names: List[str]
    rotations: np.ndarray  # (N, 3, 3) world -> camera
    centers: np.ndarray  # (N, 3) camera centers
    intrinsics: np.ndarray  # (N, 4) fx fy cx cy
    points: np.ndarray  # (T, 3) world track points
    colors: np.ndarray  # (T, 3) float [0, 1]
    track_frame: np.ndarray  # (T,) owner frame index
    track_kp: np.ndarray  # (T,) keypoint index within the owner frame
    track_uv: np.ndarray  # (T, 2) keypoint pixel coords in the owner frame
    track_valid: np.ndarray  # (T,) float 1/0
    obs_frame: np.ndarray  # (T, M)
    obs_uv: np.ndarray  # (T, M, 2)
    obs_valid: np.ndarray  # (T, M)
    image_width: int
    image_height: int
    # (T, dim) L2-normalised keypoint descriptors (ALIKED chunks); None for
    # grid keypoints
    track_desc: np.ndarray | None = None

    @property
    def num_frames(self) -> int:
        return len(self.frame_names)

    @property
    def num_tracks(self) -> int:
        return self.points.shape[0]

    def to_problem(self, priors: dict | None = None, device="cpu") -> BAProblem:
        return make_problem(self.rotations, self.centers, self.points, self.intrinsics,
                            self.obs_frame, self.obs_uv, self.obs_valid, self.track_valid,
                            device=device, **(priors or {}))

    def update_from_problem(self, p: BAProblem) -> None:
        self.rotations = p.rotations.cpu().numpy()
        self.centers = p.centers.cpu().numpy()
        self.points = p.points.cpu().numpy()
        self.track_valid = p.track_valid.cpu().numpy()
        self.intrinsics = p.intrinsics.cpu().numpy()


def _intrinsics_to_fxfycxcy(K: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N, 4)."""
    return np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], axis=-1)


def _default_intrinsics(n: int, width: int, height: int) -> np.ndarray:
    """The reference's default: f = max(W, H), principal point at the center."""
    f = float(max(width, height))
    return np.tile(np.array([f, f, width / 2.0, height / 2.0]), (n, 1))


def _candidate_frames(f: int, n: int, max_obs: int, unbounded: bool = False) -> np.ndarray:
    """Earlier frames + the next max_obs // 2; the earlier ones evenly
    subsampled to the budget unless ``unbounded``."""
    after = list(range(f + 1, min(n, f + 1 + max_obs // 2)))
    before = list(range(f))
    if not unbounded:
        budget = max(0, max_obs - 1 - len(after))
        if len(before) > budget:
            idx = np.linspace(0, len(before) - 1, budget).round().astype(int)
            before = [before[i] for i in np.unique(idx)] if budget else []
    return np.array(before + after, dtype=np.int64)


def _frame_names(paths, n: int) -> List[str]:
    names = []
    for i in range(n):
        if paths is None:
            names.append(f"frame_{i}")
            continue
        pth = paths[i]
        if isinstance(pth, np.ndarray):
            pth = pth.tolist()
        if isinstance(pth, (list, tuple)):
            # video frame (video_path, frame_idx): the index is the identity
            if len(pth) == 2:
                names.append(f"{str(pth[0]).split('/')[-1]}#{pth[1]}")
                continue
            pth = pth[0] if pth else f"frame_{i}"
        names.append(str(pth).split("/")[-1])
    return names


def build_chunk_reconstruction(
    chunk: Dict,
    max_observations_per_track: int = 10,
    run_ba: bool = True,
    ba_iterations: int = 10,
    huber_delta: float = 2.0,
    prune_max_reproj_px: float = 2.0,
    prune_min_tri_angle_deg: float = 0.25,
    use_inverse_depth: bool = False,
    optimize_focal: bool = False,
    observation_fan: str = "subsampled",
    device="cuda",
) -> ChunkReconstruction:
    """Build (and bundle-adjust on ``device``) a reconstruction from chunk
    data: 'keypoints' (N, K, 2), 'points' (N, K, 3) world keypoint points,
    'colors' (N, K, 3), 'camera_poses' (N, 4, 4) camera-to-world, and
    optionally 'intrinsics' (N, 3, 3), 'image_paths',
    'original_width' / 'original_height', 'keypoint_valid' (N, K),
    'descriptors' (N, K, dim) and stored observations ('obs_frame',
    'obs_uv', 'obs_valid')."""
    kp = np.asarray(chunk["keypoints"], np.float64)
    pts = np.asarray(chunk["points"], np.float64)
    colors = np.asarray(chunk.get("colors", np.zeros_like(pts)), np.float64)
    poses = np.asarray(chunk["camera_poses"], np.float64)
    N, K = kp.shape[:2]
    width = int(chunk["original_width"])
    height = int(chunk["original_height"])
    names = _frame_names(chunk.get("image_paths"), N)

    R_cw = np.transpose(poses[:, :3, :3], (0, 2, 1))
    centers = poses[:, :3, 3].copy()
    if chunk.get("intrinsics") is not None:
        intr = _intrinsics_to_fxfycxcy(np.asarray(chunk["intrinsics"], np.float64))
        # the focal estimate can be negative or degenerate on low-confidence
        # pointmaps: those frames take the default intrinsics
        bad = (intr[:, 0] <= 1.0) | (intr[:, 1] <= 1.0) | ~np.isfinite(intr[:, :2]).all(1)
        if bad.any():
            intr[bad] = _default_intrinsics(int(bad.sum()), width, height)
    else:
        intr = _default_intrinsics(N, width, height)

    unbounded = observation_fan == "unbounded"
    M = max_observations_per_track
    if unbounded:  # the last frame sees all N-1 earlier frames (+ itself)
        M = max(M, N - 1 + max_observations_per_track // 2 + 1)
    T = N * K
    track_frame = np.repeat(np.arange(N), K)
    track_kp = np.tile(np.arange(K), N)
    track_uv = kp.reshape(T, 2)
    # ALIKED's sub-threshold filler slots enter as dead tracks
    kp_valid = chunk.get("keypoint_valid")
    track_valid = (np.asarray(kp_valid, bool).reshape(T).astype(np.float32)
                   if kp_valid is not None else np.ones(T, np.float32))
    desc = chunk.get("descriptors")
    track_desc = (np.ascontiguousarray(np.asarray(desc, np.float32).reshape(T, -1))
                  if desc is not None else None)

    stored_obs = chunk.get("obs_frame")
    if stored_obs is not None:
        # refined observations stored by the chunk creator: their fan width
        # supersedes max_observations_per_track; slot 0 comes from the tracks
        M = np.asarray(stored_obs).shape[-1]
        obs_frame = np.array(stored_obs, np.int32).reshape(T, M)
        obs_uv = np.array(chunk["obs_uv"], np.float64).reshape(T, M, 2)
        obs_valid = np.array(chunk["obs_valid"], np.float64).reshape(T, M)
        obs_frame[:, 0] = track_frame
        obs_uv[:, 0] = track_uv
        obs_valid[:, 0] = 1.0
    else:
        obs_frame = np.zeros((T, M), np.int32)
        obs_uv = np.zeros((T, M, 2), np.float64)
        obs_valid = np.zeros((T, M), np.float64)
        obs_frame[:, 0] = track_frame
        obs_uv[:, 0] = track_uv
        obs_valid[:, 0] = track_valid
        cand_table = np.full((N, M - 1), -1, np.int64)
        for f in range(N):
            cand = _candidate_frames(f, N, max_observations_per_track, unbounded)
            cand_table[f, : cand.size] = cand
        build_observations(pts, R_cw, centers, intr, cand_table, width, height, obs_frame,
                           obs_uv, obs_valid)
    # dead tracks contribute no observation anywhere
    obs_valid *= track_valid[:, None]

    recon = ChunkReconstruction(
        frame_names=names,
        rotations=R_cw.astype(np.float32),
        centers=centers.astype(np.float32),
        intrinsics=intr.astype(np.float32),
        points=pts.reshape(T, 3).astype(np.float32),
        colors=colors.reshape(T, 3).astype(np.float32),
        track_frame=track_frame.astype(np.int32),
        track_kp=track_kp.astype(np.int32),
        track_uv=track_uv.astype(np.float32),
        track_valid=track_valid,
        obs_frame=obs_frame.astype(np.int32),
        obs_uv=obs_uv.astype(np.float32),
        obs_valid=obs_valid.astype(np.float32),
        image_width=width,
        image_height=height,
        track_desc=track_desc,
    )
    if run_ba:
        prob = run_bundle_adjust(recon.to_problem(device=device), ba_iterations, huber_delta,
                                 optimize_focal=optimize_focal, use_inverse_depth=use_inverse_depth,
                                 tracks_per_frame=K)
        prob = prob._replace(track_valid=prune_outlier_tracks(prob, prune_max_reproj_px,
                                                              prune_min_tri_angle_deg))
        recon.update_from_problem(prob)
    return recon


def reconstruction_stats(recon: ChunkReconstruction) -> Dict:
    """View / live-track / observation counts and reprojection error
    statistics (the reference's print_reconstruction_stats), on the host."""
    err = reprojection_errors(recon.to_problem()).numpy()
    finite = np.isfinite(err)
    return {
        "num_views": recon.num_frames,
        "num_tracks": int(recon.track_valid.sum()),
        "num_observations": int(finite.sum()),
        "mean_reprojection_error": float(err[finite].mean()) if finite.any() else float("nan"),
        "median_reprojection_error": (float(np.median(err[finite])) if finite.any()
                                      else float("nan")),
    }

