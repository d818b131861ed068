"""Synthetic multi-chunk scenes with known ground truth, in numpy.

A smooth forward trajectory with yaw (and a sideways sway) through a field of
landmarks; each chunk is written in its own random Sim3 gauge (the scale
doubling as metric-scale drift between chunks), with pixel and point noise.
The generator of the JAX package's system APE gates
(``tests/test_system_ape.py``), kept here so that the port's tools need
neither JAX nor the tests: for the same ``rng`` it writes the same arrays.

``EVAL_SCALE`` is the 7-Scenes protocol's shape (reference
``scripts/eval_7scenes.sh:59-181``: chunks of 100 with overlap 20 and 400
keypoints, 420 frames giving five chunks) with confidence-correlated
outliers: the scene of ``perf_online_floor``, ``ablate_observation_fan``
and ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy.spatial.transform import Rotation

from ..data.datasets import chunk_windows

EVAL_SCALE = dict(n_frames=420, n_landmarks=5000, chunk_length=100, overlap=20, n_kp=400,
                  noise_px=0.4, step=0.08, yaw_rate=0.0007, conf_outliers=True)


def make_synthetic_sequence(rng, n_frames=14, n_landmarks=300, width=640, height=480, step=0.4,
                            yaw_rate=0.02, sway=0.05, sway_rate=0.4):
    """Smooth forward trajectory with yaw and a sideways sway of amplitude
    ``sway``, landmarks ahead of the cameras. Returns (K, centers,
    cam-to-world rotations, landmarks)."""
    f = 500.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]])
    i = np.arange(n_frames)
    centers = np.stack([step * i, sway * np.sin(i * sway_rate), 0.05 * step * i], axis=1)
    rots = np.stack([Rotation.from_euler("y", yaw_rate * j).as_matrix() for j in i])
    landmarks = np.stack(
        [
            rng.uniform(-4, 4 + step * n_frames, n_landmarks),
            rng.uniform(-3, 3, n_landmarks),
            rng.uniform(4, 10, n_landmarks),
        ],
        axis=1,
    )
    return K, centers, rots, landmarks


def project(K, R_wc, center, pts):
    """R_wc: cam-to-world rotation. Returns (uv, z)."""
    cam = (pts - center) @ R_wc  # = R_cw @ (p - c)
    z = cam[:, 2]
    uv = np.stack([K[0, 0] * cam[:, 0] / z + K[0, 2], K[1, 1] * cam[:, 1] / z + K[1, 2]], axis=1)
    return uv, z


def write_synthetic_chunks(out, rng, n_frames=14, n_landmarks=300, chunk_length=6, overlap=2,
                           n_kp=120, noise_px=0.3, step=0.4, yaw_rate=0.02, conf_outliers=False,
                           frame_name_fn=None, width=640, height=480, sway=0.05, sway_rate=0.4):
    """Write ``<out>/chunks/chunk_XXXXXX.npz`` and ``<out>/chunk_metadata.json``
    of a synthetic scene; returns the true camera centers (n_frames, 3).

    conf_outliers: per-keypoint confidence in [0.2, 1]; pixel and 3D noise
    scale with (1.5 - conf), and low-confidence keypoints occasionally become
    gross outliers (tens of px and a corrupted 3D point), the error structure
    of real Pi3 confidence maps. Frame i is named frame_{i:04d}.png or
    ``frame_name_fn(i)``."""
    K, centers, rots, landmarks = make_synthetic_sequence(
        rng, n_frames=n_frames, n_landmarks=n_landmarks, width=width, height=height, step=step,
        yaw_rate=yaw_rate, sway=sway, sway_rate=sway_rate)
    chunks_dir = os.path.join(out, "chunks")
    os.makedirs(chunks_dir, exist_ok=True)
    name = frame_name_fn or (lambda i: f"frame_{i:04d}.png")
    for ci, (s, e) in enumerate(chunk_windows(len(centers), chunk_length, overlap)):
        frames = list(range(s, e))
        nf = len(frames)
        # this chunk's gauge: a random Sim3 of its world
        g_s = rng.uniform(0.7, 1.4)
        g_R = Rotation.from_rotvec(rng.normal(size=3) * 0.1).as_matrix()
        g_t = rng.normal(size=3) * 0.5

        kps = np.zeros((nf, n_kp, 2), np.float32)
        pts = np.zeros((nf, n_kp, 3), np.float32)
        confs = np.ones((nf, n_kp, 1), np.float32)
        poses = np.tile(np.eye(4), (nf, 1, 1))
        for j, fidx in enumerate(frames):
            uv, z = project(K, rots[fidx], centers[fidx], landmarks)
            vis = ((z > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < width - 5) & (uv[:, 1] > 5)
                   & (uv[:, 1] < height - 5))
            # the same landmark subset for a frame in every chunk that holds it
            # (the grid extractor's property)
            sel_rng = np.random.default_rng(fidx)
            vis_ids = np.nonzero(vis)[0]
            sel = vis_ids[sel_rng.permutation(len(vis_ids))[:n_kp]]
            sel = np.concatenate([sel, np.repeat(sel[-1:], n_kp - len(sel))])
            if conf_outliers:
                conf = sel_rng.uniform(0.2, 1.0, n_kp)
                confs[j, :, 0] = conf
                px_sigma = noise_px * (1.5 - conf)[:, None]
                pt_sigma = 0.005 * (1.5 - conf)[:, None]
                gross = (conf < 0.4) & (sel_rng.uniform(size=n_kp) < 0.15)
            else:
                px_sigma = noise_px
                pt_sigma = 0.005
                gross = np.zeros(n_kp, bool)
            kps[j] = uv[sel] + sel_rng.normal(size=(n_kp, 2)) * px_sigma
            # world points in the chunk's gauge
            pw = g_s * landmarks[sel] @ g_R.T + g_t
            pts[j] = pw + rng.normal(size=pw.shape) * pt_sigma
            if gross.any():
                kps[j, gross] += sel_rng.normal(size=(gross.sum(), 2)) * 40.0
                pts[j, gross] += rng.normal(size=(gross.sum(), 3)) * (2.0 * g_s)
            poses[j, :3, :3] = g_R @ rots[fidx]
            poses[j, :3, 3] = g_s * g_R @ centers[fidx] + g_t

        np.savez_compressed(
            os.path.join(chunks_dir, f"chunk_{ci:06d}.npz"),
            keypoints=kps.astype(np.float16),
            points=pts.astype(np.float16),
            colors=np.full((nf, n_kp, 3), 128, np.uint8),
            camera_poses=poses.astype(np.float32),
            camera_poses_cw=np.linalg.inv(poses).astype(np.float32),
            intrinsics=np.tile(K, (nf, 1, 1)).astype(np.float32),
            image_paths=np.asarray([name(i) for i in frames]),
            original_width=width,
            original_height=height,
            masks=np.ones((nf, n_kp), bool),
            conf=confs.astype(np.float16),
        )
    with open(os.path.join(out, "chunk_metadata.json"), "w") as f:
        json.dump({"chunk_length": chunk_length, "overlap": overlap,
                   "target_size": [height, width]}, f)
    return centers


def write_reference_pt_chunks(src, n=4, k=30):
    """A chunk directory in the reference's torch-pickle layout
    (``slam/offline_chunk_creator.py:204-328``): two chunks of ``n`` frames
    and ``k`` keypoints sharing 2 frames, random points 5 m ahead, with a
    manifest and metadata; the input of ``import_reference_chunks``. The same
    files as the ``reference_chunk_dir`` fixture of
    ``tests/test_import_reference_chunks.py``."""
    import torch

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(src, "chunks"))
    shared_kp = rng.uniform(5, 50, (n, k, 2)).astype(np.float32)

    def intrinsics():
        return torch.from_numpy(np.tile(np.array([[100.0, 0, 28], [0, 100.0, 28], [0, 0, 1]],
                                                 np.float32), (n, 1, 1)))

    manifest = []
    for ci in range(2):
        poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
        poses[:, 0, 3] = np.linspace(0, 1, n) + ci * 0.5
        pts = rng.normal(0, 1, (n, k, 3)) + [0, 0, 5]
        start = ci * (n - 2)
        paths = [f"frame_{start + i:04d}.png" for i in range(n)]
        torch.save({
            "points": torch.from_numpy(pts.astype(np.float16)),
            "local_points": torch.from_numpy(pts.astype(np.float16)),
            "conf": torch.from_numpy(rng.uniform(0.5, 1, (n, k, 1)).astype(np.float16)),
            "masks": torch.from_numpy(np.ones((n, k), bool)),
            "keypoints": torch.from_numpy(shared_kp.astype(np.float16)),
            "colors": torch.from_numpy(rng.uniform(0, 255, (n, k, 3)).astype(np.float16)),
            "camera_poses": torch.from_numpy(poses.astype(np.float32)),
            "camera_params": {"intrinsics": intrinsics()}, "intrinsics": intrinsics(),
            "image_paths": paths, "original_width": 56, "original_height": 56,
            "chunk_index": ci, "start_idx": start, "end_idx": start + n,
        }, os.path.join(src, "chunks", f"chunk_{ci:06d}.pt"))
        manifest.append({"chunk_index": ci, "file": f"chunk_{ci:06d}.pt", "start_idx": start,
                         "end_idx": start + n, "num_frames": n, "image_paths": paths})
    with open(os.path.join(src, "chunks_manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(src, "chunk_metadata.json"), "w") as f:
        json.dump({"chunk_length": n, "overlap": 2, "target_size": [56, 56]}, f)
