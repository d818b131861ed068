"""Chunk-to-chunk Sim3 alignment with pose-prior-constrained refinement.

Port of ``pi3_slam_tpu/sfm/alignment.py``:

1. tracks common to both chunks through their shared frames, keyed by
   (frame name, keypoint pixel position) — overlap frames carry the same grid
   keypoints — plus a mutual-nearest-neighbour descriptor match where both
   chunks carry descriptors;
2. common points farther from the reference chunk's last camera than the
   median distance are dropped;
3. a Huber-IRLS Sim3 fit (width 1.0, 5 iterations) or, with fewer than
   ``min_common_tracks`` common tracks, the Sim3 of the shared frames' camera
   poses;
4. the query reconstruction is transformed;
5. a pose-prior BA of the query chunk (overlap views pulled toward the
   reference poses, orientation cov 2 I, position cov 25 I; 50 iterations,
   Huber 3.0), then outlier pruning (3 px, 0.25 deg).

The Sim3 fits and the BA run on ``device`` in fp32. The JAX version padded the
correspondences to a power-of-two bucket so that its jitted fit compiled once;
eager PyTorch has no recompile cost, so the fit takes the exact count.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..geometry.sim3 import Sim3, robust_umeyama, sim3_from_camera_poses, sim3_identity
from .ba import prune_outlier_tracks, run_bundle_adjust
from .native import match_tracks
from .reconstruction import ChunkReconstruction


@dataclasses.dataclass
class AlignmentResult:
    sim3: Sim3
    num_common_tracks: int
    num_used_tracks: int
    success: bool
    # "tracks": the common-track Sim3; "poses": the shared-frame camera-pose
    # fallback when too few common tracks survive
    method: str = "tracks"


def mutual_nn_match(query_desc: np.ndarray, ref_desc: np.ndarray,
                    min_cosine: float) -> Tuple[np.ndarray, np.ndarray]:
    """Mutual-nearest-neighbour cosine matching of L2-normalised descriptor
    sets -> (query index, reference index)."""
    if query_desc.shape[0] == 0 or ref_desc.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    sim = query_desc @ ref_desc.T
    best_r = sim.argmax(axis=1)
    best_q = sim.argmax(axis=0)
    rows = np.arange(query_desc.shape[0])
    ok = (best_q[best_r] == rows) & (sim[rows, best_r] >= min_cosine)
    return rows[ok], best_r[ok]


def subsample_live_tracks(recon: ChunkReconstruction, cap: int) -> np.ndarray:
    """Evenly subsampled live-track indices (tracks are stored frame-major,
    so this keeps the spatial coverage); loop detection's descriptor sets."""
    live = np.nonzero(recon.track_valid > 0)[0]
    if live.size <= cap:
        return live
    return live[np.linspace(0, live.size - 1, cap).astype(np.int64)]


def match_tracks_by_descriptor(ref: ChunkReconstruction, query: ChunkReconstruction,
                               frame_map: np.ndarray, min_cosine: float = 0.8,
                               max_px: float = 8.0) -> Tuple[np.ndarray, np.ndarray]:
    """Mutual-NN descriptor matches of live tracks owned by shared frames,
    each within ``max_px`` pixels of its partner -> (ref index, query
    index)."""
    ref_by_frame: dict = {}
    for t in np.nonzero(ref.track_valid > 0)[0]:
        ref_by_frame.setdefault(int(ref.track_frame[t]), []).append(t)
    ref_ids, q_ids = [], []
    for j in range(query.num_frames):
        i = int(frame_map[j])
        if i < 0 or i not in ref_by_frame:
            continue
        ri = np.asarray(ref_by_frame[i], np.int64)
        qi = np.nonzero((query.track_frame == j) & (query.track_valid > 0))[0]
        if ri.size == 0 or qi.size == 0:
            continue
        qm, rm = mutual_nn_match(query.track_desc[qi], ref.track_desc[ri], min_cosine)
        keep = np.linalg.norm(query.track_uv[qi[qm]] - ref.track_uv[ri[rm]], axis=-1) <= max_px
        ref_ids.append(ri[rm[keep]])
        q_ids.append(qi[qm[keep]])
    if not ref_ids:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ref_ids), np.concatenate(q_ids)


def find_common_tracks(ref: ChunkReconstruction, query: ChunkReconstruction,
                       quantize_px: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """Tracks owned by shared (same-named) frames at the same keypoint
    position -> (ref track index, query track index); with descriptors on
    both sides, descriptor matches are added for query tracks not yet
    matched."""
    name_to_ref_frame = {n: i for i, n in enumerate(ref.frame_names)}
    frame_map = np.array([name_to_ref_frame.get(n, -1) for n in query.frame_names], np.int32)
    if (frame_map < 0).all():
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ref_ids, q_ids = match_tracks(ref.track_frame, ref.track_uv, ref.track_valid,
                                  query.track_frame, query.track_uv, query.track_valid,
                                  frame_map, quantize=quantize_px)
    if ref.track_desc is not None and query.track_desc is not None:
        rd, qd = match_tracks_by_descriptor(ref, query, frame_map)
        if rd.size:
            taken = set(q_ids.tolist())
            fresh = np.array([q not in taken for q in qd], bool)
            ref_ids = np.concatenate([ref_ids, rd[fresh]])
            q_ids = np.concatenate([q_ids, qd[fresh]])
    return ref_ids, q_ids


def apply_sim3_to_reconstruction(recon: ChunkReconstruction, s: Sim3) -> None:
    """In place: X' = sR X + t, c' = sR c + t, R_cw' = R_cw R^T (in fp64 on
    the host)."""
    R = s.rotation.detach().cpu().double().numpy()
    t = s.translation.detach().cpu().double().numpy()
    sc = float(s.scale)
    recon.points = (sc * recon.points.astype(np.float64) @ R.T + t).astype(np.float32)
    recon.centers = (sc * recon.centers.astype(np.float64) @ R.T + t).astype(np.float32)
    recon.rotations = (recon.rotations.astype(np.float64) @ R.T).astype(np.float32)


def align_chunks(
    ref: ChunkReconstruction,
    query: ChunkReconstruction,
    huber_delta_sim3: float = 1.0,
    sim3_iterations: int = 5,
    refine: bool = True,
    refine_iterations: int = 50,
    refine_huber: float = 3.0,
    orientation_prior_cov: float = 2.0,
    position_prior_cov: float = 25.0,
    prune_max_reproj_px: float = 3.0,
    prune_min_tri_angle_deg: float = 0.25,
    min_common_tracks: int = 4,
    device="cuda",
) -> AlignmentResult:
    """Align the query chunk onto the reference chunk in place."""
    dev = torch.device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev)

    ref_ids, q_ids = find_common_tracks(ref, query)
    n_common = int(ref_ids.size)
    n_used = 0
    if n_common < min_common_tracks:
        # the shared frames' camera poses carry the alignment when
        # confidence masking killed the overlap keypoints
        name_to_ref = {nm: i for i, nm in enumerate(ref.frame_names)}
        shared = [(name_to_ref[nm], j) for j, nm in enumerate(query.frame_names)
                  if nm in name_to_ref]
        if len(shared) < 2:
            return AlignmentResult(sim3_identity(), n_common, 0, success=False)
        ri = np.array([i for i, _ in shared])
        qj = np.array([j for _, j in shared])
        s = sim3_from_camera_poses(f32(ref.rotations[ri]), f32(ref.centers[ri]),
                                   f32(query.rotations[qj]), f32(query.centers[qj]))
        method = "poses"
    else:
        dst = ref.points[ref_ids].astype(np.float64)
        src = query.points[q_ids].astype(np.float64)
        # median-distance filter w.r.t. the reference chunk's last camera
        d = np.linalg.norm(dst - ref.centers[-1].astype(np.float64), axis=-1)
        keep = d <= np.median(d)
        if keep.sum() >= min_common_tracks:
            dst, src = dst[keep], src[keep]
        n_used = src.shape[0]
        s = robust_umeyama(f32(src), f32(dst), huber_delta=huber_delta_sim3,
                           iterations=sim3_iterations)
        method = "tracks"
    apply_sim3_to_reconstruction(query, s)

    if refine:
        # priors: the overlap views of the query pulled toward ref's poses
        n = query.num_frames
        prior_R = query.rotations.copy()
        prior_c = query.centers.copy()
        rot_w = np.zeros(n, np.float32)
        pos_w = np.zeros(n, np.float32)
        name_to_ref = {nm: i for i, nm in enumerate(ref.frame_names)}
        for j, nm in enumerate(query.frame_names):
            i = name_to_ref.get(nm)
            if i is not None:
                prior_R[j] = ref.rotations[i]
                prior_c[j] = ref.centers[i]
                rot_w[j] = 1.0 / orientation_prior_cov
                pos_w[j] = 1.0 / position_prior_cov
        prob = query.to_problem(priors=dict(prior_rotations=prior_R, prior_centers=prior_c,
                                            prior_rot_weight=rot_w, prior_pos_weight=pos_w),
                                device=dev)
        kpf = (query.num_tracks // query.num_frames
               if query.num_tracks % query.num_frames == 0 else None)
        prob = run_bundle_adjust(prob, refine_iterations, refine_huber, tracks_per_frame=kpf)
        prob = prob._replace(track_valid=prune_outlier_tracks(prob, prune_max_reproj_px,
                                                              prune_min_tri_angle_deg))
        query.update_from_problem(prob)
    return AlignmentResult(s, n_common, n_used, success=True, method=method)
