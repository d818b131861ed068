"""Loop-closure detection and correction over chunk reconstructions.

Port of ``pi3_slam_tpu/sfm/loops.py``. Sequential stitching aligns each chunk
to its predecessor only, so a revisit does not correct the drift. This finds
revisits between non-adjacent chunks (a proximity gate, mutual-NN descriptor
matching, an 8-iteration Huber-IRLS Umeyama fit and inlier gates) and spreads
the loop error over the chain with the Sim3 pose graph
(``sfm/posegraph.py``). Detection needs descriptors: ALIKED chunks carry
them, grid chunks do not, and on those it finds nothing. The fits and the
pose graph run on ``device`` (the JAX package's ``sfm_compute()``), the card
by default.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..geometry.sim3 import Sim3, robust_umeyama, sim3_apply, sim3_identity
from .alignment import apply_sim3_to_reconstruction, mutual_nn_match, subsample_live_tracks
from .posegraph import index_sim3, optimize_sim3_pose_graph, sequential_edges, stack_sim3
from .reconstruction import ChunkReconstruction


@dataclasses.dataclass
class LoopEdge:
    i: int  # earlier chunk
    j: int  # later chunk
    sim3: Sim3  # T with X_i^-1 o X_j = T: maps chunk j's world points onto chunk i's
    num_matches: int
    num_inliers: int
    inlier_rms: float


def _chunk_proximity(a: ChunkReconstruction, b: ChunkReconstruction) -> float:
    """Distance between the camera tracks' bounding spheres over the sum of
    their radii (< 1: the spheres overlap)."""
    ca, cb = a.centers.mean(axis=0), b.centers.mean(axis=0)
    ra = float(np.linalg.norm(a.centers - ca, axis=-1).max())
    rb = float(np.linalg.norm(b.centers - cb, axis=-1).max())
    return float(np.linalg.norm(ca - cb)) / max(ra + rb, 1e-9)


def chunk_global_descriptor(recon: ChunkReconstruction, cap: int = 2048) -> np.ndarray:
    """A chunk's place signature: the L2-normalised mean of its (subsampled)
    track descriptors, whose cosine prefilters candidate pairs."""
    if recon.track_desc is None:
        return np.zeros(0, np.float32)
    live = subsample_live_tracks(recon, cap)
    if live.size == 0:
        return np.zeros(recon.track_desc.shape[1], np.float32)
    g = recon.track_desc[live].mean(axis=0)
    return (g / max(np.linalg.norm(g), 1e-9)).astype(np.float32)


def detect_loop_closures(
    recons: Sequence[ChunkReconstruction],
    *,
    min_separation: int = 2,
    max_proximity: float = 1.5,
    max_desc_tracks: int = 2048,
    min_cosine: float = 0.85,
    min_matches: int = 30,
    min_inliers: int = 20,
    min_inlier_ratio: float = 0.5,
    inlier_scale_factor: float = 0.05,
    global_prefilter_top_k: int | None = None,
    device="cuda",
) -> List[LoopEdge]:
    """Verified loop edges between non-adjacent chunks.

    Per candidate pair: (1) the proximity gate on the current (drifted)
    placement; (2) mutual-NN cosine matching of the track descriptors; (3) a
    trimmed Huber-IRLS Umeyama fit on ``device`` with inliers within twice
    ``inlier_scale_factor`` x the matched cloud's median spread. A pair that
    fails a gate is dropped. ``global_prefilter_top_k`` keeps, for each
    chunk, only its top-k partners by global-descriptor cosine."""
    dev = torch.device(device)
    edges: List[LoopEdge] = []
    n = len(recons)
    subs = [None] * n

    allowed = None
    if global_prefilter_top_k is not None and n > 2:
        described = [k for k, r in enumerate(recons) if r.track_desc is not None]
        dims = {recons[k].track_desc.shape[1] for k in described}
        if len(described) > 2 and len(dims) == 1:
            gd = np.stack([chunk_global_descriptor(recons[k]) for k in described])
            gsim = gd @ gd.T
            allowed = set()
            for jj, j in enumerate(described):
                cand = sorted(((float(gsim[ii, jj]), i) for ii, i in enumerate(described)
                               if abs(i - j) > min_separation), reverse=True)
                for _, i in cand[:global_prefilter_top_k]:
                    allowed.add((min(i, j), max(i, j)))

    for i in range(n):
        for j in range(i + min_separation + 1, n):
            a, b = recons[i], recons[j]
            if a.track_desc is None or b.track_desc is None:
                continue
            if allowed is not None and (i, j) not in allowed:
                continue
            if _chunk_proximity(a, b) > max_proximity:
                continue
            if subs[i] is None:
                subs[i] = subsample_live_tracks(a, max_desc_tracks)
            if subs[j] is None:
                subs[j] = subsample_live_tracks(b, max_desc_tracks)
            ai, bj = subs[i], subs[j]
            if ai.size < min_matches or bj.size < min_matches:
                continue
            qm, rm = mutual_nn_match(b.track_desc[bj], a.track_desc[ai], min_cosine)
            n_match = int(qm.size)
            if n_match < min_matches:
                continue
            src = b.points[bj[qm]].astype(np.float64)  # the later chunk's points
            dst = a.points[ai[rm]].astype(np.float64)
            spread = np.median(np.linalg.norm(dst - np.median(dst, axis=0), axis=-1))
            tau = max(float(spread) * inlier_scale_factor, 1e-6)
            src_t = torch.as_tensor(src, dtype=torch.float32).to(dev)
            dst_t = torch.as_tensor(dst, dtype=torch.float32).to(dev)
            t = robust_umeyama(src_t, dst_t, huber_delta=tau, iterations=8, trim_multiplier=3.0)
            res = torch.linalg.vector_norm(sim3_apply(t, src_t) - dst_t, dim=-1).cpu().numpy()
            inl = res <= 2.0 * tau
            n_inl = int(inl.sum())
            if n_inl < min_inliers or n_inl < min_inlier_ratio * n_match:
                continue
            edges.append(LoopEdge(i=i, j=j, sim3=Sim3(*(x.cpu() for x in t)),
                                  num_matches=n_match, num_inliers=n_inl,
                                  inlier_rms=float(np.sqrt(np.mean(res[inl] ** 2)))))
    return edges


def close_loops(
    recons: Sequence[ChunkReconstruction],
    edges: Optional[List[LoopEdge]] = None,
    *,
    iterations: int = 15,
    sequential_weight: float = 2.0,
    huber_delta: float = 0.5,
    device="cuda",
    **detect_kwargs,
) -> dict:
    """Detect loops (unless ``edges`` are given), optimise the Sim3 pose
    graph on ``device`` and apply the per-chunk corrections in place.

    Node k is a world-frame correction X_k of chunk k (identity at the
    start); a loop fit T (chunk j's points onto chunk i's) constrains
    X_i^-1 o X_j = T, and sequential edges of weight ``sequential_weight``
    hold X_k^-1 o X_{k+1} = I, so the stitched chain deforms as little as it
    can while it takes up the loop error."""
    n = len(recons)
    if edges is None:
        edges = detect_loop_closures(recons, device=device, **detect_kwargs)
    if not edges or n < 2:
        return {"num_loop_edges": 0, "applied": False, "edges": edges or []}

    seq_i, seq_j, seq_meas = sequential_edges(n)
    ei = np.concatenate([seq_i, np.array([e.i for e in edges], np.int32)])
    ej = np.concatenate([seq_j, np.array([e.j for e in edges], np.int32)])
    meas = stack_sim3(seq_meas + [e.sim3 for e in edges])
    w = np.concatenate([np.full(n - 1, sequential_weight, np.float32),
                        np.ones(len(edges), np.float32)])
    result = optimize_sim3_pose_graph(stack_sim3([sim3_identity()] * n), ei, ej, meas, w,
                                      iterations=iterations, huber_delta=huber_delta,
                                      device=device)
    for k, recon in enumerate(recons):
        apply_sim3_to_reconstruction(recon, index_sim3(result.nodes, k))
    return {"num_loop_edges": len(edges), "applied": True, "edges": edges,
            "initial_cost": result.initial_cost, "final_cost": result.final_cost}
