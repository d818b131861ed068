"""Surface-reconstruction metrics: accuracy / completeness / chamfer / F-score.

Port of ``pi3_slam_tpu/utils/mesh_eval.py`` (host numpy and scipy in both
packages, the same numbers for the same seed). The standard mesh-evaluation
protocol (TanksAndTemples and the MVS literature): sample the predicted
surface uniformly by face area, measure nearest-neighbour distances both ways
against a ground-truth point set, and report precision / recall / F-score at
a distance threshold. It scores the ``mapping/`` export as
``utils/evaluation.py``'s APE scores trajectories; it runs once per
experiment on point sets, off the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class SurfaceMetrics:
    accuracy: float      # mean distance pred -> gt (lower = better)
    completeness: float  # mean distance gt -> pred (lower = better)
    chamfer: float       # (accuracy + completeness) / 2
    precision: float     # fraction of pred points within threshold of gt
    recall: float        # fraction of gt points within threshold of pred
    fscore: float        # harmonic mean of precision and recall
    threshold: float
    num_pred: int
    num_gt: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "accuracy": self.accuracy,
            "completeness": self.completeness,
            "chamfer": self.chamfer,
            "precision": self.precision,
            "recall": self.recall,
            "fscore": self.fscore,
            "threshold": self.threshold,
            "num_pred": self.num_pred,
            "num_gt": self.num_gt,
        }


def sample_mesh_surface(
    vertices: np.ndarray,
    faces: np.ndarray,
    n_samples: int,
    seed: int = 0,
) -> np.ndarray:
    """Uniform-by-area surface samples from a triangle mesh: faces chosen
    with probability proportional to area, barycentric coordinates via the
    sqrt trick (uniform over each triangle)."""
    verts = np.asarray(vertices, np.float64).reshape(-1, 3)
    tris = verts[np.asarray(faces, np.int64).reshape(-1, 3)]  # (F, 3, 3)
    if len(tris) == 0:
        return np.zeros((0, 3))
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    total = areas.sum()
    if total <= 0:
        return tris[:, 0]
    rng = np.random.default_rng(seed)
    fidx = rng.choice(len(tris), size=n_samples, p=areas / total)
    r1 = np.sqrt(rng.uniform(size=(n_samples, 1)))
    r2 = rng.uniform(size=(n_samples, 1))
    t = tris[fidx]
    return (1 - r1) * t[:, 0] + r1 * (1 - r2) * t[:, 1] + r1 * r2 * t[:, 2]


def surface_metrics(
    pred_points: np.ndarray,
    gt_points: np.ndarray,
    threshold: float,
) -> SurfaceMetrics:
    """Two-sided nearest-neighbor distances between point sets."""
    from scipy.spatial import cKDTree

    pred = np.asarray(pred_points, np.float64).reshape(-1, 3)
    gt = np.asarray(gt_points, np.float64).reshape(-1, 3)
    pred = pred[np.isfinite(pred).all(axis=1)]
    gt = gt[np.isfinite(gt).all(axis=1)]
    if len(pred) == 0 or len(gt) == 0:
        raise ValueError(
            f"empty point set (pred {len(pred)}, gt {len(gt)}) — nothing to evaluate"
        )
    d_pred = cKDTree(gt).query(pred, k=1)[0]   # pred -> gt
    d_gt = cKDTree(pred).query(gt, k=1)[0]     # gt -> pred
    precision = float((d_pred <= threshold).mean())
    recall = float((d_gt <= threshold).mean())
    fscore = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    acc = float(d_pred.mean())
    comp = float(d_gt.mean())
    return SurfaceMetrics(
        accuracy=acc,
        completeness=comp,
        chamfer=0.5 * (acc + comp),
        precision=precision,
        recall=recall,
        fscore=fscore,
        threshold=float(threshold),
        num_pred=len(pred),
        num_gt=len(gt),
    )


def evaluate_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    gt_points: np.ndarray,
    threshold: Optional[float] = None,
    n_samples: int = 200_000,
    seed: int = 0,
) -> SurfaceMetrics:
    """Evaluate a triangle mesh against a ground-truth point set.

    threshold None: auto — 1% of the GT bounding-box diagonal (a common
    dataset-agnostic default)."""
    gt = np.asarray(gt_points, np.float64).reshape(-1, 3)
    gt = gt[np.isfinite(gt).all(axis=1)]
    if threshold is None:
        lo, hi = gt.min(axis=0), gt.max(axis=0)
        threshold = 0.01 * float(np.linalg.norm(hi - lo))
    samples = sample_mesh_surface(vertices, faces, n_samples, seed=seed)
    return surface_metrics(samples, gt, threshold)
