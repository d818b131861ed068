"""Trajectory evaluation: absolute pose error after a Sim3 alignment.

Port of ``pi3_slam_tpu/utils/evaluation.py`` (the ``evo_ape tum <gt> <est>
-as`` gate of the evaluation scripts): associate two trajectories by
timestamp, Umeyama-align the estimate onto the ground truth with scale, and
report the translational APE statistics. Everything runs on the host CPU, as
the JAX package pins it (``_host_sim3_align``): a scorer never touches or
waits on an accelerator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..geometry.sim3 import sim3_apply, umeyama
from ..io.tum import read_tum_trajectory


def _host_sim3_align(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Umeyama-align est onto gt in fp32 on the host CPU; returns the aligned
    positions (fp64)."""
    e = torch.as_tensor(np.asarray(est, np.float32))
    g = torch.as_tensor(np.asarray(gt, np.float32))
    return sim3_apply(umeyama(e, g), e).double().numpy()


@dataclass
class APEResult:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    num_pairs: int

    def as_dict(self) -> Dict[str, float]:
        return {
            "rmse": self.rmse,
            "mean": self.mean,
            "median": self.median,
            "std": self.std,
            "min": self.min,
            "max": self.max,
            "num_pairs": self.num_pairs,
        }


def associate(
    ts_a: np.ndarray, ts_b: np.ndarray, max_diff: float = 0.01
) -> Tuple[np.ndarray, np.ndarray]:
    """Unique timestamp association, evo/TUM-script exact: enumerate candidate
    pairs within max_diff, take them best-difference-first, and never reuse a
    timestamp from either side (the previous greedy version could match one
    estimate pose to several ground-truth stamps, silently flattering APE)."""
    ts_a = np.asarray(ts_a, np.float64)
    ts_b = np.asarray(ts_b, np.float64)
    cand = []
    for i, t in enumerate(ts_a):
        lo = int(np.searchsorted(ts_b, t - max_diff, side="left"))
        hi = int(np.searchsorted(ts_b, t + max_diff, side="right"))
        for c in range(lo, hi):
            cand.append((abs(ts_b[c] - t), i, c))
    cand.sort(key=lambda x: x[0])
    used_a, used_b = set(), set()
    pairs = []
    for d, i, c in cand:
        if i in used_a or c in used_b:
            continue
        used_a.add(i)
        used_b.add(c)
        pairs.append((i, c))
    pairs.sort()
    if not pairs:
        return np.zeros(0, int), np.zeros(0, int)
    ia, ib = zip(*pairs)
    return np.asarray(ia, int), np.asarray(ib, int)


def ape_translation(
    gt_positions: np.ndarray,
    est_positions: np.ndarray,
    align_sim3: bool = True,
) -> APEResult:
    """APE over already-associated position sequences."""
    gt = np.asarray(gt_positions, np.float64)
    est = np.asarray(est_positions, np.float64)
    assert gt.shape == est.shape and gt.ndim == 2
    if align_sim3 and gt.shape[0] >= 3:
        est = _host_sim3_align(est, gt)
    err = np.linalg.norm(est - gt, axis=1)
    return APEResult(
        rmse=float(np.sqrt(np.mean(err**2))),
        mean=float(err.mean()),
        median=float(np.median(err)),
        std=float(err.std()),
        min=float(err.min()),
        max=float(err.max()),
        num_pairs=int(err.size),
    )


def evaluate_tum_files(
    gt_path: str,
    est_path: str,
    align_sim3: bool = True,
    max_diff: float = 0.01,
    plot_path: str | None = None,
) -> APEResult:
    """evo_ape-style evaluation of two TUM files. plot_path writes the
    trajectory/error figure (the reference's evo_ape --plot --save_plot,
    scripts/eval_7scenes.sh:175)."""
    gt = read_tum_trajectory(gt_path)
    est = read_tum_trajectory(est_path)
    ia, ib = associate(gt["timestamps"], est["timestamps"], max_diff)
    if ia.size < 2:
        raise ValueError(
            f"only {ia.size} timestamp associations between {gt_path} and {est_path}"
        )
    gtp = gt["positions"][ia]
    estp = est["positions"][ib]
    result = ape_translation(gtp, estp, align_sim3)
    if plot_path:
        aligned = estp
        if align_sim3 and gtp.shape[0] >= 3:
            aligned = _host_sim3_align(estp, gtp)
        plot_ape(gtp, aligned, result, plot_path)
    return result


def plot_ape(
    gt_positions: np.ndarray,
    est_positions: np.ndarray,
    result: APEResult,
    path: str,
) -> None:
    """Save a 2-panel APE figure: xyz trajectory overlay + per-pose error
    (the information content of evo_ape's --plot_mode xyz output)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    err = np.linalg.norm(est_positions - gt_positions, axis=1)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    for dim, name in enumerate("xyz"):
        axes[0].plot(gt_positions[:, dim], label=f"gt {name}", lw=1)
        axes[0].plot(est_positions[:, dim], "--", label=f"est {name}", lw=1)
    axes[0].set_xlabel("pose index")
    axes[0].set_ylabel("position [m]")
    axes[0].legend(fontsize=7, ncol=3)
    axes[0].set_title("trajectory (Sim3-aligned)")
    axes[1].plot(err, lw=1)
    axes[1].axhline(result.rmse, color="r", ls="--", lw=1, label=f"rmse {result.rmse:.3f} m")
    axes[1].axhline(result.median, color="g", ls=":", lw=1, label=f"median {result.median:.3f} m")
    axes[1].set_xlabel("pose index")
    axes[1].set_ylabel("APE [m]")
    axes[1].legend(fontsize=8)
    axes[1].set_title("absolute pose error")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
