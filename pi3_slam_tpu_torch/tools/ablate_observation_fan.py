"""A/B the observation-fan policy on the eval-scale synthetic system gate.

    python -m pi3_slam_tpu_torch.tools.ablate_observation_fan [--ba-iterations 10]
        [--refine-iterations 50] [--max-obs 10] [--seeds 0 1 2] [--quick] [--device cuda]

The reference projects every track into all earlier frames whatever
max_observations_per_track says (utils/chunk_reconstruction.py:163-185); the
default here evenly subsamples earlier frames so the padded observation width
M stays at max_observations_per_track (fixed shapes for the batched Schur
solver). This tool measures what that deviation costs or buys: the
Sim3-aligned APE and the reconstruction wall time of both policies on the
eval-shaped synthetic scene (5 chunks x 100 frames x 400 keypoints, overlap
20, confidence-correlated outliers, per-chunk scale drift; ``tools/synthetic``
``EVAL_SCALE``), reconstructed on ``--device`` (the GPU unless ``--device
cpu``; without a GPU ``--device cuda`` raises). The summary's wall time drops
the first seed when there are several: its runs carry the card's warm-up.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def run_mode(tmp, fan, gt_centers, args):
    from ..io.tum import read_tum_trajectory
    from ..slam.config import ReconstructorConfig
    from ..slam.offline_reconstructor import OfflineReconstructor
    from ..utils.evaluation import ape_translation

    out_dir = os.path.join(tmp, f"recon_{fan}")
    rec = OfflineReconstructor(
        ReconstructorConfig(
            chunk_dir=tmp,
            output_dir=out_dir,
            max_observations_per_track=args.max_obs,
            observation_fan=fan,
            ba_iterations=args.ba_iterations,
            align_refine_iterations=args.refine_iterations,
            device=args.device,
        )
    )
    t0 = time.time()
    result = rec.run()
    dt = time.time() - t0
    traj = read_tum_trajectory(result["artifacts"]["trajectory"])
    ape = ape_translation(gt_centers, traj["positions"], align_sim3=True)
    n_align = len(result["alignment"])
    ok = sum(1 for a in result["alignment"] if a.success)
    return {"fan": fan, "ape_rmse_m": float(ape.rmse), "recon_seconds": dt,
            "alignments_ok": f"{ok}/{n_align}"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ba-iterations", type=int, default=10)
    ap.add_argument("--refine-iterations", type=int, default=50)
    ap.add_argument("--max-obs", type=int, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--quick", action="store_true",
                    help="small scene (14 frames / 3 chunks) for a fast check")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap


def run(argv=None) -> list:
    """Parse ``argv``, run both fans for every seed, print the lines and the
    JSON rows, and return the rows."""
    args = build_parser().parse_args(argv)

    from ..device import select_device
    from .synthetic import EVAL_SCALE, write_synthetic_chunks

    select_device(args.device)
    rows = []
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="pi3_fan_ablate_")
        rng = np.random.default_rng(seed)
        if args.quick:
            gt_centers = write_synthetic_chunks(tmp, rng)
        else:
            gt_centers = write_synthetic_chunks(tmp, rng, **EVAL_SCALE)
        for fan in ("subsampled", "unbounded"):
            r = run_mode(tmp, fan, gt_centers, args)
            r["seed"] = seed
            rows.append(r)
            print(f"seed {seed} {fan:11s}: APE {r['ape_rmse_m']:.4f} m, "
                  f"recon {r['recon_seconds']:.1f}s, align {r['alignments_ok']}",
                  flush=True)
        shutil.rmtree(tmp, ignore_errors=True)

    print("\n=== summary (mean over seeds; warm = first seed dropped, its runs "
          "carry the device's warm-up) ===")
    for fan in ("subsampled", "unbounded"):
        sel = [r for r in rows if r["fan"] == fan]
        warm = sel[1:] if len(sel) > 1 else sel
        ape = float(np.mean([r["ape_rmse_m"] for r in sel]))
        dt = float(np.mean([r["recon_seconds"] for r in warm]))
        print(f"{fan:11s}: APE {ape:.4f} m, warm recon {dt:.1f}s")
    print(json.dumps(rows))
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
