"""Evaluate a fused mesh (reconstruct_offline / pi3_slam_online --export-mesh)
against a ground-truth point cloud or mesh: accuracy / completeness /
chamfer / precision / recall / F-score at a distance threshold.

    python -m pi3_slam_tpu_torch.tools.eval_mesh --mesh out/fused_mesh.ply --gt gt_points.ply
    python -m pi3_slam_tpu_torch.tools.eval_mesh --mesh a.ply --gt gt_mesh.ply --threshold 0.05

The port's copy of the JAX package's tools/eval_mesh.py: the same flags and
the same one JSON line (``utils/mesh_eval.py``, host numpy and scipy).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mesh", required=True, help="Predicted mesh (.ply)")
    parser.add_argument("--gt", required=True,
                        help="Ground truth: point-cloud .ply or mesh .ply "
                             "(meshes are area-sampled)")
    parser.add_argument("--threshold", type=float, default=None,
                        help="F-score distance threshold in scene units "
                             "(default: 1%% of the GT bounding-box diagonal)")
    parser.add_argument("--samples", type=int, default=200_000,
                        help="Surface samples drawn from each mesh")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from ..io.mesh import read_mesh_ply
    from ..utils.mesh_eval import evaluate_mesh, sample_mesh_surface

    mesh = read_mesh_ply(args.mesh)

    def load_points(path):
        try:
            m = read_mesh_ply(path)
            if m["faces"] is not None and len(m["faces"]):
                return sample_mesh_surface(
                    m["vertices"], m["faces"], args.samples, seed=args.seed + 1
                )
            return np.asarray(m["vertices"])
        except Exception:
            from ..io.ply import read_ply

            return np.asarray(read_ply(path)["xyz"])

    gt_points = load_points(args.gt)
    result = evaluate_mesh(
        mesh["vertices"], mesh["faces"], gt_points,
        threshold=args.threshold, n_samples=args.samples, seed=args.seed,
    )
    print(json.dumps(result.as_dict()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
