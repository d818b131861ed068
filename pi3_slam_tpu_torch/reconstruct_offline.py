"""CLI: reconstruct from saved chunks with the PyTorch port (per-chunk BA,
Sim3 chaining, optional loop closure, export), on the GPU by default.

    python -m pi3_slam_tpu_torch.reconstruct_offline --chunks <out> [--device cpu]

Same flags as the JAX package's ``reconstruct_offline.py``. Flags that name
parts not ported yet exit non-zero with a message naming their ROADMAP.md
entry. ``--device cuda`` (the default) needs a CUDA device; ``--device cpu``
is the explicit CPU mode.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--chunks", required=True, help="Directory containing chunk_*.npz files")
    parser.add_argument("--output", default=None, help="Directory to write reconstruction outputs")
    parser.add_argument("--chunk-length", type=int, default=None)
    parser.add_argument("--overlap", type=int, default=None)
    parser.add_argument("--max-observations-per-track", type=int, default=5)
    parser.add_argument("--observation-fan", default="subsampled",
                        choices=["subsampled", "unbounded"],
                        help="'subsampled': earlier frames evenly subsampled to the "
                             "max-observations budget; 'unbounded': every earlier frame")
    parser.add_argument("--use-inverse-depth", action="store_true")
    parser.add_argument("--ba-iterations", type=int, default=10)
    parser.add_argument("--save-per-chunk", action="store_true",
                        help="Save per-chunk reconstruction .npz files")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--telemetry", default=None,
                        help="Telemetry with gravity/GPS streams (not yet ported)")
    parser.add_argument("--gps-sigma", type=float, default=2.0,
                        help="GPS position prior sigma in meters, for --telemetry")
    parser.add_argument("--gravity-sigma", type=float, default=0.05,
                        help="Gravity direction residual sigma, for --telemetry")
    parser.add_argument("--loop-closure", action="store_true",
                        help="Loop closure over non-adjacent chunks: descriptor matching, "
                             "geometric verification and a Sim3 pose graph (needs "
                             "--keypoints aliked chunks)")
    parser.add_argument("--loop-min-inliers", type=int, default=20,
                        help="Minimum verified 3D inliers of a loop edge, for --loop-closure")
    parser.add_argument("--save-colmap", action="store_true",
                        help="COLMAP text model export (not yet ported)")
    parser.add_argument("--export-mesh", action="store_true",
                        help="TSDF mesh export (not yet ported)")
    parser.add_argument("--mesh-voxel-size", type=float, default=0.0,
                        help="TSDF voxel size, for --export-mesh")
    parser.add_argument("--mesh-conf-threshold", type=float, default=0.25,
                        help="Minimum confidence of a depth sample, for --export-mesh")
    parser.add_argument("--save-volume", action="store_true",
                        help="Persist the fused TSDF volume (not yet ported)")
    parser.add_argument("--render-previews", type=int, default=0,
                        help="Raycast preview PNG pairs of the fused volume (not yet ported)")
    return parser


def unported(args) -> str | None:
    """The message for the first requested feature this port lacks, or None."""
    entries = (
        ("--telemetry", args.telemetry is not None, "sfm/priors.py: telemetry priors"),
        ("--save-colmap", args.save_colmap, "io/colmap.py"),
        ("--export-mesh", args.export_mesh, "mapping/: TSDF, raycast, fuse, surface nets"),
        ("--save-volume", args.save_volume, "mapping/: TSDF, raycast, fuse, surface nets"),
        ("--render-previews", args.render_previews > 0,
         "mapping/: TSDF, raycast, fuse, surface nets"),
    )
    for flag, asked, entry in entries:
        if asked:
            return f"{flag} is not yet ported (ROADMAP.md Queue 1: off the main path, {entry})"
    return None


def reconstruct(argv=None) -> dict:
    """Parse ``argv`` and run the reconstruction; returns
    ``OfflineReconstructor.run``'s result. Exits with code 2 on an unported
    flag."""
    parser = build_parser()
    args = parser.parse_args(argv)
    msg = unported(args)
    if msg:
        parser.error(msg)

    from .slam.config import ReconstructorConfig
    from .slam.offline_reconstructor import OfflineReconstructor

    config = ReconstructorConfig(
        chunk_dir=args.chunks,
        output_dir=args.output,
        chunk_length=args.chunk_length,
        overlap=args.overlap,
        max_observations_per_track=args.max_observations_per_track,
        observation_fan=args.observation_fan,
        use_inverse_depth=args.use_inverse_depth,
        ba_iterations=args.ba_iterations,
        save_debug=args.save_per_chunk,
        device=args.device,
        loop_closure=args.loop_closure,
        loop_min_inliers=args.loop_min_inliers,
    )
    return OfflineReconstructor(config).run()


def main(argv=None) -> int:
    reconstruct(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
