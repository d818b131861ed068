"""CLI: reconstruct from saved chunks with the PyTorch port (per-chunk BA,
Sim3 chaining, optional loop closure and telemetry priors, export with an
optional COLMAP model and TSDF mesh), on the GPU by default.

    python -m pi3_slam_tpu_torch.reconstruct_offline --chunks <out> [--device cpu]
    python -m pi3_slam_tpu_torch.reconstruct_offline --chunks <out> --export-mesh \
        --save-volume --render-previews 2      # chunks made with --save-dense

Same flags as the JAX package's ``reconstruct_offline.py``. ``--device cuda``
(the default) needs a CUDA device; ``--device cpu`` is the explicit CPU mode.
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
                        help="Telemetry with gravity/GPS streams (generic JSON or GoPro "
                             "MP4) for gravity+GPS constrained refinement; timebase "
                             "must match the frame timestamps (video: idx/fps)")
    parser.add_argument("--gps-sigma", type=float, default=2.0,
                        help="GPS position prior sigma in meters (0 disables)")
    parser.add_argument("--gravity-sigma", type=float, default=0.05,
                        help="Gravity direction residual sigma (0 disables)")
    parser.add_argument("--loop-closure", action="store_true",
                        help="Loop closure over non-adjacent chunks: descriptor matching, "
                             "geometric verification and a Sim3 pose graph (needs "
                             "--keypoints aliked chunks)")
    parser.add_argument("--loop-min-inliers", type=int, default=20,
                        help="Minimum verified 3D inliers of a loop edge, for --loop-closure")
    parser.add_argument("--save-colmap", action="store_true",
                        help="Also export a COLMAP text model (cameras/images/points3D.txt) "
                             "into <output>/colmap")
    parser.add_argument("--export-mesh", action="store_true",
                        help="TSDF-fuse the chunks' dense depth maps under the final "
                             "aligned poses and export a triangle mesh "
                             "(fused_mesh.ply). Needs chunks created with "
                             "--save-dense")
    parser.add_argument("--mesh-voxel-size", type=float, default=0.0,
                        help="TSDF voxel size in scene units; 0 = auto "
                             "(~192 voxels across the scene)")
    parser.add_argument("--mesh-conf-threshold", type=float, default=0.25,
                        help="Minimum sigmoid confidence for a depth sample to "
                             "be integrated")
    parser.add_argument("--save-volume", action="store_true",
                        help="With --export-mesh: also persist the fused TSDF "
                             "volume (fused_volume.npz) for later re-meshing "
                             "or raycasting")
    parser.add_argument("--render-previews", type=int, default=0,
                        help="With --export-mesh: raycast this many depth/"
                             "normal preview PNG pairs of the fused volume "
                             "(mesh_previews/)")
    return parser


def reconstruct(argv=None) -> dict:
    """Parse ``argv`` and run the reconstruction; returns
    ``OfflineReconstructor.run``'s result."""
    args = build_parser().parse_args(argv)

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
        telemetry_path=args.telemetry,
        gps_sigma=args.gps_sigma,
        gravity_sigma=args.gravity_sigma,
        save_colmap=args.save_colmap,
        export_mesh=args.export_mesh,
        mesh_voxel_size=args.mesh_voxel_size,
        mesh_conf_threshold=args.mesh_conf_threshold,
        mesh_preview_views=args.render_previews,
        save_volume=args.save_volume,
    )
    return OfflineReconstructor(config).run()


def main(argv=None) -> int:
    reconstruct(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
