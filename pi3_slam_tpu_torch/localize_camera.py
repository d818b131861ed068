"""CLI: localize and reconstruct another camera against an existing map, with
the PyTorch port, on the GPU by default.

    python -m pi3_slam_tpu_torch.localize_camera --map-chunks <map> \\
        (--query-chunks <dir> | --query-images <images> --aliked-path aliked.npz)

Same flags, artifacts and exit codes as the JAX package's
``localize_camera.py``. The map is the chunk output of the creator for the
first camera, with ALIKED keypoints (their descriptors carry the appearance
signal used for matching); the map itself is reconstructed by the port's
``OfflineReconstructor``.

Two query modes:
- ``--query-chunks DIR``: the second camera's own Pi3 chunks are
  Sim3-registered onto the map by 3D-3D descriptor matching (its tracks are
  merged into the map frame); exports a combined PLY, the second camera's TUM
  trajectory and ``registration_stats.json``.
- ``--query-images PATH``: per-image 6-dof localization by descriptor
  matching and robust PnP (RANSAC over batched DLT, Huber-GN refinement);
  exports the localized TUM trajectory and ``localization_stats.json``, and
  with ``--triangulate`` the second camera's own points
  (``query_points.ply``).

Exit codes: 0 when something registered / localized, 1 when nothing did, 2
when the map carries no descriptors, PnP mode has no ``--aliked-path``, or
the query holds no chunk / image. ``--device cuda`` (the default) needs a
CUDA device; ``--device cpu`` is the explicit CPU mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--map-chunks", required=True,
                        help="Chunk directory of the mapping camera (ALIKED chunks)")
    parser.add_argument("--query-chunks", default=None,
                        help="Chunk directory of the second camera (register mode)")
    parser.add_argument("--query-images", default=None,
                        help="Folder/glob/txt of the second camera's images (PnP mode)")
    parser.add_argument("--aliked-path", default=None,
                        help="Converted ALIKED weights (.npz) for PnP-mode extraction")
    parser.add_argument("--max-keypoints", type=int, default=1000)
    parser.add_argument("--kp-threshold", type=float, default=0.005)
    parser.add_argument("--calib", default=None,
                        help="Query camera calibration JSON (PnP intrinsics); "
                             "default: f=max(W,H), principal point at center "
                             "(the reference's default prior)")
    parser.add_argument("--output", default="localization_output")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--min-inliers", type=int, default=12)
    parser.add_argument("--min-cosine", type=float, default=0.85)
    parser.add_argument("--ba-iterations", type=int, default=10)
    parser.add_argument("--triangulate", action="store_true",
                        help="PnP mode: also reconstruct the second camera's own "
                             "points: chain descriptor tracks across localized "
                             "query images and triangulate them (multi-view DLT) "
                             "into query_points.ply")
    parser.add_argument("--triangulate-max-rms", type=float, default=3.0,
                        help="Reprojection gate (px) for triangulated points")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.query_chunks) == bool(args.query_images):
        parser.error("pass exactly one of --query-chunks / --query-images")

    from .device import select_device

    device = select_device(args.device)

    from .slam.config import ReconstructorConfig
    from .slam.offline_reconstructor import OfflineReconstructor

    os.makedirs(args.output, exist_ok=True)
    map_cfg = ReconstructorConfig(chunk_dir=args.map_chunks,
                                  output_dir=os.path.join(args.output, "map"),
                                  ba_iterations=args.ba_iterations, device=args.device)
    map_recons = OfflineReconstructor(map_cfg).run()["reconstructions"]
    if all(r.track_desc is None for r in map_recons):
        print("ERROR: map chunks carry no descriptors — rebuild the map with "
              "create_offline_chunks --keypoints aliked", file=sys.stderr)
        return 2

    if args.query_chunks:
        return _register_mode(args, map_recons, device)
    return _pnp_mode(args, map_recons, device)


def _register_mode(args, map_recons, device) -> int:
    """Sim3-register the second camera's chunks onto the map."""
    import glob

    from .io.ply import write_ply
    from .io.tum import write_tum_trajectory
    from .sfm.localize import _pool_map_tracks, register_reconstruction
    from .sfm.reconstruction import build_chunk_reconstruction
    from .slam.offline_reconstructor import load_chunk_npz

    files = sorted(glob.glob(os.path.join(args.query_chunks, "chunks", "chunk_*.npz"))) or sorted(
        glob.glob(os.path.join(args.query_chunks, "chunk_*.npz")))
    if not files:
        print(f"no chunk files under {args.query_chunks}", file=sys.stderr)
        return 2

    map_pool = _pool_map_tracks(map_recons)
    registered, stats = [], []
    for i, path in enumerate(files):
        recon = build_chunk_reconstruction(load_chunk_npz(path), ba_iterations=args.ba_iterations,
                                           device=device)
        res = register_reconstruction(map_recons, recon, min_cosine=args.min_cosine,
                                      min_inliers=max(args.min_inliers, 20), map_pool=map_pool,
                                      device=device)
        status = "ok" if res.success else "FAILED"
        print(f"register chunk {i}: {status} (matches {res.num_matches}, "
              f"inliers {res.num_inliers})")
        stats.append(dict(chunk=i, success=res.success, num_matches=res.num_matches,
                          num_inliers=res.num_inliers, inlier_rms=res.inlier_rms,
                          scale=(float(res.sim3.scale) if res.success else None)))
        if res.success:
            registered.append(recon)

    # exports: the second camera's trajectory and the combined cloud
    seen, centers, rotations = set(), [], []
    for r in registered:
        for j, nm in enumerate(r.frame_names):
            if nm in seen:
                continue
            seen.add(nm)
            centers.append(r.centers[j])
            rotations.append(r.rotations[j].T)
    if centers:
        write_tum_trajectory(os.path.join(args.output, "query_trajectory_tum.txt"),
                             np.asarray(centers), np.asarray(rotations), integer_timestamps=True)
    clouds = [r.points[r.track_valid > 0] for r in list(map_recons) + registered]
    colors = [r.colors[r.track_valid > 0] for r in list(map_recons) + registered]
    write_ply(np.concatenate(clouds) if clouds else np.zeros((0, 3)),
              np.concatenate(colors) if colors else np.zeros((0, 3)),
              os.path.join(args.output, "combined_points.ply"))
    with open(os.path.join(args.output, "registration_stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    n_ok = sum(1 for s in stats if s["success"])
    print(f"registered {n_ok}/{len(stats)} query chunks -> {args.output}")
    return 0 if n_ok else 1


def _pnp_mode(args, map_recons, device) -> int:
    """Per-image 6-dof localization by descriptor matching and robust PnP."""
    from .create_offline_chunks import collect_image_paths
    from .data.image_io import load_image
    from .io.tum import write_tum_trajectory
    from .sfm.localize import _pool_map_tracks, localize_by_descriptors
    from .utils.keypoints import ALIKEDExtractor
    from .utils.timestamps import extract_timestamps_from_paths

    if not args.aliked_path:
        print("ERROR: PnP mode needs --aliked-path (converted ALIKED weights) — "
              "the map descriptors are ALIKED features", file=sys.stderr)
        return 2
    extractor = ALIKEDExtractor(args.aliked_path, max_num_keypoints=args.max_keypoints,
                                detection_threshold=args.kp_threshold, device=device)

    # query images at the map's working resolution, so the descriptors see
    # the scale the map was built at
    meta_path = os.path.join(args.map_chunks, "chunk_metadata.json")
    target_hw = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            ts = json.load(f).get("target_size")
        if ts:  # chunk_metadata stores target_size as (H, W)
            target_hw = (int(ts[0]), int(ts[1]))

    paths = collect_image_paths(args.query_images)
    if not paths:
        print(f"no images under {args.query_images}", file=sys.stderr)
        return 2
    timestamps = extract_timestamps_from_paths(paths)

    first = load_image(paths[0], target_hw)
    h, w = first.shape[1], first.shape[2]
    if args.calib:
        from .data.undistortion import CalibratedCamera

        with open(args.calib) as f:
            cam = CalibratedCamera.from_json(json.load(f))
        sx, sy = w / cam.width, h / cam.height
        intr = np.array([cam.fx * sx, cam.fy * sy, cam.cx * sx, cam.cy * sy], np.float32)
    else:  # the reference's default prior: f = max(W, H), pp at the center
        intr = np.array([max(w, h), max(w, h), w / 2.0, h / 2.0], np.float32)

    map_pool = _pool_map_tracks(map_recons)
    results, centers, rotations, kept_ts = [], [], [], []
    kept_dets, kept_poses = [], []
    for k, path in enumerate(paths):
        img = first if k == 0 else load_image(path, target_hw)
        det = extractor.extract(img[None])
        kp = det["keypoints"][0]
        desc = det["descriptors"][0]
        val = det.get("valid")
        if val is not None:
            kp, desc = kp[val[0] > 0], desc[val[0] > 0]
        res = localize_by_descriptors(map_recons, kp, desc, intr, min_cosine=args.min_cosine,
                                      min_inliers=args.min_inliers, seed=k, map_pool=map_pool,
                                      device=device)
        status = "ok" if res.success else "FAILED"
        print(f"localize {os.path.basename(str(path))}: {status} "
              f"(matches {res.num_matches}, inliers {res.num_inliers}, "
              f"rms {res.inlier_rms_px:.2f} px)")
        results.append(dict(
            image=os.path.basename(str(path)), success=res.success,
            num_matches=res.num_matches, num_inliers=res.num_inliers,
            inlier_rms_px=res.inlier_rms_px if np.isfinite(res.inlier_rms_px) else None))
        if res.success:
            centers.append(res.center)
            rotations.append(res.rotation.T)  # world->cam -> cam-to-world
            kept_ts.append(timestamps[k] / 1e9)
            if args.triangulate:
                kept_dets.append({"keypoints": kp, "descriptors": desc})
                kept_poses.append(res.rotation)

    if args.triangulate and len(kept_dets) >= 2:
        _triangulate_query_points(args, kept_dets, kept_poses, centers, intr, device)

    if centers:
        write_tum_trajectory(os.path.join(args.output, "query_trajectory_tum.txt"),
                             np.asarray(centers), np.asarray(rotations), timestamps=kept_ts)
    with open(os.path.join(args.output, "localization_stats.json"), "w") as f:
        json.dump(results, f, indent=1)
    n_ok = len(centers)
    print(f"localized {n_ok}/{len(paths)} images -> {args.output}")
    return 0 if n_ok else 1


def _triangulate_query_points(args, kept_dets, kept_poses, centers, intr, device) -> None:
    """Reconstruct the second camera's own points from its localized views:
    descriptor tracks chained across query images, triangulated by the
    batched multi-view DLT (``sfm/localize.triangulate_points``)."""
    from .io.ply import write_ply
    from .sfm.localize import build_query_tracks, triangulate_points

    obs_uv, obs_valid = build_query_tracks(kept_dets, min_cosine=args.min_cosine)
    if obs_uv.shape[0] == 0:
        print("triangulate: no multi-view query tracks found")
        return
    pts, rms, n_front = triangulate_points(np.stack(kept_poses), np.stack(centers), intr, obs_uv,
                                           obs_valid, device=device)
    pts, rms, n_front = pts.cpu().numpy(), rms.cpu().numpy(), n_front.cpu().numpy()
    n_views = obs_valid.sum(axis=1)
    keep = (rms <= args.triangulate_max_rms) & (n_front >= 2) & (n_front == n_views)
    out = os.path.join(args.output, "query_points.ply")
    write_ply(pts[keep], np.tile([0.2, 0.8, 0.2], (int(keep.sum()), 1)), out)
    print(f"triangulate: {int(keep.sum())}/{obs_uv.shape[0]} query tracks -> {out} "
          f"(rms gate {args.triangulate_max_rms} px)")


if __name__ == "__main__":
    sys.exit(main())
