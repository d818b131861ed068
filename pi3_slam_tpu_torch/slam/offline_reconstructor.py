"""Offline reconstruction: load chunk files, bundle-adjust each chunk, chain
the Sim3 alignments, export the merged point cloud, camera centers and TUM
trajectory.

Port of ``pi3_slam_tpu/slam/offline_reconstructor.py`` (``load_chunk_npz``,
``OfflineReconstructor.run`` and ``export``): the same artifacts
(``final_points.ply``, ``final_camera_poses.ply``, ``trajectory_tum.txt``
with integer timestamps, views deduplicated by name, and with
``config.save_colmap`` a COLMAP text model in ``<output>/colmap``, and with
``config.export_mesh`` the TSDF mesh ``fused_mesh.ply``, optionally the volume
``fused_volume.npz`` and raycast previews under ``mesh_previews/``), with loop
closure over non-adjacent chunks after the chain when ``config.loop_closure``
is set (``sfm/loops.py``), then the telemetry refine when
``config.telemetry_path`` is set (``sfm/priors.py``: GPS georeference,
gravity and GPS priors in the BA). The solves, the TSDF fusion and the
raycasts run on ``config.device``.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List

import numpy as np

from ..device import select_device
from ..io.ply import write_ply
from ..io.tum import write_tum_trajectory
from ..sfm.alignment import align_chunks
from ..sfm.ba import last_ba_info
from ..sfm.reconstruction import ChunkReconstruction, build_chunk_reconstruction
from .config import ReconstructorConfig

_OPTIONAL_KEYS = (
    "intrinsics", "masks", "conf", "metric_scale", "start_idx", "end_idx", "keypoint_valid",
    "obs_frame", "obs_uv", "obs_valid", "obs_refined", "points_dense", "local_points_dense",
    "conf_dense", "masks_dense", "rgb_dense", "dense_stride",
)


def load_chunk_npz(path: str) -> Dict:
    """A chunk .npz as the dict ``build_chunk_reconstruction`` takes (fp16
    storage upcast to fp32, colors to [0, 1])."""
    with np.load(path, allow_pickle=False) as z:
        if "keypoints" not in z.files:
            kind = "dense (created with --keypoints none)" if "dense" in z.files else "incomplete"
            raise ValueError(
                f"{path} is a {kind} chunk without keypoint tracks; reconstruction needs "
                "keypoint-sparse chunks: re-create them with --keypoints grid")
        chunk = {
            "keypoints": z["keypoints"].astype(np.float32),
            "points": z["points"].astype(np.float32),
            "colors": z["colors"].astype(np.float32) / 255.0,
            "camera_poses": z["camera_poses"].astype(np.float64),
            # video chunks store (N, 2) [video_path, frame_idx] rows
            "image_paths": (z["image_paths"] if z["image_paths"].ndim > 1
                            else [str(p) for p in z["image_paths"]]),
            "original_width": int(z["original_width"]),
            "original_height": int(z["original_height"]),
        }
        for key in _OPTIONAL_KEYS:
            if key in z.files:
                chunk[key] = z[key]
        if "descriptors" in z.files:
            chunk["descriptors"] = z["descriptors"].astype(np.float32)
    return chunk


def save_preview(out: Dict, folder: str, j: int) -> None:
    """depth_<j>.png (z-depth over its 98th percentile, black where the ray
    missed) and normal_<j>.png (normals mapped to [0, 255]) of one
    ``raycast_depth`` result."""
    from PIL import Image

    d = out["depth"]
    hi = np.percentile(d[out["mask"]], 98) if out["mask"].any() else 1.0
    depth_img = np.where(out["mask"], np.clip(d / max(hi, 1e-9), 0, 1) * 255, 0).astype(np.uint8)
    normal_img = ((out["normals"] * 0.5 + 0.5) * 255).astype(np.uint8)
    normal_img[~out["mask"]] = 0
    Image.fromarray(depth_img).save(os.path.join(folder, f"depth_{j:03d}.png"))
    Image.fromarray(normal_img).save(os.path.join(folder, f"normal_{j:03d}.png"))


class OfflineReconstructor:
    def __init__(self, config: ReconstructorConfig):
        self.config = config
        self.device = select_device(config.device)
        self.output_dir = config.output_dir or config.chunk_dir
        os.makedirs(self.output_dir, exist_ok=True)
        meta_path = os.path.join(config.chunk_dir, "chunk_metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if config.chunk_length is None:
                config.chunk_length = meta.get("chunk_length")
            if config.overlap is None:
                config.overlap = meta.get("overlap")
            print(f"chunk metadata: length={config.chunk_length} overlap={config.overlap}")

    def _chunk_files(self) -> List[str]:
        files = sorted(glob.glob(os.path.join(self.config.chunk_dir, "chunks", "chunk_*.npz")))
        return files or sorted(glob.glob(os.path.join(self.config.chunk_dir, "chunk_*.npz")))

    def run(self) -> Dict:
        """Returns {"reconstructions", "alignment" (one AlignmentResult per
        chunk after the first), "loop_closure" (``close_loops``'s statistics
        plus its "seconds"; None without ``loop_closure``), "telemetry"
        (``constrain_with_telemetry``'s statistics plus its "seconds"; None
        without ``telemetry_path``), "artifacts"
        (output paths; "mesh" with ``export_mesh`` unless skipped),
        "mesh_timings" (``_export_mesh``'s timings, else None), "timings" (per
        chunk: "recon_s", the whole chunk reconstruction (observation fan on
        the host, copies, BA, pruning); "ba_s" and "ba_iterations", the BA
        alone; "align_s", the whole alignment, and "refine_iterations")}."""
        cfg = self.config
        files = self._chunk_files()
        if not files:
            raise FileNotFoundError(f"no chunk files under {cfg.chunk_dir}")
        print(f"Reconstructing from {len(files)} chunks on {self.device}")
        recons: List[ChunkReconstruction] = []
        align_stats, timings = [], []
        for i, path in enumerate(files):
            chunk = load_chunk_npz(path)
            t0 = time.perf_counter()
            recon = build_chunk_reconstruction(
                chunk, max_observations_per_track=cfg.max_observations_per_track,
                ba_iterations=cfg.ba_iterations, use_inverse_depth=cfg.use_inverse_depth,
                observation_fan=cfg.observation_fan, device=self.device)
            dt = time.perf_counter() - t0  # ends with the host copy of the solution
            ba = last_ba_info()
            timing = {"chunk": i, "frames": recon.num_frames, "recon_s": dt,
                      "ba_s": ba["seconds"], "ba_iterations": ba["iterations"]}
            n = recon.num_frames
            print(f"  chunk {i}: recon {n} frames in {dt:.2f}s ({n / dt:.1f} FPS), "
                  f"BA {ba['seconds']:.2f}s, {ba['iterations']} iterations")
            if cfg.save_debug:
                from ..sfm.serialization import save_reconstruction

                save_reconstruction(recon, os.path.join(self.output_dir, f"recon_{i:06d}.npz"))
            if recons:
                t0 = time.perf_counter()
                res = align_chunks(recons[-1], recon, refine=cfg.align_refine,
                                   refine_iterations=cfg.align_refine_iterations,
                                   device=self.device)
                timing["align_s"] = time.perf_counter() - t0
                if cfg.align_refine and res.success:
                    timing["refine_iterations"] = last_ba_info()["iterations"]
                align_stats.append(res)
                status = "ok" if res.success else "FAILED"
                via = " via pose fallback" if res.method == "poses" else ""
                print(f"    align -> {status}{via} (common {res.num_common_tracks}, "
                      f"scale {float(res.sim3.scale):.4f}) in {timing['align_s']:.2f}s")
            timings.append(timing)
            recons.append(recon)
        loop_stats = self._close_loops(recons) if cfg.loop_closure else None
        telemetry_stats = self._apply_telemetry(recons) if cfg.telemetry_path else None
        artifacts = self.export(recons)
        mesh_timings = None
        if cfg.export_mesh:
            mesh = self._export_mesh(recons, files)
            if mesh:
                artifacts["mesh"], mesh_timings = mesh["path"], mesh["timings"]
        return {"reconstructions": recons, "alignment": align_stats, "loop_closure": loop_stats,
                "telemetry": telemetry_stats, "artifacts": artifacts, "timings": timings,
                "mesh_timings": mesh_timings}

    def _export_mesh(self, recons: List[ChunkReconstruction], files: List[str]) -> Dict | None:
        """TSDF-fuse the chunks' dense maps under the final aligned poses on
        the device and write a surface-nets mesh (``mapping/``). Returns
        {"path", "timings": export_fused_mesh's plus "raycast_s", the seconds
        of each preview's raycast}, or None when skipped."""
        from ..mapping.fuse import export_fused_mesh
        from ..mapping.tsdf import TSDFConfig

        def has_dense(p):
            with np.load(p) as z:  # header check only, close the handle
                return "local_points_dense" in z.files

        if not all(has_dense(p) for p in files):
            print("mesh export skipped: chunks carry no dense maps — recreate "
                  "them with create_offline_chunks --save-dense")
            return None
        cfg = self.config
        # lazy loaders: fuse_chunks materializes one chunk's dense maps at a
        # time (a long run's dense frames would not fit in RAM)
        result = export_fused_mesh(
            [lambda p=p: load_chunk_npz(p) for p in files], recons,
            os.path.join(self.output_dir, "fused_mesh.ply"),
            config=TSDFConfig(voxel_size=cfg.mesh_voxel_size, max_voxels=cfg.mesh_max_voxels,
                              conf_threshold=cfg.mesh_conf_threshold),
            overlap=cfg.overlap or 0, min_weight=cfg.mesh_min_weight,
            volume_path=(os.path.join(self.output_dir, "fused_volume.npz")
                         if cfg.save_volume else None),
            device=self.device)
        if result is None:
            return None
        timings = dict(result["timings"], raycast_s=[])
        if cfg.mesh_preview_views > 0:
            timings["raycast_s"] = self._render_mesh_previews(result["volume"], recons)
        return {"path": result["path"], "timings": timings}

    def _render_mesh_previews(self, volume, recons: List[ChunkReconstruction]) -> List[float]:
        """Raycast depth / normal previews of the fused volume on the device
        from evenly spaced final camera poses (``mapping/raycast.py``);
        returns each raycast's seconds (normals and the host copy
        included)."""
        from ..mapping.raycast import raycast_depth

        rot = np.concatenate([np.asarray(r.rotations) for r in recons])
        cen = np.concatenate([np.asarray(r.centers) for r in recons])
        n = min(self.config.mesh_preview_views, len(cen))
        pick = np.linspace(0, len(cen) - 1, n).astype(int)
        h, w = 240, 320
        intr = np.array([0.8 * w, 0.8 * w, w / 2, h / 2])
        pdir = os.path.join(self.output_dir, "mesh_previews")
        os.makedirs(pdir, exist_ok=True)
        seconds = []
        for j, i in enumerate(pick):
            t0 = time.perf_counter()
            out = raycast_depth(volume, intr, rot[i], cen[i], h, w, device=self.device)
            seconds.append(time.perf_counter() - t0)
            save_preview(out, pdir, j)
        print(f"Rendered {n} depth/normal preview pairs -> {pdir}")
        return seconds

    def _close_loops(self, recons: List[ChunkReconstruction]) -> Dict:
        """Loop closure over the chain (``sfm/loops.close_loops``), printing
        the JAX reconstructor's lines."""
        from ..sfm.loops import close_loops

        t0 = time.perf_counter()
        stats = close_loops(recons, min_inliers=self.config.loop_min_inliers,
                            min_cosine=self.config.loop_min_cosine, device=self.device)
        stats["seconds"] = time.perf_counter() - t0
        if stats["num_loop_edges"] == 0:
            has_desc = any(r.track_desc is not None for r in recons)
            why = "" if has_desc else " (grid chunks carry no descriptors — use --keypoints aliked)"
            print(f"loop closure: no verified loop edges{why}")
        else:
            for e in stats["edges"]:
                print(f"loop closure: chunk {e.j} -> {e.i} "
                      f"({e.num_inliers}/{e.num_matches} inliers, rms {e.inlier_rms:.3f})")
            print(f"loop closure: pose graph over {len(recons)} chunks, cost "
                  f"{stats['initial_cost']:.4f} -> {stats['final_cost']:.4f}")
        return stats

    def _apply_telemetry(self, recons: List[ChunkReconstruction]) -> Dict:
        """Gravity + GPS constrained refinement (``sfm/priors.py``): a Sim3
        fit of the stitched camera track onto the GPS ENU track georeferences
        the reconstruction, then each chunk is refined with GPS position
        priors and gravity-direction residuals in the BA, on the
        reconstructor's device."""
        from ..sfm.priors import constrain_with_telemetry
        from ..utils.telemetry import load_telemetry

        cfg = self.config
        t0 = time.perf_counter()
        stats = constrain_with_telemetry(recons, load_telemetry(cfg.telemetry_path),
                                         gps_sigma=cfg.gps_sigma,
                                         gravity_sigma=cfg.gravity_sigma,
                                         refine_iterations=cfg.telemetry_refine_iterations,
                                         device=self.device)
        stats["seconds"] = time.perf_counter() - t0
        if stats["gps"]:
            print(f"telemetry: georeferenced to ENU (scale {stats['scale']:.4f}, "
                  f"GPS RMS {stats['gps_rms_m']:.2f} m, origin {stats['origin']})")
        print(f"telemetry: refined {stats['refined_chunks']}/{len(recons)} chunks "
              f"(gps={stats['gps']}, gravity={stats['gravity']})")
        return stats

    def export(self, recons: List[ChunkReconstruction]) -> Dict[str, str]:
        """Merged exports, views deduplicated by name (first occurrence wins)."""
        seen = set()
        centers, rotations = [], []
        for r in recons:
            for j, nm in enumerate(r.frame_names):
                if nm in seen:
                    continue
                seen.add(nm)
                centers.append(r.centers[j])
                rotations.append(r.rotations[j].T)  # R_cw -> R_wc (camera-to-world)
        cloud = np.concatenate([r.points[r.track_valid > 0] for r in recons])
        color = np.concatenate([r.colors[r.track_valid > 0] for r in recons])
        ply_path = os.path.join(self.output_dir, "final_points.ply")
        write_ply(cloud, color, ply_path)
        cam_ply_path = os.path.join(self.output_dir, "final_camera_poses.ply")
        write_ply(np.asarray(centers).reshape(-1, 3),
                  np.tile([1.0, 0.0, 0.0], (len(centers), 1)), cam_ply_path)
        tum_path = os.path.join(self.output_dir, "trajectory_tum.txt")
        write_tum_trajectory(tum_path, np.asarray(centers), np.asarray(rotations),
                             integer_timestamps=True)
        print(f"Exported {cloud.shape[0]} points, {len(centers)} poses -> {self.output_dir}")
        artifacts = {"points": ply_path, "cameras": cam_ply_path, "trajectory": tum_path}
        if self.config.save_colmap:
            from ..io.colmap import write_colmap_text

            colmap_dir = os.path.join(self.output_dir, "colmap")
            artifacts["colmap"] = write_colmap_text(recons, colmap_dir)["images"]
            print(f"Exported COLMAP text model -> {colmap_dir}")
        return artifacts
