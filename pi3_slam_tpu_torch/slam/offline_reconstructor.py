"""Offline reconstruction: load chunk files, bundle-adjust each chunk, chain
the Sim3 alignments, export the merged point cloud, camera centers and TUM
trajectory.

Port of ``pi3_slam_tpu/slam/offline_reconstructor.py`` (``load_chunk_npz``,
``OfflineReconstructor.run`` and ``export``): the same artifacts
(``final_points.ply``, ``final_camera_poses.ply``, ``trajectory_tum.txt``
with integer timestamps, views deduplicated by name), with loop closure over
non-adjacent chunks after the chain when ``config.loop_closure`` is set
(``sfm/loops.py``). The solves run on ``config.device``.
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
        plus its "seconds"; None without ``loop_closure``), "artifacts"
        (output paths), "timings" (per
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
        return {"reconstructions": recons, "alignment": align_stats, "loop_closure": loop_stats,
                "artifacts": self.export(recons), "timings": timings}

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
        return {"points": ply_path, "cameras": cam_ply_path, "trajectory": tum_path}
