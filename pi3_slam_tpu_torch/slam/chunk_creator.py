"""Offline chunk creation: run Pi3 over overlapping chunks of frames and
persist compact keypoint-sparse chunk files.

Port of ``pi3_slam_tpu/slam/chunk_creator.py`` (the single-device path). Per
chunk, :func:`make_chunk_step` runs the forward, the confidence and
depth-edge masks, intrinsics estimation and the keypoint sampling on the
device; the host decodes images (threaded prefetch) and writes the same
``chunk_*.npz`` keys and ``chunks_manifest.json`` as the JAX creator. Tail
chunks run unpadded (the JAX ``--no-pad-tail`` output).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..data import ChunkDataset, PrefetchLoader, calculate_target_size
from ..data.undistortion import create_undistorter
from ..device import select_device
from ..geometry.focal import estimate_camera_parameters
from ..geometry.maps import depth_edge
from ..geometry.transforms import se3_inverse
from ..io.npz import save_npz
from ..models.convert import build_pi3, init_pi3_params, load_pi3_checkpoint, pi3_state_from_jax
from ..models.pi3 import Pi3, Pi3Config
from ..ops import launch_counts
from ..ops.interpolate import grid_sample_frames
from ..utils.keypoints import grid_keypoints
from .config import OfflineCreatorConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_chunk_step(
    model: Pi3,
    conf_threshold: float,
    edge_rtol: float,
    estimate_intrinsics: bool,
    return_dense: bool = False,
    dense_stride: int = 1,
):
    """Per-chunk device step: step(images (N, 3, H, W) uint8, keypoints
    (N, K, 2)) -> dict of device tensors."""

    @torch.no_grad()
    def step(images: torch.Tensor, keypoints: torch.Tensor) -> Dict[str, torch.Tensor]:
        images = images.float() / 255.0
        out = model(images[None])
        local = out["local_points"][0]  # (N, H, W, 3)
        world = out["points"][0]
        conf = out["conf"][0]  # (N, H, W, 1)
        poses = out["camera_poses"][0]  # (N, 4, 4)

        conf_mask = torch.sigmoid(conf[..., 0]) > conf_threshold
        non_edge = ~depth_edge(local[..., 2], rtol=edge_rtol)
        masks = conf_mask & non_edge  # (N, H, W)

        # bilinear for points and colours, nearest for confidence and masks
        result = {
            "points_kp": grid_sample_frames(world, keypoints, mode="bilinear"),
            "local_points_kp": grid_sample_frames(local, keypoints, mode="bilinear"),
            "conf_kp": grid_sample_frames(conf, keypoints, mode="nearest"),
            "masks_kp": grid_sample_frames(masks[..., None].float(), keypoints, mode="nearest")[..., 0]
            > 0.5,
            "colors_kp": grid_sample_frames(images.permute(0, 2, 3, 1), keypoints, mode="bilinear"),
            "camera_poses": poses,
        }
        if estimate_intrinsics:
            result["intrinsics"] = estimate_camera_parameters(local, conf)["intrinsics"]
        if return_dense:
            s = dense_stride
            result["local_points_dense"] = local[:, ::s, ::s].half()
            result["conf_dense"] = conf[:, ::s, ::s].half()
            result["masks_dense"] = masks[:, ::s, ::s]
        return result

    return step


_DENSE_KEYS = ("local_points_dense", "conf_dense", "masks_dense")


def _store_dense_maps(result: Dict, host: Dict, stride: int, images: np.ndarray) -> None:
    """Copy the strided dense maps into the chunk dict, plus the strided uint8
    rgb of the input frames (recomputed on the host, which holds them)."""
    if not any(k in host for k in _DENSE_KEYS):
        return
    for key in _DENSE_KEYS:
        result[key] = host[key]
    result["rgb_dense"] = np.ascontiguousarray(images.transpose(0, 2, 3, 1)[:, ::stride, ::stride])
    result["dense_stride"] = np.int16(stride)


class OfflineChunkCreator:
    def __init__(self, config: OfflineCreatorConfig, pi3_config: Pi3Config | None = None):
        self.config = config
        self.device = select_device(config.device)
        dtype = _DTYPES[config.compute_dtype]
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise ValueError(
                "--compute-dtype float32 is not supported on the GPU: the hand-written "
                "kernels take bfloat16 (see ROADMAP.md)"
            )
        ckpt_cfg = None
        if config.checkpoint_path:
            print(f"Loading Pi3 weights: {config.checkpoint_path}")
            tree, ckpt_cfg = load_pi3_checkpoint(config.checkpoint_path)
        self.pi3_config = pi3_config or ckpt_cfg or Pi3Config()
        if not config.checkpoint_path:
            print("No checkpoint given - random Pi3 weights (geometry will be noise)")
            tree = init_pi3_params(0, self.pi3_config)
        self.model = build_pi3(self.pi3_config, pi3_state_from_jax(tree), self.device, dtype)
        del tree
        self.undistorter = create_undistorter(config.cam_dist_path) if config.cam_dist_path else None
        self.target_size = None
        self.chunks_dir = os.path.join(config.output_dir, "chunks")
        os.makedirs(self.chunks_dir, exist_ok=True)
        dense = config.keypoint_type == "none" or config.save_dense
        self._step = make_chunk_step(
            self.model,
            config.conf_threshold,
            config.depth_edge_rtol,
            config.estimate_camera_params,
            return_dense=dense,
            dense_stride=config.dense_stride,
        )

    def _dispatch_chunk(self, images: np.ndarray, paths: List[str]) -> Dict:
        """Upload one chunk and enqueue its device step (asynchronous on the
        GPU: nothing here waits for the device)."""
        N, _, H, W = images.shape
        if self.config.keypoint_type == "none":
            # a single centre point keeps the step's outputs well-formed; the
            # dense maps are what is stored
            kp = np.array([[W / 2.0, H / 2.0]], dtype=np.float32)
        else:
            kp = grid_keypoints(H, W, self.config.max_keypoints)
        kps = np.broadcast_to(kp[None], (N, kp.shape[0], 2)).astype(np.float32)
        t0 = time.perf_counter()
        launches0 = launch_counts()
        imgs = torch.from_numpy(images).to(self.device, non_blocking=True)
        dev = self._step(imgs, torch.from_numpy(kps).to(self.device))
        return {"dev": dev, "kps": kps, "t0": t0, "images": images, "paths": paths,
                "launches0": launches0}

    def _finish_chunk(self, pending: Dict) -> Dict:
        """Wait for a dispatched chunk and build its storage dict."""
        images = pending["images"]
        kps = pending["kps"]
        N = images.shape[0]
        host = {k: v.cpu().numpy() for k, v in pending["dev"].items()}  # sync point
        dt = max(1e-6, time.perf_counter() - pending["t0"])
        fps = N / dt
        print(f"   inference+interp: {dt:.3f}s for {N} frames -> {fps:.2f} FPS")
        launches = {k: v - pending["launches0"][k] for k, v in launch_counts().items()}
        if any(launches.values()):  # the hand-written kernels ran (GPU)
            print(f"   kernel launches: {json.dumps(launches)}")

        poses = host["camera_poses"].astype(np.float64)
        poses_cw = se3_inverse(torch.from_numpy(poses)).numpy().astype(np.float32)
        result = {
            "points": host["points_kp"].astype(np.float16),
            "local_points": host["local_points_kp"].astype(np.float16),
            "conf": host["conf_kp"].astype(np.float16),
            "masks": host["masks_kp"],
            "keypoints": kps.astype(np.float16),
            "colors": (host["colors_kp"] * 255).clip(0, 255).astype(np.uint8),
            "camera_poses": poses.astype(np.float32),
            "camera_poses_cw": poses_cw,
            "image_paths": np.asarray(pending["paths"]),
            "original_height": self.target_size[0],
            "original_width": self.target_size[1],
            "_metrics": {"infer_s": dt, "num_frames": N, "fps": fps, "launches": launches},
        }
        if "intrinsics" in host:
            result["intrinsics"] = host["intrinsics"].astype(np.float32)
        _store_dense_maps(result, host, self.config.dense_stride, images)
        if self.config.keypoint_type == "none":
            for key in ("points", "local_points", "conf", "masks", "keypoints", "colors"):
                result.pop(key)
            result["dense"] = np.bool_(True)
        return result

    def _profiled(self, run):
        """Run ``run()`` under torch.profiler; write the Chrome trace and a
        per-kernel summary into ``config.profile_dir``."""
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(self.config.profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            result = run()
        prof.export_chrome_trace(os.path.join(self.config.profile_dir, "chunk_trace.json"))
        table = prof.key_averages().table(
            sort_by="self_device_time_total" if cuda else "self_cpu_time_total", row_limit=40
        )
        with open(os.path.join(self.config.profile_dir, "summary.txt"), "w") as f:
            f.write(table)
        print(f"   profiler trace written to {self.config.profile_dir}")
        return result

    def process_and_save(self, image_paths: List) -> List[Dict]:
        """Write one ``chunk_*.npz`` per chunk window plus the manifest.

        Returns one record per chunk: ``path`` and ``num_frames``, and for a
        chunk computed in this call (not skipped by ``resume``) also
        ``infer_s`` (upload to host copy), ``fps`` and ``launches`` (kernel
        launches of the chunk, by wrapper name; all 0 on the CPU).
        """
        if not image_paths:
            raise ValueError("image_paths is empty")
        cfg = self.config
        self.target_size = calculate_target_size(image_paths[0], cfg.pixel_limit)
        print(f"Target size: {self.target_size}")
        dataset = ChunkDataset(
            image_paths, cfg.chunk_length, cfg.overlap, self.target_size,
            undistorter=self.undistorter,
        )
        loader = PrefetchLoader(dataset, num_workers=cfg.num_loader_workers)
        records, manifest, fps_full = [], [], []
        total_frames, total_s = 0, 0.0
        print(f"Processing {len(dataset)} chunks...")
        for batch in loader:
            idx = batch["chunk_idx"]
            out_name = f"chunk_{idx:06d}.npz"
            out_path = os.path.join(self.chunks_dir, out_name)
            record = {"path": out_path, "num_frames": batch["images"].shape[0]}
            if cfg.resume and os.path.exists(out_path):
                print(f"   resume: {out_path} exists, skipping")
            else:
                def run():
                    return self._finish_chunk(self._dispatch_chunk(batch["images"], batch["paths"]))

                result = self._profiled(run) if cfg.profile_dir and idx == 1 else run()
                m = result.pop("_metrics")
                record.update(infer_s=m["infer_s"], fps=m["fps"], launches=m["launches"])
                total_frames += m["num_frames"]
                total_s += m["infer_s"]
                if m["num_frames"] == cfg.chunk_length:
                    fps_full.append(m["fps"])
                result["chunk_index"] = idx
                result["start_idx"] = batch["start"]
                result["end_idx"] = batch["end"]
                save_npz(out_path, cfg.chunk_compression, **result)
                print(f"   saved {out_path}")
            records.append(record)
            manifest.append(
                {
                    "chunk_index": idx,
                    "file": out_name,
                    "start_idx": batch["start"],
                    "end_idx": batch["end"],
                    "num_frames": batch["images"].shape[0],
                    "image_paths": list(batch["paths"]),
                }
            )
        if total_s > 0:
            print(f"Overall inference: {total_frames} frames in {total_s:.2f}s "
                  f"-> {total_frames / total_s:.2f} FPS")
        if fps_full:
            print(f"Steady-state FPS (median over full chunks): {sorted(fps_full)[len(fps_full) // 2]:.2f}")
        with open(os.path.join(cfg.output_dir, "chunks_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        with open(os.path.join(cfg.output_dir, "chunk_metadata.json"), "w") as f:
            json.dump(
                {
                    "chunk_length": int(cfg.chunk_length),
                    "overlap": int(cfg.overlap),
                    "target_size": list(self.target_size),
                },
                f,
                indent=2,
            )
        print(f"Saved {len(records)} chunks to {self.chunks_dir}")
        return records
