"""Offline chunk creation: run Pi3 over overlapping chunks of frames and
persist compact keypoint-sparse chunk files.

Port of ``pi3_slam_tpu/slam/chunk_creator.py`` (the single-device path). Per
chunk, :func:`make_chunk_step` runs the forward, the confidence and
depth-edge masks, intrinsics estimation and the keypoint sampling on the
device, and MoGe-2 depth on the chunk's first frame is queued right behind
it; the host decodes images (threaded prefetch), scales the chunk to metric
units by the median MoGe / Pi3 depth ratio, and writes the same
``chunk_*.npz`` keys and ``chunks_manifest.json`` as the JAX creator. A short
tail chunk is padded to ``chunk_length`` by repeating its last frame, as the
JAX creator pads it by default (the padded frames take part in Pi3's global
attention, so they change the tail's outputs), and its per-frame outputs are
sliced back; ``pad_tail_chunks=False`` (``--no-pad-tail``) runs it unpadded.
"""

from __future__ import annotations

import dataclasses
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
from ..models.moge import MISSING_CHECKPOINT, MoGeRunner
from ..models.pi3 import Pi3, Pi3Config
from ..ops import launch_counts
from ..ops.interpolate import grid_sample_frames
from ..utils.keypoints import grid_keypoints
from .config import OfflineCreatorConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    """The model dtype of ``--compute-dtype``, on any device: the kernels
    have bf16 and fp32 entries, as the JAX package computes either on its
    device."""
    if name not in _DTYPES:
        raise ValueError(f"--compute-dtype {name!r}: choose one of {sorted(_DTYPES)}")
    return _DTYPES[name]


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
            # frame 0's depth and mask, for the MoGe metric scale
            "depth0": local[0, ..., 2],
            "mask0": masks[0],
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

# per-frame outputs of the chunk step, sliced back to the real frame count
# after a tail chunk was padded (the JAX creator's _PER_FRAME_KEYS)
_PER_FRAME_KEYS = (
    "points_kp", "local_points_kp", "conf_kp", "masks_kp", "colors_kp", "camera_poses",
    "local_points_dense", "conf_dense", "masks_dense", "intrinsics",
)


def pad_tail(images: np.ndarray, kps: np.ndarray, target: int):
    """Pad a short tail chunk to ``target`` frames by repeating its last
    frame and that frame's keypoints (``target`` 0: no padding). Poses are
    relative to frame 0 and the alignment overlap sits at the chunk's start,
    so padding at the end disturbs neither."""
    n = images.shape[0]
    if n >= target:
        return images, kps
    print(f"   tail chunk padded {n} -> {target} frames")
    pad = target - n
    return (np.concatenate([images, np.repeat(images[-1:], pad, axis=0)]),
            np.concatenate([kps, np.repeat(kps[-1:], pad, axis=0)]))


def slice_tail(host: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Drop the padded frames of the per-frame outputs, if any."""
    return {k: v[:n] if k in _PER_FRAME_KEYS and v.shape[0] > n else v for k, v in host.items()}


def _store_dense_maps(
    result: Dict, host: Dict, scale_factor: float | None, stride: int, images: np.ndarray
) -> None:
    """Copy the strided dense maps into the chunk dict (the metric scale
    applies to the local point map), plus the strided uint8 rgb of the input
    frames (recomputed on the host, which holds them)."""
    if not any(k in host for k in _DENSE_KEYS):
        return
    for key in _DENSE_KEYS:
        result[key] = host[key]
    if scale_factor is not None:
        local = result["local_points_dense"].astype(np.float32) * scale_factor
        result["local_points_dense"] = local.astype(np.float16)
    result["rgb_dense"] = np.ascontiguousarray(images.transpose(0, 2, 3, 1)[:, ::stride, ::stride])
    result["dense_stride"] = np.int16(stride)


def device_timeline(trace_path: str) -> Dict[str, float]:
    """Traced window, device-busy time and idle share of a torch.profiler
    Chrome trace: the window spans every timed event (host and device), busy
    is the union of the device's kernel, memcpy and memset intervals."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e and "ts" in e]
    if not events:
        return {"window_ms": 0.0, "busy_ms": 0.0, "idle_share": 1.0}
    window = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for start, stop in device:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    window_ms, busy_ms = window / 1e3, busy / 1e3
    return {"window_ms": window_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / window_ms if window_ms > 0 else 1.0}


def load_models(config, pi3_config: Pi3Config | None, device: torch.device):
    """The Pi3 model (the checkpoint's, else random weights from seed 0) and
    the MoGe-2 runner (None when metric depth is off or its checkpoint was not
    given) of a creator or online config. Returns (model, pi3_config, moge)."""
    ckpt_cfg = None
    if config.checkpoint_path:
        print(f"Loading Pi3 weights: {config.checkpoint_path}")
        tree, ckpt_cfg = load_pi3_checkpoint(config.checkpoint_path)
    pi3_config = pi3_config or ckpt_cfg or Pi3Config()
    if config.global_kv_merge > 1:
        pi3_config = dataclasses.replace(pi3_config, global_kv_merge=config.global_kv_merge)
    if not config.checkpoint_path:
        print("No checkpoint given - random Pi3 weights (geometry will be noise)")
        tree = init_pi3_params(0, pi3_config)
    model = build_pi3(pi3_config, pi3_state_from_jax(tree), device,
                      compute_dtype(config.compute_dtype))
    del tree
    # only a checkpoint that was not given is skipped (the JAX creator's
    # message); any other failure to load or run MoGe raises
    moge = None
    if config.use_metric_depth:
        if config.moge_checkpoint_path is None:
            print(f"MoGe unavailable ({MISSING_CHECKPOINT}); continuing without metric depth")
        else:
            moge = MoGeRunner(config.moge_checkpoint_path, device)
    return model, pi3_config, moge


def metric_scale(moge_depth: np.ndarray | None, host: Dict) -> float | None:
    """The median MoGe / Pi3 depth ratio over frame 0's valid pixels, or None
    without MoGe or when fewer than 10 finite ratios remain (MoGe's depth is
    inf outside its validity mask)."""
    if moge_depth is None:
        return None
    mask0 = host["mask0"]
    ratio = moge_depth[mask0] / np.maximum(host["depth0"][mask0], 1e-9)
    ratio = ratio[np.isfinite(ratio)]
    return float(np.median(ratio)) if ratio.size >= 10 else None


class OfflineChunkCreator:
    def __init__(self, config: OfflineCreatorConfig, pi3_config: Pi3Config | None = None):
        self.config = config
        self.device = select_device(config.device)
        self.model, self.pi3_config, self.moge = load_models(config, pi3_config, self.device)
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
        """Upload one chunk and enqueue its device step and the MoGe forward on
        its first frame (asynchronous on the GPU: nothing here waits for the
        device)."""
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
        target = self.config.chunk_length if self.config.pad_tail_chunks else 0
        imgs, kps_dev = pad_tail(images, kps, target)
        imgs = torch.from_numpy(imgs).to(self.device, non_blocking=True)
        dev = self._step(imgs, torch.from_numpy(kps_dev).to(self.device))
        # queued behind the Pi3 step before the host sync; the first frame is
        # sliced from the uploaded chunk
        moge = self.moge.infer_depth_async(imgs[0]) if self.moge is not None else None
        return {"dev": dev, "moge": moge, "kps": kps, "t0": t0, "images": images,
                "paths": paths, "launches0": launches0}

    def _finish_chunk(self, pending: Dict) -> Dict:
        """Wait for a dispatched chunk and build its storage dict."""
        images = pending["images"]
        kps = pending["kps"]
        N = images.shape[0]
        host = {k: v.cpu().numpy() for k, v in pending["dev"].items()}  # sync point
        host = slice_tail(host, N)
        moge_depth = pending["moge"].cpu().numpy() if pending["moge"] is not None else None
        dt = max(1e-6, time.perf_counter() - pending["t0"])
        fps = N / dt
        print(f"   inference+interp: {dt:.3f}s for {N} frames -> {fps:.2f} FPS")
        launches = {k: v - pending["launches0"][k] for k, v in launch_counts().items()}
        if any(launches.values()):  # the hand-written kernels ran (GPU)
            print(f"   kernel launches: {json.dumps(launches)}")

        poses = host["camera_poses"].astype(np.float64)
        points_kp = host["points_kp"].astype(np.float64)
        local_kp = host["local_points_kp"].astype(np.float64)
        scale_factor = metric_scale(moge_depth, host)
        if scale_factor is not None:
            points_kp *= scale_factor
            local_kp *= scale_factor
            poses[:, :3, 3] *= scale_factor
        elif moge_depth is not None:
            print("   metric scale skipped: too few valid MoGe/Pi3 depth pairs")
        poses_cw = se3_inverse(torch.from_numpy(poses)).numpy().astype(np.float32)
        result = {
            "points": points_kp.astype(np.float16),
            "local_points": local_kp.astype(np.float16),
            "conf": host["conf_kp"].astype(np.float16),
            "masks": host["masks_kp"],
            "keypoints": kps.astype(np.float16),
            "colors": (host["colors_kp"] * 255).clip(0, 255).astype(np.uint8),
            "camera_poses": poses.astype(np.float32),
            "camera_poses_cw": poses_cw,
            "image_paths": np.asarray(pending["paths"]),
            "original_height": self.target_size[0],
            "original_width": self.target_size[1],
            "_metrics": {"infer_s": dt, "num_frames": N, "fps": fps, "launches": launches,
                         "metric_scale": scale_factor},
        }
        if scale_factor is not None:
            result["metric_scale"] = np.float32(scale_factor)
        if "intrinsics" in host:
            result["intrinsics"] = host["intrinsics"].astype(np.float32)
        _store_dense_maps(result, host, scale_factor, self.config.dense_stride, images)
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
        trace = os.path.join(self.config.profile_dir, "chunk_trace.json")
        prof.export_chrome_trace(trace)
        table = prof.key_averages().table(
            sort_by="self_device_time_total" if cuda else "self_cpu_time_total", row_limit=40
        )
        if cuda:
            t = device_timeline(trace)
            table += (f"\ntraced window {t['window_ms']:.1f} ms, device busy {t['busy_ms']:.1f} ms, "
                      f"idle share {t['idle_share']:.3f}\n")
        with open(os.path.join(self.config.profile_dir, "summary.txt"), "w") as f:
            f.write(table)
        print(f"   profiler trace written to {self.config.profile_dir}")
        return result

    def process_and_save(self, image_paths: List) -> List[Dict]:
        """Write one ``chunk_*.npz`` per chunk window plus the manifest.

        Returns one record per chunk: ``path`` and ``num_frames``, and for a
        chunk computed in this call (not skipped by ``resume``) also
        ``infer_s`` (upload to host copy), ``fps``, ``launches`` (kernel
        launches of the chunk, by wrapper name; all 0 on the CPU) and
        ``metric_scale`` (None without MoGe or with too few valid depth pairs).
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
                record.update(infer_s=m["infer_s"], fps=m["fps"], launches=m["launches"],
                              metric_scale=m["metric_scale"])
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
