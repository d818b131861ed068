"""Chunk-creator configuration. Port of ``OfflineCreatorConfig`` from
``pi3_slam_tpu/slam/config.py`` (whose package ``__init__`` imports JAX),
with the fields of this slice. Tail chunks always run unpadded (eager
PyTorch has no recompile cost), so there is no ``pad_tail_chunks`` field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class OfflineCreatorConfig:
    output_dir: str = "output_chunks"
    chunk_length: int = 100
    overlap: int = 10
    pixel_limit: int = 255000 // 2
    device: str = "cuda"
    # model
    checkpoint_path: Optional[str] = None  # Pi3 .npz; None = random init (seed 0)
    compute_dtype: str = "bfloat16"
    # keypoints: 'grid', or 'none' (dense maps only)
    keypoint_type: str = "grid"
    max_keypoints: int = 1000
    # camera
    estimate_camera_params: bool = True
    cam_dist_path: Optional[str] = None  # calibration JSON for undistortion
    # loader
    num_loader_workers: int = 2
    conf_threshold: float = 0.1
    depth_edge_rtol: float = 0.03
    # npz deflate level: 'default' (zlib 6), 'fast' (zlib 1), 'none' (STORED)
    chunk_compression: str = "default"
    # strided dense per-pixel maps stored alongside the sparse tracks
    save_dense: bool = False
    dense_stride: int = 1
    resume: bool = False  # skip chunks whose files already exist
    # torch.profiler trace of chunk 1 (the first after warm-up) into this dir
    profile_dir: Optional[str] = None
