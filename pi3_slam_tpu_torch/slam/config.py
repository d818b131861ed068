"""Chunk-creator and reconstructor configuration. Port of
``OfflineCreatorConfig`` and ``ReconstructorConfig`` from
``pi3_slam_tpu/slam/config.py`` (whose package ``__init__`` imports JAX),
with the fields of the ported paths. Tail chunks always run unpadded (eager
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
    # global-attention k/v merge over groups of frames (Pi3Config.global_kv_merge;
    # 1 = exact attention)
    global_kv_merge: int = 1
    # metric scale from MoGe-2 depth on each chunk's first frame
    use_metric_depth: bool = True
    moge_checkpoint_path: Optional[str] = None  # MoGe .npz; None = no metric scale
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


@dataclass
class ReconstructorConfig:
    """Port of the JAX package's ``ReconstructorConfig`` with the fields of
    the ported offline path; telemetry priors, loop closure, COLMAP export
    and mesh fusion are not ported (the CLI refuses their flags)."""

    chunk_dir: str = "output_chunks"
    output_dir: Optional[str] = None
    chunk_length: Optional[int] = None  # from chunk_metadata.json when present
    overlap: Optional[int] = None
    max_observations_per_track: int = 10
    # 'subsampled': earlier frames evenly subsampled to the observation
    # budget (fixed width M); 'unbounded': every earlier frame
    observation_fan: str = "subsampled"
    use_inverse_depth: bool = False
    ba_iterations: int = 10
    # pose-prior refinement after each Sim3 alignment (50 Huber-3.0
    # iterations at most)
    align_refine: bool = True
    align_refine_iterations: int = 50
    save_debug: bool = False  # also save recon_XXXXXX.npz per chunk
    # where the bundle adjustments and Sim3 fits run ('cuda' or 'cpu')
    device: str = "cuda"
