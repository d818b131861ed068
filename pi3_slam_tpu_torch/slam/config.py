"""Chunk-creator and reconstructor configuration. Port of
``OfflineCreatorConfig`` and ``ReconstructorConfig`` from
``pi3_slam_tpu/slam/config.py`` (whose package ``__init__`` imports JAX),
and ``OnlineConfig`` with the fields of the ported paths.
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
    # model: 'pi3', or 'vggt' (VGGT-1B, random weights only; one device)
    model: str = "pi3"
    checkpoint_path: Optional[str] = None  # Pi3 .npz; None = random init (seed 0)
    compute_dtype: str = "bfloat16"
    # global-attention k/v merge over groups of frames (Pi3Config.global_kv_merge;
    # 1 = exact attention)
    global_kv_merge: int = 1
    # pad a short tail chunk to chunk_length by repeating its last frame (the
    # padded frames take part in the global attention, as in the JAX
    # creator's default); its per-frame outputs are sliced back
    pad_tail_chunks: bool = True
    # metric scale from MoGe-2 depth on each chunk's first frame
    use_metric_depth: bool = True
    moge_checkpoint_path: Optional[str] = None  # MoGe .npz; None = no metric scale
    # keypoints: 'grid', 'aliked' (learned, with descriptors) or 'none'
    # (dense maps only)
    keypoint_type: str = "grid"
    max_keypoints: int = 1000
    keypoint_threshold: float = 0.005  # ALIKED detection threshold (--kp-threshold)
    aliked_checkpoint_path: Optional[str] = None  # converted ALIKED .npz
    # camera
    estimate_camera_params: bool = True
    cam_dist_path: Optional[str] = None  # calibration JSON for undistortion
    # loader
    num_loader_workers: int = 2
    # Pi3: the sigmoid(conf) cutoff; VGGT: the share of the chunk's lowest
    # depth confidences dropped. None: the model's default_conf_threshold
    # (Pi3 0.1; VGGT 0.25, VGGT-SLAM's --conf_threshold 25)
    conf_threshold: Optional[float] = None
    depth_edge_rtol: float = 0.03
    # npz deflate level: 'default' (zlib 6), 'fast' (zlib 1), 'none' (STORED)
    chunk_compression: str = "default"
    # strided dense per-pixel maps stored alongside the sparse tracks
    save_dense: bool = False
    dense_stride: int = 1
    resume: bool = False  # skip chunks whose files already exist
    # chunk-level data parallelism: this many chunks a step, one on each dp
    # replica of the device mesh (1 = the single-device path)
    data_parallel_chunks: int = 1
    # tensor parallelism over attention heads / MLP hidden (the Megatron
    # split of parallel/mesh.py); dp * tp devices are used a step
    tensor_parallel: int = 1
    # sequence parallelism: ring attention over the sp mesh axis for the
    # global attention (parallel/ring.py); dp * tp * sp devices a step
    sequence_parallel: int = 1
    # torch.profiler trace of chunk 1 (the first after warm-up; with dp > 1
    # the second group), its npz writes and the program's spans included,
    # into this dir
    profile_dir: Optional[str] = None
    # ZNCC refinement of the observation fan inside the chunk step
    # (ops/correlation.py); the reconstructor then uses the stored fan
    refine_observations: bool = False
    refine_max_observations: int = 10
    refine_patch_radius: int = 3
    refine_search_radius: int = 4
    refine_min_zncc: float = 0.5


@dataclass
class ReconstructorConfig:
    """Port of the JAX package's ``ReconstructorConfig``, the same fields and
    defaults, plus ``device``."""

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
    # loop closure over non-adjacent chunks (sfm/loops.py, sfm/posegraph.py);
    # needs ALIKED chunks (descriptors): grid chunks detect nothing
    loop_closure: bool = False
    loop_min_inliers: int = 20
    loop_min_cosine: float = 0.85
    # telemetry-constrained refinement after loop closure (sfm/priors.py): a
    # file with gravity / GPS streams (generic JSON, or a GoPro MP4 parsed in
    # process) on the frame-timestamp timebase. GPS georeferences the
    # reconstruction into a local ENU frame; gravity constrains absolute
    # roll / pitch against the fixed world -z
    telemetry_path: Optional[str] = None
    gps_sigma: float = 2.0  # meters (0 disables GPS priors)
    gravity_sigma: float = 0.05  # unit-vector residual sigma (0 disables)
    telemetry_refine_iterations: int = 20
    # also export a COLMAP text model into <output>/colmap (io/colmap.py)
    save_colmap: bool = False
    # TSDF-fuse the chunks' dense maps (chunks created with --save-dense) on
    # ``device`` under the final aligned poses and export a surface-nets
    # triangle mesh to <output>/fused_mesh.ply (mapping/). mesh_voxel_size
    # <= 0 auto-sizes to ~192 voxels across the scene
    export_mesh: bool = False
    mesh_voxel_size: float = 0.0
    mesh_max_voxels: int = 192**3
    mesh_conf_threshold: float = 0.25
    mesh_min_weight: float = 1.0
    # raycast this many depth/normal preview PNG pairs of the fused volume
    # from evenly spaced final camera poses (mapping/raycast.py)
    mesh_preview_views: int = 0
    # also persist the fused TSDF volume (fused_volume.npz): re-mesh or
    # raycast later without re-fusing (TSDFVolume.load)
    save_volume: bool = False


@dataclass
class OnlineConfig:
    """Port of the JAX package's ``OnlineConfig``: the same fields and
    defaults, plus ``device``."""

    chunk_length: int = 30
    overlap: int = 5
    pixel_limit: int = 255000 // 2
    device: str = "cuda"
    checkpoint_path: Optional[str] = None  # Pi3 .npz; None = random init (seed 0)
    compute_dtype: str = "bfloat16"
    use_metric_depth: bool = True
    moge_checkpoint_path: Optional[str] = None  # MoGe .npz; None = no metric scale
    keypoint_type: str = "grid"
    max_keypoints: int = 1000
    keypoint_threshold: float = 0.005  # ALIKED detection threshold (--kp-threshold)
    aliked_checkpoint_path: Optional[str] = None
    estimate_camera_params: bool = True
    cam_dist_path: Optional[str] = None
    max_observations_per_track: int = 10
    # inverse-depth track parametrization in the per-chunk BA
    use_inverse_depth: bool = False
    # per-chunk BA iterations (build stage) and the Sim3 refine's prior BA
    # (finish stage): the ReconstructorConfig knobs
    ba_iterations: int = 10
    align_refine: bool = True
    align_refine_iterations: int = 50
    # sigmoid(conf) cutoff and depth-edge tolerance of the chunk step
    conf_threshold: float = 0.1
    depth_edge_rtol: float = 0.03
    # pad a short tail chunk to chunk_length (see OfflineCreatorConfig)
    pad_tail_chunks: bool = True
    global_kv_merge: int = 1
    num_loader_workers: int = 2
    visualize: bool = False
    viz_port: int = 8080
    output_dir: str = "online_output"
    # each chunk's aligned reconstruction as debug_recons/recon_XXXXXX.npz
    save_debug_recons: bool = False
    save_debug_projections: bool = False
    # per-alignment overlap diagnostic, printed and appended to
    # overlap_debug.jsonl
    debug_overlap: bool = False
    loop_closure: bool = False
    loop_min_inliers: int = 20
    loop_min_cosine: float = 0.85
    refine_observations: bool = False
    refine_max_observations: int = 10
    refine_patch_radius: int = 3
    refine_search_radius: int = 4
    refine_min_zncc: float = 0.5
    telemetry_path: Optional[str] = None
    gps_sigma: float = 2.0
    gravity_sigma: float = 0.05
    telemetry_refine_iterations: int = 20
    # keep the next chunk's forward in flight while the host consumes this one
    overlap_device_host: bool = True
    # run the SfM chain (pull, metric scale, BA, Sim3 alignment) on a consumer
    # thread fed by an in-order bounded queue, so it overlaps the next
    # chunk's forward; needs overlap_device_host
    async_sfm: bool = True
    # where BA and the Sim3 fits run: 'auto' / 'default' = the model's device
    # (on the card the consumer thread works on a CUDA stream of its own),
    # 'cpu' = the host
    sfm_backend: str = "auto"
    # the device mesh (see OfflineCreatorConfig); dp > 1 groups that many
    # chunks a step
    data_parallel_chunks: int = 1
    tensor_parallel: int = 1
    sequence_parallel: int = 1
    # strided dense per-pixel maps stashed per chunk under <output>/dense/
    save_dense: bool = False
    export_mesh: bool = False
    dense_stride: int = 2
    # npz deflate level of the dense stashes (see OfflineCreatorConfig)
    chunk_compression: str = "default"
    mesh_voxel_size: float = 0.0
    mesh_max_voxels: int = 192**3
    mesh_conf_threshold: float = 0.25
    mesh_min_weight: float = 1.0
    save_volume: bool = False
    live_mesh_every: int = 0
