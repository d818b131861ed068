"""Structure from motion: bundle adjustment, chunk reconstruction, Sim3
chunk alignment, loop closure, second-camera localization (port of
``pi3_slam_tpu/sfm``)."""

from .ba import BAProblem, bundle_adjust, reprojection_errors
from .reconstruction import ChunkReconstruction, build_chunk_reconstruction
from .alignment import align_chunks, AlignmentResult
from .posegraph import optimize_sim3_pose_graph, PoseGraphResult
from .loops import close_loops, detect_loop_closures, LoopEdge
from .localize import (
    ransac_pnp,
    localize_by_descriptors,
    register_reconstruction,
    triangulate_points,
    build_query_tracks,
    LocalizationResult,
    RegistrationResult,
)

__all__ = [
    "BAProblem",
    "bundle_adjust",
    "reprojection_errors",
    "ChunkReconstruction",
    "build_chunk_reconstruction",
    "align_chunks",
    "AlignmentResult",
    "optimize_sim3_pose_graph",
    "PoseGraphResult",
    "close_loops",
    "detect_loop_closures",
    "LoopEdge",
    "ransac_pnp",
    "localize_by_descriptors",
    "register_reconstruction",
    "triangulate_points",
    "build_query_tracks",
    "LocalizationResult",
    "RegistrationResult",
]
