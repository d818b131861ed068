"""Artifact IO: PLY point clouds and triangle meshes, TUM trajectories, COLMAP
text models, chunk files."""

from .ply import write_ply, read_ply
from .mesh import write_mesh_ply, read_mesh_ply
from .tum import write_tum_trajectory, read_tum_trajectory
from .colmap import write_colmap_text
from .npz import save_npz

__all__ = [
    "write_ply",
    "read_ply",
    "write_mesh_ply",
    "read_mesh_ply",
    "write_tum_trajectory",
    "read_tum_trajectory",
    "write_colmap_text",
    "save_npz",
]
