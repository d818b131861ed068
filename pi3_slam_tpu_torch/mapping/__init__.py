"""Dense mapping: TSDF fusion of Pi3 depth maps + mesh extraction.

Port of ``pi3_slam_tpu/mapping/``: the dense per-pixel point maps Pi3
produces are fused into a truncated signed distance volume on the device
(mapping/tsdf.py), meshed on the host with a vectorized surface-nets
extractor (mapping/surface_nets.py) and raycast on the device
(mapping/raycast.py). Beyond the reference, which exports point clouds only.
"""

from .tsdf import TSDFConfig, TSDFVolume, fuse_tsdf
from .surface_nets import sdf_vertex_normals, surface_nets
from .fuse import fuse_chunks
from .raycast import raycast_depth

__all__ = [
    "TSDFConfig", "TSDFVolume", "fuse_tsdf", "surface_nets",
    "sdf_vertex_normals", "fuse_chunks", "raycast_depth",
]
