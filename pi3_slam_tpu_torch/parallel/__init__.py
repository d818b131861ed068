"""Multi-device: device meshes, tensor- and sequence-parallel Pi3, ring
attention, and the replicas of chunk data parallelism.

Port of ``pi3_slam_tpu/parallel/``. As there, one process drives a list of
devices laid out on named axes (single controller); a device may appear more
than once in the list, so one card can hold a whole dp x tp x sp mesh.
"""

from .mesh import (
    Mesh,
    make_mesh,
    make_sharded_pi3_step,
    mesh_devices,
    pi3_param_shardings,
    replicate,
    run_on_devices,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_sharded_pi3_step",
    "mesh_devices",
    "pi3_param_shardings",
    "replicate",
    "run_on_devices",
]
