"""Device meshes, the tensor-parallel split of Pi3, and the replicas of a
sharded step.

Port of ``pi3_slam_tpu/parallel/mesh.py``. The JAX package lays a device list
out on the axes ("dp", "tp"[, "sp"]) and runs one program over it under
GSPMD. Here a :class:`Mesh` is the same layout over ``torch.device``s, and a
sharded step runs one replica of the model per dp index (:class:`Replica`):

* ``dp``: the chunks (the batch) split over the replicas. With tp = sp = 1 a
  replica runs the single-device step unchanged: the packed attention route,
  rows 1-4 of the kernel table. The JAX package's unpacked route under a dp
  mesh exists only because a ``pallas_call`` is opaque to GSPMD
  (``pi3_slam_tpu/parallel/context.py:27-33``): a TPU workaround, not ported.
* ``tp``: within a replica, the Megatron split of :func:`pi3_param_shardings`
  over its tp devices (``context.TPShards``), the attention heads on tp.
* ``sp``: within a tp shard, the global attention's tokens over its sp
  devices by ring attention (``ring.py``), and the block MLP's rows.

Replicas on distinct devices launch from threads of their own
(:func:`run_on_devices`), so that no card waits on another card's launches;
replicas that share a device run one after the other, in order, so their
outputs do not depend on timing. A replica on a device that already holds the
weights shares them: ``Tensor.to`` on the same device makes no copy.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from .context import TPShards, tp_mesh_context

AXES = ("dp", "tp", "sp")


def _device(d) -> torch.device:
    """``d`` as a torch.device with a CUDA index made explicit."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices on named axes: ("dp", "tp"), or ("dp", "tp", "sp") when sp > 1.

    ``grid`` is the (dp, tp, sp) object array of ``torch.device``s (sp 1 when
    the mesh has no sp axis). A replica's sub-mesh (:meth:`replica`) keeps the
    size of the whole mesh in ``whole_size``: the model reads a mesh as active
    when the whole mesh has more than one member."""

    def __init__(self, grid: np.ndarray, axis_names: tuple, whole_size: int | None = None):
        self.grid = grid
        self.axis_names = tuple(axis_names)
        self.whole_size = whole_size or grid.size

    @property
    def shape(self) -> dict[str, int]:
        return {name: self.axis_size(name) for name in self.axis_names}

    @property
    def devices(self) -> np.ndarray:
        """The devices with the mesh's named axes (the JAX ``Mesh.devices``)."""
        return self.grid.reshape(tuple(self.shape.values()))

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def axis_size(self, name: str) -> int:
        return int(self.grid.shape[AXES.index(name)])

    def device(self, dp: int = 0, tp: int = 0, sp: int = 0) -> torch.device:
        return self.grid[dp, tp, sp]

    def sp_devices(self, tp: int = 0, dp: int = 0) -> list[torch.device]:
        """The devices of one tp shard's sequence shards, in ring order."""
        return list(self.grid[dp, tp])

    def replica(self, i: int) -> "Mesh":
        """The sub-mesh of dp index ``i`` (dp 1, the same axis names)."""
        return Mesh(self.grid[i : i + 1], self.axis_names, self.whole_size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.grid.flat]})"


def mesh_devices(device="cuda") -> list[torch.device]:
    """The devices a CLI lays a mesh over: every visible CUDA card for
    ``cuda``, the one device otherwise (``cpu``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_dp: int, n_tp: int, devices=None, *, n_sp: int = 1) -> Mesh:
    """(dp, tp[, sp]) mesh over the first dp * tp * sp entries of ``devices``
    (None: every visible CUDA device). A device may appear more than once.
    sp is an axis of the mesh only when > 1, as in the JAX package. Raises
    ValueError when the list is too short."""
    devices = mesh_devices("cuda") if devices is None else [_device(d) for d in devices]
    n = n_dp * n_tp * n_sp
    if n < 1 or len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = d
    names = AXES if n_sp > 1 else AXES[:2]
    return Mesh(grid.reshape(n_dp, n_tp, n_sp), names)


def _is_block(m: nn.Module) -> bool:
    return hasattr(m, "qkv") and hasattr(m, "fc1") and hasattr(m, "norm2")


def pi3_param_shardings(model: nn.Module) -> dict[str, str]:
    """The tp split of a Pi3 model: {Linear module name: "col" | "row"}, where
    the JAX spec (``pi3_slam_tpu/parallel/mesh.py:52-147``) names "tp".

    "col" splits the output features (the weight's rows and the bias), "row"
    the input features (the weight's columns; the bias is added once after
    the shards' partial sums). Every block's ``proj`` and ``fc2`` are "row",
    ``fc1`` "col"; ``qkv`` stays replicated (the JAX spec's reason: its packed
    q | k | v columns do not shard by head); every other parameter not named
    here is replicated."""
    spec = {"encoder.patch_embed": "col"}
    for name, m in model.named_modules():
        if _is_block(m):
            spec.update({f"{name}.proj": "row", f"{name}.fc1": "col", f"{name}.fc2": "row"})
    for head in ("point_decoder", "conf_decoder", "camera_decoder"):
        spec.update({f"{head}.project": "col", f"{head}.out": "row"})
    spec.update({"point_head": "col", "conf_head": "col"})
    for i in range(2):
        spec.update({f"camera_head.res_conv.{i}.fc1": "col", f"camera_head.res_conv.{i}.fc2": "row",
                     f"camera_head.res_conv.{i}.fc3": "col"})
    spec.update({"camera_head.mlp1": "col", "camera_head.mlp2": "row"})
    return spec


def shard_pi3(model: nn.Module, mesh: Mesh) -> TPShards:
    """One replica's tp shards (``mesh``: the replica's dp-1 sub-mesh): each
    split Linear's slices on its tp devices. A "col" slice is a view of the
    weight where the device holds it; a "row" slice is a contiguous copy."""
    tp = mesh.axis_size("tp")
    layers = {}
    if tp > 1:
        modules = dict(model.named_modules())
        for name, kind in pi3_param_shardings(model).items():
            m = modules[name]
            n = m.out_features if kind == "col" else m.in_features
            if n % tp:
                raise ValueError(f"{name}: {n} features do not split over tp {tp}")
            s = n // tp
            parts = []
            for j in range(tp):
                dev = mesh.device(tp=j)
                if kind == "col":
                    w, b = m.weight[j * s : (j + 1) * s], m.bias[j * s : (j + 1) * s]
                    parts.append((w.to(dev), b.to(dev)))
                else:
                    parts.append((m.weight[:, j * s : (j + 1) * s].contiguous().to(dev), None))
            layers[id(m)] = (kind, parts)
    return TPShards(mesh, layers)


def replicate(module: nn.Module, device) -> nn.Module:
    """``module`` on ``device``: the module itself where every parameter and
    buffer already lies there, else a copy whose tensors are moved there."""
    device = _device(device)
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device == device for t in tensors):
        return module
    memo = {}
    for t in tensors:
        moved = t.detach().to(device)
        memo[id(t)] = nn.Parameter(moved, requires_grad=False) if isinstance(t, nn.Parameter) else moved
    return copy.deepcopy(module, memo)


def run_on_devices(jobs: Sequence[tuple[torch.device, Callable[[], object]]]) -> list:
    """Run each (device, fn) job and return their results in order. Jobs on
    one device run one after the other in one thread; the jobs of distinct
    devices run from threads of their own (all inline when there is one
    device). The first error is raised after every thread has ended."""
    groups: dict = {}
    for i, (dev, _) in enumerate(jobs):
        groups.setdefault(dev, []).append(i)
    results: list = [None] * len(jobs)

    def run(indices):
        for i in indices:
            results[i] = jobs[i][1]()

    if len(groups) <= 1:
        run(range(len(jobs)))
        return results
    with ThreadPoolExecutor(len(groups), thread_name_prefix="replica") as pool:
        futures = [pool.submit(run, indices) for indices in groups.values()]
    for f in futures:
        f.result()
    return results


class Replica:
    """One dp index of a sharded step: the model on the replica's first
    device, its sub-mesh and its tp shards. ``run(fn, *args)`` calls ``fn``
    with the replica's mesh active."""

    def __init__(self, model: nn.Module, mesh: Mesh, i: int):
        self.mesh = mesh.replica(i)
        self.device = self.mesh.device()
        self.model = replicate(model, self.device)
        self.shards = shard_pi3(self.model, self.mesh)

    def run(self, fn: Callable, *args):
        with tp_mesh_context(self.mesh, self.shards):
            return fn(*args)


def make_replicas(model: nn.Module, mesh: Mesh) -> list[Replica]:
    return [Replica(model, mesh, i) for i in range(mesh.axis_size("dp"))]


def make_sharded_pi3_step(model: nn.Module, mesh: Mesh):
    """The Pi3 forward over the mesh: returns (step, replicas), and
    ``step(replicas, imgs)`` runs (B, N, 3, H, W) images with B split over dp
    (B must divide by it) and each replica's tp / sp split inside its forward;
    the outputs are concatenated on the mesh's first device."""
    replicas = make_replicas(model, mesh)

    @torch.no_grad()
    def step(replicas: list[Replica], imgs: torch.Tensor) -> dict[str, torch.Tensor]:
        dp = len(replicas)
        if imgs.shape[0] % dp:
            raise ValueError(f"batch {imgs.shape[0]} does not split over dp {dp}")
        per = imgs.shape[0] // dp
        jobs = [(r.device, lambda r=r, i=i: r.run(r.model, imgs[i * per : (i + 1) * per].to(r.device)))
                for i, r in enumerate(replicas)]
        outs = run_on_devices(jobs)
        lead = replicas[0].device
        return {k: torch.cat([o[k].to(lead) for o in outs]) for k in outs[0]}

    return step, replicas
