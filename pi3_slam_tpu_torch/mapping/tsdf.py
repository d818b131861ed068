"""TSDF fusion of depth maps into a voxel volume, on the device.

Port of ``pi3_slam_tpu/mapping/tsdf.py``: KinectFusion-style projective
truncated-signed-distance integration (Newcombe et al. 2011). The voxel grid
is a flat (V,) state; each frame's update is one (V, 3) @ (3, 3) product and
a row gather from the packed per-pixel table [depth | conf | rgb]. The
direction is voxel -> pixel: each voxel projects itself into the frame and
gathers one pixel row, so no two samples ever write to one voxel and the
update needs no scatter and no atomics: two runs on the card give the same
volume bit for bit.

The JAX package computes this in XLA under ``lax.scan`` (no Pallas kernel);
here it is a loop over frames of PyTorch ops on an explicit ``device``, with
the flat state (tsdf, weight, color) on the device across frames and, when
``volume=`` continues a volume that ``fuse_tsdf`` returned, across calls.

Numerics follow the JAX body op for op: the projection product in fp32 (the
JAX ``precision=HIGHEST``; ``device.select_device`` switches TF32 off where
the fusion starts), ``round`` half to even in both frameworks, the +1
free-space init kept for never-observed voxels. The pixel index is
``round(fx * x / z + cx)``: where ``u`` lands within rounding of .5, another
summation order in the product moves the voxel to the neighbouring pixel. So
the voxel centers and ``rot @ center`` are summed as XLA sums them on the host
(fused multiply-adds), and on the host CPU the port picks the JAX package's
pixel for every voxel; on the card cuBLAS may sum the product in another
order, and a few voxels of a large grid may differ from the host's.

The reference has no dense-mapping subsystem (point-cloud export only,
pi3/utils/basic.py:377-459); this consumes the dense per-pixel maps its
chunks already carry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import select_device


@dataclass(frozen=True)
class TSDFConfig:
    voxel_size: float = 0.02
    # truncation band in meters; default 4 voxels
    trunc: Optional[float] = None
    # observations with sigmoid-confidence below this carry no weight
    conf_threshold: float = 0.25
    depth_min: float = 1e-3
    depth_max: float = 1e4
    # memory/runtime cap: if the requested bounds need more voxels, the
    # voxel size is coarsened to fit (isotropically)
    max_voxels: int = 192**3

    @property
    def trunc_dist(self) -> float:
        return self.trunc if self.trunc is not None else 4.0 * self.voxel_size


def resolve_device(device) -> torch.device:
    """``device`` through ``select_device`` (TF32 off; ``cuda`` without a GPU
    raises), with a CUDA device's index made explicit so that it compares
    equal to a tensor's ``.device``."""
    dev = select_device(str(device))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TSDFVolume:
    """Fused volume. tsdf is normalized to [-1, 1] (units of trunc_dist);
    weight > 0 marks observed voxels.

    The host arrays tsdf (X, Y, Z) f32, weight (X, Y, Z) f32 and color
    (X, Y, Z, 3) f32 in [0, 1] are the JAX dataclass's fields. A volume that
    ``fuse_tsdf`` returns holds its flat state on the fusion device and pulls
    the host arrays at their first read; until then ``fuse_tsdf(...,
    volume=)`` on that device continues from the device state without a
    copy. After the first read the host arrays are the volume, as in JAX."""

    def __init__(self, tsdf, weight, color, origin, voxel_size, trunc_dist):
        self._tsdf, self._weight, self._color = tsdf, weight, color
        self.origin = origin  # (3,) world coords of voxel (0, 0, 0) center
        self.voxel_size = voxel_size
        self.trunc_dist = trunc_dist
        self._state = None  # flat (tsdf, weight, color) device tensors, not yet pulled
        self._dims = None if tsdf is None else tuple(np.shape(tsdf))
        # per-instance caches (device copy of the flat tsdf for raycasting,
        # host SDF gradient for normals): filled lazily, never compared
        self._cache: dict = {}

    @classmethod
    def _from_state(cls, state, dims, origin, voxel_size, trunc_dist) -> "TSDFVolume":
        vol = cls(None, None, None, origin, voxel_size, trunc_dist)
        vol._state, vol._dims = state, tuple(dims)
        return vol

    def _pull(self) -> None:
        tsdf, weight, color = self._state
        X, Y, Z = self._dims
        self._tsdf = tsdf.cpu().numpy().reshape(X, Y, Z)
        self._weight = weight.cpu().numpy().reshape(X, Y, Z)
        self._color = color.cpu().numpy().reshape(X, Y, Z, 3)
        # the device tsdf serves raycasts of this volume; the state is no
        # longer continued (the host arrays may change from here on)
        self._cache["tsdf_dev"] = tsdf
        self._state = None

    @property
    def tsdf(self) -> np.ndarray:
        if self._state is not None:
            self._pull()
        return self._tsdf

    @property
    def weight(self) -> np.ndarray:
        if self._state is not None:
            self._pull()
        return self._weight

    @property
    def color(self) -> np.ndarray:
        if self._state is not None:
            self._pull()
        return self._color

    def device_state(self, device: torch.device):
        """Flat (tsdf (V,), weight (V,), color (V, 3)) fp32 tensors on
        ``device``: the unread device state where it lies there, else
        uploaded from the host arrays. Fusion makes new tensors and never
        writes into these, so this volume stays as it is."""
        if self._state is not None and self._state[0].device == device:
            return self._state
        V = int(np.prod(self.shape))

        def up(a, *shape):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32).reshape(shape)).to(device)

        return up(self.tsdf, V), up(self.weight, V), up(self.color, V, 3)

    def device_tsdf_flat(self, device="cuda") -> torch.Tensor:
        """Flat (V,) copy of the tsdf grid on ``device``, uploaded once per
        volume: per-view raycasts over the same volume do not re-ship it."""
        dev = resolve_device(device)
        if self._state is not None and self._state[0].device == dev:
            return self._state[0]
        cached = self._cache.get("tsdf_dev")
        if cached is None or cached.device != dev:
            cached = torch.from_numpy(np.ascontiguousarray(self.tsdf, np.float32).reshape(-1)).to(dev)
            self._cache["tsdf_dev"] = cached
        return cached

    def sdf_gradient(self) -> np.ndarray:
        """(X, Y, Z, 3) host SDF gradient, computed once per volume."""
        if "grad" not in self._cache:
            self._cache["grad"] = np.stack(
                np.gradient(np.asarray(self.tsdf, np.float32)), axis=-1
            )
        return self._cache["grad"]

    def save(self, path: str) -> None:
        """Persist the volume as compressed npz (tsdf/weight f16, color u8),
        the JAX package's format: re-mesh at another min_weight or raycast
        later without re-fusing. ~6x smaller than raw f32."""
        np.savez_compressed(
            path,
            tsdf=self.tsdf.astype(np.float16),
            weight=self.weight.astype(np.float16),
            color=np.clip(self.color * 255.0, 0, 255).astype(np.uint8),
            origin=np.asarray(self.origin, np.float64),
            voxel_size=np.float64(self.voxel_size),
            trunc_dist=np.float64(self.trunc_dist),
        )

    @classmethod
    def load(cls, path: str) -> "TSDFVolume":
        with np.load(path) as z:
            return cls(
                tsdf=z["tsdf"].astype(np.float32),
                weight=z["weight"].astype(np.float32),
                color=z["color"].astype(np.float32) / 255.0,
                origin=z["origin"],
                voxel_size=float(z["voxel_size"]),
                trunc_dist=float(z["trunc_dist"]),
            )

    @property
    def shape(self):
        return self._dims

    def extract_mesh(self, min_weight: float = 1.0):
        """Surface-nets mesh of the zero crossing (world coordinates)."""
        from .surface_nets import surface_nets

        return surface_nets(
            self.tsdf,
            level=0.0,
            origin=self.origin,
            voxel_size=self.voxel_size,
            observed=self.weight >= min_weight,
            colors=self.color,
        )

    def vertex_normals(self, vertices: np.ndarray) -> np.ndarray:
        """Outward unit normals at mesh vertices from the TSDF gradient."""
        from .surface_nets import sdf_vertex_normals

        return sdf_vertex_normals(
            self.tsdf, vertices, origin=self.origin,
            voxel_size=self.voxel_size, grad=self.sdf_gradient(),
        )


def auto_bounds(points: np.ndarray, margin: float) -> tuple[np.ndarray, np.ndarray]:
    """Robust world-space bounds from surface points: 1st/99th percentile
    box (per axis) padded by `margin` — outlier depths do not blow up the
    grid."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    if pts.shape[0] == 0:
        raise ValueError("no finite points to bound the TSDF volume")
    lo = np.percentile(pts, 1.0, axis=0) - margin
    hi = np.percentile(pts, 99.0, axis=0) + margin
    return lo, hi


def _grid_from_bounds(lo, hi, cfg: TSDFConfig):
    """(origin, dims, voxel_size): coarsen isotropically to fit max_voxels.

    The voxel counts are floats until they fit: the JAX function's int64
    counts wrap past 9.2e18 voxels (bounds of ~1e13 voxels an axis, from the
    wild depths of degenerate geometry) and leave the loop with a negative
    voxel count. Below 2**53 voxels the float counts are exact, so the grids
    are the JAX ones."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    extent = np.maximum(hi - lo, 1e-6)
    vs = float(cfg.voxel_size)
    dims = np.maximum(np.ceil(extent / vs) + 1, 2)
    while float(np.prod(dims)) > cfg.max_voxels:
        vs *= max((float(np.prod(dims)) / cfg.max_voxels) ** (1.0 / 3.0), 1.02)
        dims = np.maximum(np.ceil(extent / vs) + 1, 2)
    return lo, tuple(int(d) for d in dims), vs


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add: the product
    of two fp32 values is exact in fp64. XLA contracts these sums into FMAs
    on the host, so the pixel index, which rounds, sees the same inputs."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def voxel_centers(origin: torch.Tensor, voxel_size: torch.Tensor, dims, v_base: int = 0,
                  count: int | None = None) -> torch.Tensor:
    """(count, 3) world coordinates of the voxel centers of flat indices
    [v_base, v_base + count) (default: the whole grid), made on ``origin``'s
    device (flat index -> (x, y, z) by div / mod, z fastest). Indices past
    the grid (a shard's padding) give centers outside it."""
    X, Y, Z = dims
    count = X * Y * Z if count is None else count
    idx = torch.arange(v_base, v_base + count, device=origin.device)
    vx = (idx // (Y * Z)).to(torch.float32)
    vy = ((idx // Z) % Y).to(torch.float32)
    vz = (idx % Z).to(torch.float32)
    return _fma(torch.stack([vx, vy, vz], dim=-1), voxel_size, origin)


def _rotate_center(rot: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """``rot @ center`` (3,) summed as XLA's host product sums it: a chain of
    FMAs over the columns in order."""
    acc = rot[:, 0] * center[0]
    for k in (1, 2):
        acc = _fma(rot[:, k], center[k], acc)
    return acc


def _integrate(state, p_w, tab, intr, rot, center, trunc_dist, conf_threshold, depth_min,
               depth_max, height, width):
    """One frame into the flat (tsdf, weight, color) state: ``tab`` is the
    frame's packed (H*W, 5) [depth, conf, r, g, b] table, ``intr`` (4,) fx fy
    cx cy, ``rot`` (3, 3) world->cam, ``center`` (3,). Returns new tensors."""
    tsdf, weight, color = state
    # camera-frame voxel coords: one (V, 3) x (3, 3) product in fp32
    pc = torch.matmul(p_w, rot.T) - _rotate_center(rot, center)[None, :]
    z = pc[:, 2]
    zsafe = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    u = intr[0] * pc[:, 0] / zsafe + intr[2]
    v = intr[1] * pc[:, 1] / zsafe + intr[3]
    # clamped to one pixel past the image before the cast: rounding and the
    # in-bounds test are unchanged, and no float leaves the integer range
    ui = torch.round(torch.clamp(u, -1.0, float(width))).to(torch.int64)
    vi = torch.round(torch.clamp(v, -1.0, float(height))).to(torch.int64)
    inb = (z > depth_min) & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    lin = torch.clamp(vi, 0, height - 1) * width + torch.clamp(ui, 0, width - 1)

    g = tab.index_select(0, lin)  # one row gather
    d = g[:, 0]
    sdf = (d - z) / trunc_dist
    w_obs = torch.where(
        inb
        & (d > depth_min)
        & (d < depth_max)
        & (g[:, 1] >= conf_threshold)
        & (sdf > -1.0),
        g[:, 1],
        0.0,
    )
    sdf = torch.clamp(sdf, max=1.0)

    w_new = weight + w_obs
    denom = torch.clamp(w_new, min=1e-9)
    # never-observed voxels must keep the +1 free-space init (w_new=0
    # would otherwise zero them onto the isosurface)
    tsdf = torch.where(w_new > 0.0, (tsdf * weight + sdf * w_obs) / denom, tsdf)
    color = (color * weight[:, None] + g[:, 2:5] * w_obs[:, None]) / denom[:, None]
    return tsdf, w_new, color


def _fuse_frames(state, frames, origin, voxel_size, trunc_dist, conf_threshold, depth_min,
                 depth_max, dims, height, width, v_base: int = 0):
    """Integrate a batch of frames into the flat (tsdf, weight, color) state,
    frame after frame on the state's device (the JAX ``lax.scan`` body).

    frames: depth (F, H, W), conf (F, H, W), rgb (F, H, W, 3), intr (F, 4)
    fx fy cx cy, rot (F, 3, 3) world->cam, center (F, 3), device tensors;
    origin (3,) and voxel_size () fp32 device tensors, the other scalars
    floats (exact in fp32). The state covers the flat voxel indices
    [v_base, v_base + len)."""
    depth, conf, rgb, intr, rot, center = frames
    F = depth.shape[0]
    p_w = voxel_centers(origin, voxel_size, dims, v_base, state[0].shape[0])
    tab = torch.cat([depth[..., None], conf[..., None], rgb], dim=-1).reshape(
        F, height * width, 5)
    for f in range(F):
        state = _integrate(state, p_w, tab[f], intr[f], rot[f], center[f], trunc_dist,
                           conf_threshold, depth_min, depth_max, height, width)
    return state


def _f32(x) -> float:
    """A scalar as the fp32 value the JAX package passes (``jnp.float32``)."""
    return float(np.float32(x))


def fuse_tsdf(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    rotations: np.ndarray,
    centers: np.ndarray,
    colors: Optional[np.ndarray] = None,
    conf: Optional[np.ndarray] = None,
    config: TSDFConfig = TSDFConfig(),
    bounds: Optional[tuple] = None,
    volume: Optional[TSDFVolume] = None,
    mesh=None,
    mesh_axis: str = "dp",
    device="cuda",
) -> TSDFVolume:
    """Fuse (F, H, W) depth maps into a TSDF volume on ``device``.

    depth: z-depth in the camera frame (camera looks down +z, the Pi3
    convention); intrinsics (F, 4) fx fy cx cy; rotations (F, 3, 3)
    world->camera; centers (F, 3) camera centers (world).
    colors (F, H, W, 3) in [0, 1]; conf (F, H, W) in [0, 1] (weights the
    update and gates at config.conf_threshold; invalid pixels = 0).
    bounds: optional (lo, hi) world box; auto-computed from the
    back-projected depths otherwise. volume: continue integrating into an
    existing volume (incremental / multi-chunk use; its grid wins).
    mesh: a ``parallel.Mesh``: the flat voxel state is split over its
    ``mesh_axis`` (padded so the shards divide it), shard s on that axis's
    s-th device, the frames replicated on each; every shard gathers its own
    voxels (offset ``v_base``), with no collectives, and the state comes back
    on the first shard's device, equal to single-device fusion. ``device``
    then only switches TF32 off (``select_device``).
    """
    dev = resolve_device(device)
    depth = np.asarray(depth, np.float32)
    F, H, W = depth.shape
    intr = np.asarray(intrinsics, np.float32).reshape(F, 4)
    rot = np.asarray(rotations, np.float32).reshape(F, 3, 3)
    cen = np.asarray(centers, np.float32).reshape(F, 3)
    rgb = (
        np.zeros((F, H, W, 3), np.float32)
        if colors is None
        else np.asarray(colors, np.float32)
    )
    cf = np.ones((F, H, W), np.float32) if conf is None else np.asarray(conf, np.float32)
    cf = np.where(np.isfinite(depth) & (depth > 0), cf, 0.0)
    depth = np.nan_to_num(depth, nan=0.0, posinf=0.0, neginf=0.0)

    if volume is None:
        if bounds is None:
            bounds = auto_bounds(
                _backproject_sample(depth, cf, intr, rot, cen, config),
                margin=config.trunc_dist * 2,
            )
        origin, dims, vs = _grid_from_bounds(bounds[0], bounds[1], config)
        V = int(np.prod(dims))
        state = (
            torch.ones(V, dtype=torch.float32, device=dev),  # tsdf init: +1 (free/unseen ahead)
            torch.zeros(V, dtype=torch.float32, device=dev),
            torch.zeros((V, 3), dtype=torch.float32, device=dev),
        )
        trunc = config.trunc_dist if config.voxel_size == vs else max(
            config.trunc_dist, 4.0 * vs
        )
    else:
        origin = np.asarray(volume.origin, np.float64)
        dims = volume.shape
        vs = volume.voxel_size
        trunc = volume.trunc_dist
        state = volume.device_state(dev if mesh is None else mesh.device())

    def fuse(state, device, v_base=0):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        frames = (up(depth), up(cf), up(rgb), up(intr), up(rot), up(cen))
        return _fuse_frames(
            state, frames, up(np.asarray(origin, np.float32)),
            torch.tensor(_f32(vs), dtype=torch.float32, device=device), _f32(trunc),
            _f32(config.conf_threshold), _f32(config.depth_min), _f32(config.depth_max),
            tuple(dims), H, W, v_base,
        )

    if mesh is None:
        state = fuse(state, dev)
    else:
        state = _fuse_sharded(state, fuse, mesh, mesh_axis)
    return TSDFVolume._from_state(state, dims, np.asarray(origin, np.float64), float(vs),
                                  float(trunc))


def _fuse_sharded(state, fuse, mesh, axis: str):
    """The voxel-sharded fusion (the JAX ``_fuse_frames_sharded``): the flat
    state padded to a multiple of the axis size (tsdf with +1, the rest with
    0) and split, shard s fused on the axis's s-th device by ``fuse(state,
    device, v_base)``, shards on distinct devices from threads of their own;
    the shards are joined on the first device and the padding dropped."""
    from ..parallel import run_on_devices

    n = mesh.axis_size(axis)
    devices = [mesh.device(**{axis: s}) for s in range(n)]
    V = state[0].shape[0]
    vs = -(-V // n)
    pad = vs * n - V
    if pad:
        state = (torch.nn.functional.pad(state[0], (0, pad), value=1.0),
                 torch.nn.functional.pad(state[1], (0, pad)),
                 torch.nn.functional.pad(state[2], (0, 0, 0, pad)))

    def job(s):
        part = tuple(t[s * vs : (s + 1) * vs].to(devices[s]) for t in state)
        return fuse(part, devices[s], s * vs)

    parts = run_on_devices([(devices[s], lambda s=s: job(s)) for s in range(n)])
    lead = devices[0]
    return tuple(torch.cat([p[i].to(lead) for p in parts])[:V] for i in range(3))


def _backproject_sample(depth, conf, intr, rot, cen, cfg, max_per_frame=2048):
    """Strided unprojection of valid depths to world points (bounds probe)."""
    F, H, W = depth.shape
    stride = max(1, int(np.sqrt(H * W / max_per_frame)))
    vs, us = np.meshgrid(
        np.arange(0, H, stride), np.arange(0, W, stride), indexing="ij"
    )
    pts = []
    for f in range(F):
        d = depth[f, vs, us]
        ok = (
            (conf[f, vs, us] >= cfg.conf_threshold)
            & (d > cfg.depth_min)
            & (d < cfg.depth_max)
        )
        if not ok.any():
            continue
        fx, fy, cx, cy = intr[f]
        x = (us[ok] - cx) / fx * d[ok]
        y = (vs[ok] - cy) / fy * d[ok]
        pc = np.stack([x, y, d[ok]], axis=-1)
        pts.append(pc @ rot[f] + cen[f])  # R^T @ pc + c, row-vector form
    if not pts:
        raise ValueError("no valid depth samples to bound the TSDF volume")
    return np.concatenate(pts)
