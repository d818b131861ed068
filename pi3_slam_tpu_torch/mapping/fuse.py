"""Fuse saved chunk files + their aligned reconstructions into one TSDF.

Port of ``pi3_slam_tpu/mapping/fuse.py``, the same host logic, with the
fusion on ``device`` (``mapping/tsdf.fuse_tsdf``): the volume's flat state
stays there from chunk to chunk.

Glue between the SLAM pipeline and mapping/tsdf.py: each chunk npz
(created with ``--save-dense`` or ``--keypoints none``) carries strided
dense per-pixel maps in the CHUNK frame; the aligned ChunkReconstruction
carries the final per-frame poses in the GLOBAL frame (Sim3 chaining +
BA + loop closure + telemetry, whatever ran). Depth lives in the chunk
metric, so each chunk's residual scale correction is recovered from the
ratio of consecutive-camera baselines (aligned vs stored) and applied to
the depth before integration.

No reference equivalent — the reference stops at point-cloud export
(pi3/utils/basic.py:377-459).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np

from ..sfm.reconstruction import _intrinsics_to_fxfycxcy
from .tsdf import TSDFConfig, TSDFVolume, _backproject_sample, auto_bounds, fuse_tsdf

ChunkSource = Union[dict, Callable[[], dict]]


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float32)))


def _load(chunk: ChunkSource) -> dict:
    """Chunks may be pre-loaded dicts or zero-arg loaders (lazy loading
    keeps peak memory at one chunk's dense maps)."""
    return chunk() if callable(chunk) else chunk


def _chunk_scale(recon, chunk_poses: np.ndarray) -> float:
    """Residual scale applied to this chunk during alignment: median ratio
    of consecutive-camera baselines, aligned centers vs stored ones."""
    ca = np.asarray(recon.centers, np.float64)
    cs = np.asarray(chunk_poses[:, :3, 3], np.float64)
    n = min(len(ca), len(cs))
    if n < 2:
        return 1.0
    da = np.linalg.norm(np.diff(ca[:n], axis=0), axis=1)
    ds = np.linalg.norm(np.diff(cs[:n], axis=0), axis=1)
    ok = ds > 1e-9
    if not ok.any():
        return 1.0
    return float(np.median(da[ok] / ds[ok]))


def _dense_frames(chunk: dict):
    """Extract (depth, conf, rgb, stride) from a dense-carrying chunk."""
    if "local_points_dense" not in chunk:
        raise ValueError(
            "chunk carries no dense maps — create chunks with --save-dense "
            "(or --keypoints none) to enable mesh export"
        )
    local = np.asarray(chunk["local_points_dense"], np.float32)
    depth = local[..., 2]
    conf = _sigmoid(chunk["conf_dense"])[..., 0] if "conf_dense" in chunk else None
    if conf is not None and "masks_dense" in chunk:
        conf = conf * np.asarray(chunk["masks_dense"], np.float32)
    rgb = (
        np.asarray(chunk["rgb_dense"], np.float32) / 255.0
        if "rgb_dense" in chunk
        else None
    )
    stride = float(chunk.get("dense_stride", 1))
    return depth, conf, rgb, stride


def _strided_intrinsics(chunk: dict, n_frames: int, stride: float) -> np.ndarray:
    """(N, 4) fx fy cx cy on the strided dense-pixel lattice (dense pixel i
    maps to original pixel i*stride, so all four parameters divide)."""
    if "intrinsics" in chunk:
        # [:n_frames] tolerates chunks whose intrinsics kept padded tail rows
        K = np.asarray(chunk["intrinsics"], np.float32).reshape(-1, 3, 3)[:n_frames]
        intr = _intrinsics_to_fxfycxcy(K)
    else:
        h = float(chunk["original_height"])
        w = float(chunk["original_width"])
        # same default prior as the reconstruction path (f = max(W, H), pp
        # at center — sfm/reconstruction.py::_default_intrinsics); a
        # different fallback here would project depth inconsistently with
        # the poses that were solved under that prior
        f = max(h, w)
        intr = np.tile(np.array([f, f, w / 2, h / 2], np.float32), (n_frames, 1))
    return intr / stride


def _prepare(chunk: dict, recon, index: int, overlap: int) -> dict:
    """Per-chunk fusion inputs in the ALIGNED global frame: scaled depth,
    strided intrinsics, aligned world->cam rotations and centers, with the
    frames shared with the previous chunk skipped (no double weighting)."""
    depth, conf, rgb, stride = _dense_frames(chunk)
    n = depth.shape[0]
    skip = overlap if index > 0 else 0
    skip = min(skip, max(n - 1, 0))
    scale = _chunk_scale(recon, np.asarray(chunk["camera_poses"], np.float64))
    intr = _strided_intrinsics(chunk, n, stride)
    rot = np.asarray(recon.rotations, np.float32)[:n]
    cen = np.asarray(recon.centers, np.float32)[:n]
    return dict(
        depth=depth[skip:] * scale,
        conf=None if conf is None else conf[skip:],
        rgb=None if rgb is None else rgb[skip:],
        intr=intr[skip:],
        rot=rot[skip:],
        cen=cen[skip:],
    )


def fuse_chunks(
    chunks: Sequence[ChunkSource],
    recons: Sequence,
    config: TSDFConfig = TSDFConfig(),
    overlap: int = 0,
    voxel_size: Optional[float] = None,
    device="cuda",
) -> TSDFVolume:
    """Integrate every chunk's dense maps into one global TSDF volume.

    chunks: loaded chunk dicts, or zero-arg callables returning them (lazy
    loading — each chunk's dense maps are materialized once, fused, and
    dropped); recons: the matching ALIGNED ChunkReconstructions (same
    order — their poses define the global frame).
    overlap: frames shared with the previous chunk; they are skipped for
    chunks after the first so overlap regions are not double-weighted.
    voxel_size: overrides config.voxel_size; None with
    config.voxel_size <= 0 auto-sizes to ~192 voxels across the largest
    scene dimension (subject to config.max_voxels).
    device: where the volume is fused.
    """
    if len(chunks) != len(recons):
        raise ValueError(f"{len(chunks)} chunks vs {len(recons)} reconstructions")

    # ---- global bounds from the aligned sparse tracks (cheap, no chunk
    # loads); when too few tracks survive, fall back to back-projecting
    # each chunk's strided depth under its ALIGNED pose + residual scale —
    # the volume lives in the aligned frame, so chunk-local world maps
    # (pre-loop-closure, pre-georeferencing gauge) must not bound it
    pts = [
        np.asarray(r.points)[np.asarray(r.track_valid) > 0]
        for r in recons
        if r.num_tracks
    ]
    track_pts = np.concatenate(pts) if pts else np.zeros((0, 3))
    if len(track_pts) >= 100:
        all_pts = track_pts
    else:
        probes = []
        for i, (chunk_src, recon) in enumerate(zip(chunks, recons)):
            p = _prepare(_load(chunk_src), recon, i, overlap)
            if p["depth"].shape[0] == 0:
                continue
            conf = (
                p["conf"]
                if p["conf"] is not None
                else np.ones_like(p["depth"], np.float32)
            )
            try:
                probes.append(
                    _backproject_sample(
                        p["depth"], conf, p["intr"], p["rot"], p["cen"], config,
                        max_per_frame=512,
                    )
                )
            except ValueError:
                continue  # this chunk has no confident depth; others may
        if not probes:
            raise ValueError("no points available to bound the TSDF volume")
        all_pts = np.concatenate(probes)

    vs = voxel_size if voxel_size is not None else config.voxel_size
    cfg = config
    if vs is None or vs <= 0:
        lo, hi = auto_bounds(all_pts, margin=0.0)
        vs = float(np.max(hi - lo) / 192.0)
    if vs != config.voxel_size:
        from dataclasses import replace

        cfg = replace(config, voxel_size=vs, trunc=config.trunc)
    bounds = auto_bounds(all_pts, margin=cfg.trunc_dist * 2)

    # ---- streaming fusion: one chunk's dense maps in memory at a time
    volume = None
    for i, (chunk_src, recon) in enumerate(zip(chunks, recons)):
        p = _prepare(_load(chunk_src), recon, i, overlap)
        if p["depth"].shape[0] == 0:
            continue
        volume = fuse_tsdf(
            p["depth"],
            p["intr"],
            p["rot"],
            p["cen"],
            colors=p["rgb"],
            conf=p["conf"],
            config=cfg,
            bounds=bounds,
            volume=volume,
            device=device,
        )
    if volume is None:
        raise ValueError("no frames to fuse")
    return volume


def export_fused_mesh(
    chunks: Sequence[ChunkSource],
    recons: Sequence,
    out_path: str,
    config: TSDFConfig = TSDFConfig(),
    overlap: int = 0,
    min_weight: float = 1.0,
    volume_path: Optional[str] = None,
    device="cuda",
) -> Optional[dict]:
    """Fuse + mesh + write: the shared tail of both modes' --export-mesh.

    Returns {'path', 'volume', 'vertices', 'faces', 'colors', 'timings'} on
    success, None when fusion is degenerate (no confident depth / no bounds) —
    the skip reason is printed, never raised. The volume is fused on
    ``device``; meshing runs on the host. timings: "fuse_s" (loading the
    chunks, fusing them and pulling the volume to the host), "mesh_s"
    (saving the volume, meshing and writing the mesh).
    """
    import time as _time

    from ..io.mesh import write_mesh_ply

    t0 = _time.time()
    try:
        volume = fuse_chunks(chunks, recons, config=config, overlap=overlap, device=device)
    except ValueError as e:
        # degenerate geometry (e.g. no confident depth) must not kill the
        # run — the point-cloud/trajectory exports already succeeded
        print(f"mesh export skipped: {e}")
        return None
    volume.tsdf  # the pull to the host ends the device's fusion
    t_fused = _time.time()
    if volume_path:
        volume.save(volume_path)
        print(f"Saved TSDF volume -> {volume_path}")
    verts, faces, vcols = volume.extract_mesh(min_weight=min_weight)
    write_mesh_ply(
        verts, faces, out_path, colors=vcols,
        normals=volume.vertex_normals(verts) if len(verts) else None,
    )
    print(
        f"Fused {len(chunks)} chunks into a {volume.shape} TSDF "
        f"(voxel {volume.voxel_size:.4f}) and meshed {len(verts)} verts / "
        f"{len(faces)} faces in {_time.time() - t0:.1f}s -> {out_path}"
    )
    return {
        "path": out_path, "volume": volume,
        "vertices": verts, "faces": faces, "colors": vcols,
        "timings": {"fuse_s": t_fused - t0, "mesh_s": _time.time() - t_fused},
    }
