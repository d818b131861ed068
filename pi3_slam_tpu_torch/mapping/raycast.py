"""TSDF raycasting: render depth / normal maps from a fused volume.

Port of ``pi3_slam_tpu/mapping/raycast.py``: KinectFusion-style sphere
tracing. All H*W rays advance in lockstep through a fixed number of steps (no
data-dependent control flow), each step trilinearly interpolating the
truncated SDF (8 flat gathers) and advancing by the truncation-scaled SDF
value clamped to at least one voxel. The zero crossing is refined by linear
interpolation between the last positive and first negative sample.

The JAX package computes this in XLA under a 192-step ``lax.scan`` (no
Pallas kernel); here the steps are a loop of PyTorch ops on the device that
holds the volume's flat tsdf (``TSDFVolume.device_tsdf_flat``, uploaded once
per volume). Normals come from the SDF gradient on the host, as in JAX.

Uses: debug renders of the final fused model (``--render-previews``,
``tools/render_tsdf.py``) and synthetic depth for tests. The reference has no
dense-mapping subsystem.
"""

from __future__ import annotations

import numpy as np
import torch

from .tsdf import resolve_device


# the 8 cell corners (dx, dy, dz) in the JAX loop's order
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _grid_limits(dims, device):
    """The last grid coordinate (fp32) and the last trilinear base (int64) of
    each axis, and the (3, 8) corner offsets: made once per raycast, since a
    tensor built from host values is a copy that waits for the device."""
    X, Y, Z = dims
    return (torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32, device=device),
            torch.tensor([X - 2, Y - 2, Z - 2], dtype=torch.int64, device=device),
            torch.tensor(_CORNERS, dtype=torch.int64, device=device).T)


def _trilinear(tsdf_flat, dims, g, limits):
    """Trilinear TSDF sample at grid coords g (N, 3); out-of-grid clamps.
    ``limits``: ``_grid_limits(dims, g.device)``. The 8 corners are weighted
    and gathered at once, then summed one after another in the JAX order.

    Returns (value (N,), inside (N,) bool)."""
    X, Y, Z = dims
    lim, top, (cx, cy, cz) = limits
    inside = ((g >= 0.0) & (g <= lim)).all(dim=1)
    gc = torch.minimum(torch.clamp(g, min=0.0), lim - 1e-4)
    base = torch.minimum(torch.floor(gc).to(torch.int64), top)
    t = gc - base
    side = torch.stack([1 - t, t])  # (2, N, 3): the weight of the lower / upper corner
    w = side[cx, :, 0] * side[cy, :, 1] * side[cz, :, 2]  # (8, N)
    lin = ((base[:, 0] + cx[:, None]) * Y + base[:, 1] + cy[:, None]) * Z + base[:, 2] + cz[:, None]
    vals = tsdf_flat[lin]
    val = torch.zeros(g.shape[0], dtype=torch.float32, device=g.device)
    for k in range(8):
        val = val + w[k] * vals[k]
    return val, inside


def _farthest_corner(origin, voxel_size, dims, center):
    """The distance from ``center`` to the grid's farthest corner (fp32
    device tensor)."""
    ext = torch.tensor([d - 1 for d in dims], dtype=torch.float32, device=origin.device)
    lo, hi = origin - center, origin + ext * voxel_size - center
    return torch.linalg.vector_norm(torch.maximum(lo.abs(), hi.abs()))


def _raycast(tsdf_flat, origin, voxel_size, trunc_dist, intr, rot, center, dims, height, width,
             max_steps):
    """depth (H, W) in camera z (0 = miss), hit mask, hit points (H, W, 3);
    every argument but the sizes a fp32 tensor on the volume's device."""
    dev = tsdf_flat.device
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    u = torch.arange(width, dtype=torch.float32, device=dev).expand(height, width).reshape(-1)
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(
        height, width).reshape(-1)
    # world-space unit ray directions; rays leave the camera center
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=1)
    # R^T rows applied to each d_cam (R is world->cam), in fp32
    d_world = torch.matmul(d_cam, rot)
    inv_norm = 1.0 / torch.linalg.vector_norm(d_world, dim=1, keepdim=True)
    d_world = d_world * inv_norm
    # z-depth per unit ray distance (depth = t * dz_cam)
    dz = d_cam[:, 2] * inv_norm[:, 0]

    inv_vs = 1.0 / voxel_size
    t = voxel_size.expand(u.shape).clone()
    limits = _grid_limits(dims, dev)

    def sample(t):
        p = center[None, :] + d_world * t[:, None]
        g = (p - origin[None, :]) * inv_vs
        return _trilinear(tsdf_flat, dims, g, limits)

    t_hit = torch.zeros_like(t)
    prev_sdf = torch.ones_like(t)  # free space
    prev_t = t
    done = torch.zeros(t.shape, dtype=torch.bool, device=dev)
    # past the grid's farthest corner a ray never samples the grid again, so
    # its outputs are final; once every ray is done or there, the remaining
    # steps would change nothing (checked every 8 steps: one host read each)
    t_far = _farthest_corner(origin, voxel_size, dims, center) + voxel_size
    for step in range(max_steps):
        if step % 8 == 0 and step and bool((done | (t > t_far)).all()):
            break
        sdf, inside = sample(t)
        crossed = inside & (prev_sdf > 0.0) & (sdf <= 0.0) & ~done
        # linear zero-crossing refinement between (prev_t, t)
        diff = prev_sdf - sdf
        denom = torch.where(torch.abs(diff) > 1e-12, diff, 1.0)
        t_cross = prev_t + (t - prev_t) * prev_sdf / denom
        t_hit = torch.where(crossed, t_cross, t_hit)
        done = done | crossed
        # advance: sphere-trace by the truncation-scaled SDF, at least one
        # voxel; outside the grid stride 4 voxels toward it
        adv = torch.where(inside, torch.maximum(sdf * trunc_dist, voxel_size), 4.0 * voxel_size)
        new_t = torch.where(done, t, t + adv)
        prev_sdf = torch.where(inside, sdf, prev_sdf)
        prev_t = t
        t = new_t

    depth = torch.where(done, t_hit * dz, 0.0).reshape(height, width)
    points = (center[None, :] + d_world * t_hit[:, None]).reshape(height, width, 3)
    return depth, done.reshape(height, width), points


def raycast_depth(
    volume,
    intrinsics,
    rotation: np.ndarray,
    center: np.ndarray,
    height: int,
    width: int,
    max_steps: int = 192,
    device="cuda",
):
    """Render a virtual depth map of a TSDFVolume from a pinhole camera, the
    rays traced on ``device``.

    intrinsics: (4,) fx fy cx cy; rotation: (3, 3) world->camera;
    center: (3,) camera center (world). Returns a dict with
    depth (H, W) float32 z-depth (0 where the ray missed), mask (H, W)
    bool, points (H, W, 3) world hit points, and normals (H, W, 3)
    (SDF-gradient, zero where missed).
    """
    dev = resolve_device(device)

    def up(a, *shape):
        return torch.from_numpy(np.asarray(a, np.float32).reshape(shape)).to(dev)

    depth, mask, points = _raycast(
        volume.device_tsdf_flat(dev),  # uploaded once, cached across views
        up(volume.origin, 3),
        torch.tensor(np.float32(volume.voxel_size), device=dev),
        torch.tensor(np.float32(volume.trunc_dist), device=dev),
        up(intrinsics, 4),
        up(rotation, 3, 3),
        up(center, 3),
        tuple(volume.shape),
        height,
        width,
        max_steps,
    )
    depth = depth.cpu().numpy()
    mask = mask.cpu().numpy()
    pts = points.cpu().numpy()
    from .surface_nets import sdf_vertex_normals

    normals = sdf_vertex_normals(
        volume.tsdf, pts.reshape(-1, 3), origin=volume.origin,
        voxel_size=volume.voxel_size, grad=volume.sdf_gradient(),
    ).reshape(height, width, 3)
    normals = np.where(mask[..., None], normals, 0.0)
    return {"depth": depth, "mask": mask, "points": pts, "normals": normals}
