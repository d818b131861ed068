"""Camera projection / unprojection / warping helpers.

Port of ``pi3_slam_tpu/geometry/projection.py`` (the reference's
``pi3/utils/geometry.py`` depthmap utilities): ``geotrf`` (batched transform
application), ``pixel_grid``, ``depthmap_to_camera_points``,
``depthmap_to_world_points``, ``project_points``, ``warp_keypoints``
(project 3D into another view) and the OpenCV-camera Pluecker-ray embedding.
Plain tensor functions, batched over leading dims, in the inputs' dtype and
on their device.
"""

from __future__ import annotations

import torch

from .transforms import homogenize_points


def _safe(z: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(z.abs() < eps, torch.full_like(z, eps), z)


def geotrf(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) or (..., 3, 3) transforms to (..., N, 3|2) points."""
    d = pts.shape[-1]
    if T.shape[-1] == d + 1:
        out = torch.einsum("...ij,...nj->...ni", T, homogenize_points(pts))
        if T.shape[-2] == d + 1:
            return out[..., :d] / _safe(out[..., d:], 1e-12)
        return out[..., :d]
    return torch.einsum("...ij,...nj->...ni", T, pts)


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 2) pixel-center (x, y) coordinates."""
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def depthmap_to_camera_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """(..., H, W) depth + (..., 3, 3) intrinsics -> (..., H, W, 3)
    camera-frame points (z = depth at each pixel)."""
    H, W = depth.shape[-2], depth.shape[-1]
    uv = pixel_grid(H, W, depth.dtype, depth.device)
    fx = K[..., 0, 0][..., None, None]
    fy = K[..., 1, 1][..., None, None]
    cx = K[..., 0, 2][..., None, None]
    cy = K[..., 1, 2][..., None, None]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def depthmap_to_world_points(depth: torch.Tensor, K: torch.Tensor,
                             cam2world: torch.Tensor) -> torch.Tensor:
    """Unproject and transform into the world frame. cam2world: (..., 4, 4)."""
    cam_pts = depthmap_to_camera_points(depth, K)
    R = cam2world[..., None, None, :3, :3]
    t = cam2world[..., None, None, :3, 3]
    return torch.einsum("...ij,...j->...i", R, cam_pts) + t


def project_points(points_world: torch.Tensor, K: torch.Tensor,
                   world2cam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N, 3) world points -> ((..., N, 2) pixels, (..., N) depth)."""
    R = world2cam[..., :3, :3]
    t = world2cam[..., :3, 3]
    cam = torch.einsum("...ij,...nj->...ni", R, points_world) + t[..., None, :]
    z = cam[..., 2]
    z_safe = _safe(z, 1e-12)
    u = K[..., 0, 0, None] * cam[..., 0] / z_safe + K[..., 0, 2, None]
    v = K[..., 1, 1, None] * cam[..., 1] / z_safe + K[..., 1, 2, None]
    return torch.stack([u, v], dim=-1), z


def warp_keypoints(kpts: torch.Tensor, depth_at_kpts: torch.Tensor, K_src: torch.Tensor,
                   K_dst: torch.Tensor, src2dst: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lift (N, 2) source keypoints with their depths, transform by the
    (4, 4) src -> dst transform and project into the destination camera.

    Returns ((N, 2) destination pixels, (N,) bool in-front mask)."""
    x = (kpts[..., 0] - K_src[..., 0, 2]) / K_src[..., 0, 0] * depth_at_kpts
    y = (kpts[..., 1] - K_src[..., 1, 2]) / K_src[..., 1, 1] * depth_at_kpts
    pts = torch.stack([x, y, depth_at_kpts], dim=-1)
    R = src2dst[..., :3, :3]
    t = src2dst[..., :3, 3]
    dst = pts @ R.transpose(-1, -2) + t
    z = dst[..., 2]
    z_safe = _safe(z, 1e-12)
    u = K_dst[..., 0, 0] * dst[..., 0] / z_safe + K_dst[..., 0, 2]
    v = K_dst[..., 1, 1] * dst[..., 1] / z_safe + K_dst[..., 1, 2]
    return torch.stack([u, v], dim=-1), z > 0


def camera_rays_plucker(K: torch.Tensor, cam2world: torch.Tensor, height: int,
                        width: int) -> torch.Tensor:
    """Pluecker-ray embedding of every pixel: (H, W, 6) = (direction,
    moment)."""
    uv = pixel_grid(height, width, K.dtype, K.device)
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    R = cam2world[:3, :3]
    origin = cam2world[:3, 3]
    d_world = d_cam @ R.T
    moment = torch.linalg.cross(origin.expand(d_world.shape), d_world, dim=-1)
    return torch.cat([d_world, moment], dim=-1)
