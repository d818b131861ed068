"""Focal-length / z-shift recovery from pointmaps, and intrinsics estimation.

Port of ``pi3_slam_tpu/geometry/focal.py``: a fixed 30-iteration damped
Gauss-Newton solve over the scalar shift, batched over frames. Given a
pointmap P = (x, y, z) and the normalised view-plane uv, it minimises
|f * xy / (z + shift) - uv|^2 with f in closed form for each shift.

The solve itself is ``ops/focal_shift.solve_shift``: on the GPU one launch
of the hand-written kernel of ``csrc/focal_shift.cu``, on the CPU the eager
closed-form solve (``solve_shift_plain``). Runs in true fp32 (TF32 is off,
see ``device.py``).
"""

from __future__ import annotations

import torch

from ..ops.focal_shift import solve_shift
from .maps import nearest_resize, normalized_view_plane_uv


def recover_focal_shift(
    points: torch.Tensor,
    mask: torch.Tensor | None = None,
    downsample_size: tuple[int, int] = (64, 64),
    iterations: int = 30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(focal, shift) per frame from (..., H, W, 3) pointmaps; focal is
    relative to the half image diagonal."""
    shape = points.shape
    H, W = shape[-3], shape[-2]
    lead = shape[:-3]
    points_flat = points.reshape((-1,) + tuple(shape[-3:]))
    uv = normalized_view_plane_uv(W, H, dtype=points.dtype, device=points.device)
    points_lr = nearest_resize(points_flat, downsample_size)
    uv_lr = nearest_resize(uv, downsample_size).reshape(-1, 2)
    if mask is None:
        weight = torch.ones(points_lr.shape[:-1], dtype=points.dtype, device=points.device)
    else:
        mask_flat = mask.reshape((-1,) + tuple(shape[-3:-1])).to(points.dtype)
        weight = nearest_resize(mask_flat[..., None], downsample_size)[..., 0]
    points_lr = points_lr.reshape(points_lr.shape[0], -1, 3)
    weight = weight.reshape(weight.shape[0], -1)
    focal, shift = solve_shift(points_lr, uv_lr, weight, iterations)
    return focal.reshape(lead), shift.reshape(lead)


def intrinsics_from_focal_center(fx, fy, cx, cy) -> torch.Tensor:
    """(..., 3, 3) pinhole intrinsics from focal lengths and centre."""
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([fx, zeros, cx], dim=-1)
    row1 = torch.stack([zeros, fy, cy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def estimate_camera_parameters(
    local_points: torch.Tensor,
    conf: torch.Tensor,
    downsample_size: tuple[int, int] = (64, 64),
) -> dict:
    """Per-frame pinhole intrinsics from Pi3 local points (..., H, W, 3) and
    raw confidence logits (..., H, W, 1): mask = sigmoid(conf) > 0.1, recover
    (focal, shift), then fx = focal/2 * sqrt(1+ar^2)/ar * W,
    fy = focal/2 * sqrt(1+ar^2) * H, cx = W // 2, cy = H // 2."""
    masks = torch.sigmoid(conf[..., 0]) > 0.1
    H, W = local_points.shape[-3], local_points.shape[-2]
    ar = W / H
    focal, shift = recover_focal_shift(local_points, masks, downsample_size=downsample_size)
    fx = focal / 2 * (1 + ar**2) ** 0.5 / ar * W
    fy = focal / 2 * (1 + ar**2) ** 0.5 * H
    cx = torch.full_like(fx, W // 2)
    cy = torch.full_like(fy, H // 2)
    return {
        "intrinsics": intrinsics_from_focal_center(fx, fy, cx, cy),
        "focal": focal,
        "shift": shift,
        "fx": fx,
        "fy": fy,
        "cx": cx,
        "cy": cy,
    }
