"""SE3 / SO3 transform primitives used by the chunk step.

Port of ``pi3_slam_tpu/geometry/transforms.py`` (``homogenize_points``,
``se3_inverse``, ``svd_orthogonalize``); batched over leading dims.
"""

from __future__ import annotations

import torch


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last dim: (..., D) -> (..., D+1)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid transforms: [R t; 0 1]^-1 = [R^T -R^T t; 0 1]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def svd_orthogonalize(m: torch.Tensor) -> torch.Tensor:
    """Project 9D / 3x3 matrices onto SO(3): rows L2-normalised, then the
    closest rotation (det = +1) to the transposed matrix, with the sign fixed
    on V's last column. Invariant to the sign/order freedom of the SVD."""
    if m.shape[-1] == 9:
        m = m.reshape(m.shape[:-1] + (3, 3))
    m = m / torch.linalg.norm(m, dim=-1, keepdim=True).clamp_min(1e-12)
    u, _, vh = torch.linalg.svd(m.transpose(-1, -2), full_matrices=False)
    v = vh.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    v = torch.cat([v[..., :, :-1], v[..., :, -1:] * det[..., None, None]], dim=-1)
    return v @ ut
