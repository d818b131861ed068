"""SE3 / SO3 transform primitives of the chunk step and the SfM solvers.

Port of ``pi3_slam_tpu/geometry/transforms.py`` (``homogenize_points``,
``se3_inverse``, ``svd_orthogonalize``, ``transform_points``, ``skew``,
``so3_exp``, ``so3_log``); batched over leading dims. Its
``rotation_matrix_to_quaternion`` is ``io/tum.quaternions_wxyz``, the TUM
writer's only use of it.
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


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) points -> (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ R.transpose(-1, -2) + t[..., None, :]


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices of (..., 3) vectors -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
         torch.stack([-y, x, zero], -1)],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: (..., 3) axis-angle -> (..., 3, 3), with the
    Taylor branch below theta^2 = 1e-12."""
    theta2 = (w * w).sum(-1)
    theta = theta2.clamp_min(1e-24).sqrt()
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp_min(1e-24))
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map: (..., 3, 3) rotation -> (..., 3) axis-angle, for theta in
    [0, pi), with the Taylor branch below theta = 1e-6."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta < 1e-6, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.sin(theta)).clamp_min(1e-24))
    return v * scale[..., None]
