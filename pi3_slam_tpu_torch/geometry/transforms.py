"""SE3 / SO3 transform primitives of the chunk step and the SfM solvers.

Port of ``pi3_slam_tpu/geometry/transforms.py`` (``homogenize_points``,
``se3_inverse``, ``svd_orthogonalize``, ``transform_points``, ``skew``,
``so3_exp``, ``so3_log``, ``rotation_matrix_to_quaternion``); batched over
leading dims.
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


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> unit quaternions (..., 4) (w, x, y, z), w >= 0:
    Shepperd's method, the candidate keyed by the largest of (trace, R00,
    R11, R22)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return x.clamp_min(1e-24).sqrt()

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    q = torch.where((tr > 0.0)[..., None], q0,
                    torch.where(((m00 >= m11) & (m00 >= m22))[..., None], q1,
                                torch.where((m11 >= m22)[..., None], q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
