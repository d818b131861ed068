"""SE3 / SO3 transform primitives of the chunk step and the SfM solvers.

Port of ``pi3_slam_tpu/geometry/transforms.py`` (``homogenize_points``,
``se3_inverse``, ``svd_orthogonalize``, ``transform_points``, ``skew``,
``so3_exp``, ``so3_log``, ``quaternion_to_rotation_matrix``,
``rotation_matrix_to_quaternion``); batched over leading dims. The TUM writer
keeps its own quaternion arithmetic (``io/tum.quaternions_wxyz``): the JAX
writer it matches byte for byte feeds float64 entries.
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


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) in (w, x, y, z) order -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) (w, x, y, z),
    w >= 0.

    Branchless Shepperd's method: all four candidates, the one keyed by the
    largest of (trace, R00, R11, R22) selected with the JAX function's tests
    (trace > 0, then R00, then R11), so q carries its sign at every rotation.
    The norm's sum of squares is a chain of fused multiply-adds in component
    order, each product and sum taken in float64 and rounded once (what XLA's
    CPU backend compiles ``jnp.linalg.norm`` to), and every square root is
    taken in float64 and rounded once (correctly rounded, which PyTorch's
    vectorised float32 ``sqrt`` on the CPU is not), so float32 inputs give the
    JAX function's bits.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    wide = torch.float64 if R.dtype == torch.float32 else R.dtype

    def sqrt(x):
        return torch.sqrt(x.to(wide)).to(x.dtype)

    def scale(x):  # 2 sqrt(max(x, 1e-24))
        return sqrt(x.clamp_min(1e-24)) * 2.0

    s0 = scale(tr + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = scale(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = scale(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = scale(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    sq = torch.zeros_like(q[..., 0])
    for k in range(4):
        sq = (q[..., k].to(wide) ** 2 + sq.to(wide)).to(q.dtype)
    q = q / sqrt(sq)[..., None]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
