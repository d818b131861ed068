"""Sim3 similarity transforms and Umeyama point-set alignment.

Port of ``pi3_slam_tpu/geometry/sim3.py``: the closed-form weighted Umeyama
fit, its Huber-IRLS refinement with a final trimmed re-solve, and the
pose-based Sim3 of the alignment fallback. Everything runs in the inputs'
dtype and on their device (the solvers are called with fp32 tensors, TF32
off: ``device.select_device``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .transforms import skew, so3_exp, so3_log


class Sim3(NamedTuple):
    """Similarity transform x -> scale * R @ x + t."""

    scale: torch.Tensor  # ()
    rotation: torch.Tensor  # (3, 3)
    translation: torch.Tensor  # (3,)


def sim3_matrix(s: Sim3) -> torch.Tensor:
    """4x4 matrix [sR t; 0 1] (batched over leading dims)."""
    top = torch.cat([s.scale[..., None, None] * s.rotation, s.translation[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def sim3_apply(s: Sim3, points: torch.Tensor) -> torch.Tensor:
    """Apply to (..., 3) points."""
    return s.scale * (points @ s.rotation.transpose(-1, -2)) + s.translation


def sim3_inverse(s: Sim3) -> Sim3:
    """Inverse; batched over leading dims."""
    rt = s.rotation.transpose(-1, -2)
    inv_scale = 1.0 / s.scale
    return Sim3(inv_scale, rt, -inv_scale[..., None] * torch.einsum("...ij,...j->...i", rt,
                                                                    s.translation))


def sim3_compose(a: Sim3, b: Sim3) -> Sim3:
    """(a o b)(x) = a(b(x)); batched over leading dims."""
    return Sim3(a.scale * b.scale, a.rotation @ b.rotation,
                a.scale[..., None] * torch.einsum("...ij,...j->...i", a.rotation, b.translation)
                + a.translation)


def sim3_identity(dtype=torch.float32) -> Sim3:
    return Sim3(torch.ones((), dtype=dtype), torch.eye(3, dtype=dtype), torch.zeros(3, dtype=dtype))


def _sim3_w_coeffs(theta2: torch.Tensor, sigma: torch.Tensor):
    """(A, B, C) of W = C I + A K + B K^2 (K = skew(phi), t = W rho), from
    W = int_0^1 e^(sigma u) exp(u K) du, with the Taylor branches at theta = 0
    and sigma = 0."""
    theta = theta2.clamp_min(1e-24).sqrt()
    small_t = theta2 < 1e-12
    sigma2 = sigma * sigma
    small_s = sigma2 < 1e-12
    s = torch.exp(sigma)
    one = torch.ones_like(sigma)
    sigma_safe = torch.where(small_s, one, sigma)
    sigma2_safe = torch.where(small_s, one, sigma2)
    theta_safe = torch.where(small_t, torch.ones_like(theta), theta)
    theta2_safe = torch.where(small_t, torch.ones_like(theta2), theta2)
    c_safe = theta2_safe + sigma2
    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    C = torch.where(small_s, 1.0 + sigma / 2.0 + sigma2 / 6.0, (s - 1.0) / sigma_safe)
    A_gen = (a_ * sigma + (1.0 - b_) * theta) / (theta_safe * c_safe)
    A_small = torch.where(small_s, 0.5 + sigma / 3.0 + sigma2 / 8.0,
                          (s * (sigma - 1.0) + 1.0) / sigma2_safe)
    A = torch.where(small_t, A_small, A_gen)
    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / c_safe) / theta2_safe
    B_small = torch.where(small_s, 1.0 / 6.0 + sigma / 8.0 + sigma2 / 20.0,
                          (s * (sigma2 - 2.0 * sigma + 2.0) - 2.0) / (2.0 * sigma2_safe * sigma_safe))
    B = torch.where(small_t, B_small, B_gen)
    return A, B, C


def _w_matrix(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    A, B, C = _sim3_w_coeffs((phi * phi).sum(-1), sigma)
    K = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """Exponential map: tangent (..., 7) [rho(3), phi(3), sigma] -> Sim3."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    W = _w_matrix(phi, sigma)
    return Sim3(torch.exp(sigma), so3_exp(phi), torch.einsum("...ij,...j->...i", W, rho))


def sim3_log(s: Sim3) -> torch.Tensor:
    """Log map: Sim3 -> tangent (..., 7) [rho, phi, sigma]; the inverse of
    :func:`sim3_exp` for rotation angles below pi."""
    sigma = torch.log(s.scale)
    phi = so3_log(s.rotation)
    rho = torch.linalg.solve(_w_matrix(phi, sigma), s.translation[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def _proper_rotation(u: torch.Tensor, vt: torch.Tensor) -> torch.Tensor:
    """U diag(1, 1, det(U) det(V^T)) V^T: the closest rotation (det +1)."""
    det = torch.linalg.det(u) * torch.linalg.det(vt)
    sgn = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
    return torch.cat([u[:, :-1], u[:, -1:] * sgn], dim=1) @ vt


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None,
            with_scale: bool = True) -> Sim3:
    """Weighted Umeyama: the Sim3 minimising sum w |s R src + t - dst|^2.
    src, dst (N, 3); weights (N,) >= 0 (zeros are ignored points)."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    w = weights / weights.sum().clamp_min(1e-12)
    mu_src = (w[:, None] * src).sum(0)
    mu_dst = (w[:, None] * dst).sum(0)
    src_c = src - mu_src
    dst_c = dst - mu_dst
    cov = (w[:, None] * dst_c).T @ src_c
    var_src = (w * (src_c * src_c).sum(-1)).sum()
    u, _, vt = torch.linalg.svd(cov)
    R = _proper_rotation(u, vt)
    if with_scale:
        # trace(R cov^T) as a direct data correlation: tighter in fp32 than
        # the sum of singular values
        scale = (w * (dst_c * (src_c @ R.T)).sum(-1)).sum() / var_src.clamp_min(1e-12)
    else:
        scale = torch.ones((), dtype=src.dtype, device=src.device)
    return Sim3(scale, R, mu_dst - scale * R @ mu_src)


def sim3_from_camera_poses(ref_rot_cw: torch.Tensor, ref_centers: torch.Tensor,
                           q_rot_cw: torch.Tensor, q_centers: torch.Tensor,
                           rot_weight: torch.Tensor | None = None) -> Sim3:
    """Sim3 aligning query camera poses onto the reference poses of the same
    frames: minimises sum |s R c_q + t - c_ref|^2 - lambda tr((R R_wc,q)^T
    R_wc,ref). The chordal rotation term fixes the rotation about the motion
    axis that collinear centers leave free; lambda defaults to the mean
    squared center spread. The alignment fallback when no common track
    survives."""
    mu_q, mu_r = q_centers.mean(0), ref_centers.mean(0)
    qc, rc = q_centers - mu_q, ref_centers - mu_r
    n = qc.shape[0]
    var_q = (qc * qc).sum() / n
    if rot_weight is None:
        rot_weight = var_q.clamp_min(1e-8)
    cov_rot = torch.einsum("nij,nkj->ik", ref_rot_cw.transpose(-1, -2), q_rot_cw.transpose(-1, -2))
    cov = rc.T @ qc / n + rot_weight * cov_rot / q_rot_cw.shape[0]
    u, _, vt = torch.linalg.svd(cov)
    R = _proper_rotation(u, vt)
    num = (rc * (qc @ R.T)).sum() / n
    one = torch.ones((), dtype=qc.dtype, device=qc.device)
    scale = torch.where(var_q > 1e-10, num / var_q.clamp_min(1e-10), one)
    scale = torch.where(scale > 1e-6, scale, one)
    return Sim3(scale, R, mu_r - scale * R @ mu_q)


def robust_umeyama(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None,
                   huber_delta: float = 1.0, iterations: int = 5, with_scale: bool = True,
                   trim_multiplier: float | None = 3.0) -> Sim3:
    """Huber-IRLS Umeyama (PyTheia OptimizeAlignmentSim3's 5 iterations,
    Huber width 1.0): each iteration reweights points by the Huber weight of
    their residual and re-solves; a final trimmed re-solve drops points with
    residual > trim_multiplier * huber_delta."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    w_robust = torch.ones_like(weights)

    def residuals(w):
        s = umeyama(src, dst, weights * w, with_scale=with_scale)
        return torch.linalg.norm(sim3_apply(s, src) - dst, dim=-1)

    for _ in range(iterations):
        r = residuals(w_robust)
        w_robust = torch.where(r <= huber_delta, torch.ones_like(r), huber_delta / r.clamp_min(1e-12))
    if trim_multiplier is not None:
        r = residuals(w_robust)
        w_robust = torch.where(r <= trim_multiplier * huber_delta, w_robust, torch.zeros_like(r))
    return umeyama(src, dst, weights * w_robust, with_scale=with_scale)
