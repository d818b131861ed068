"""Batched bundle adjustment: Huber-robust, Levenberg-Marquardt-damped
Gauss-Newton with a dense Schur complement on the camera poses.

Port of ``pi3_slam_tpu/sfm/ba.py``. Cameras follow the PyTheia convention:
R_cw (world -> camera) and the camera center c, so x_cam = R_cw (X - c).
Pose updates are left-multiplied axis-angle increments R' = exp(w) R_cw,
c' = c + dc; points update additively (or along their anchor ray, in inverse
depth). The point blocks (3x3, or 1x1 in inverse depth) are eliminated and
the (6N x 6N) camera Schur complement is solved densely.

Everything runs in fp32 on the problem's device, with TF32 off (set by
:func:`~..device.select_device`, which the entry points call), the precision
``utils/precision.py`` of the JAX package states for the solvers. Observations are padded track-major
(T, M) arrays; invalid slots carry weight 0.

Against the JAX version:

* ``jax.ops.segment_sum`` is a sum in a fixed order, with no atomics: the
  segment index (which depends on ``obs_frame`` alone) is sorted once per
  :func:`bundle_adjust` with a stable argsort, and each segment is reduced
  by ``torch.segment_reduce``. So two runs on the card give the same bits,
  as two runs on the CPU do. The owner-grouped accumulation (tracks laid out
  (owner frame, keypoint), identical ``obs_frame`` rows in a group) sums each
  group first, as the JAX version does: exact algebra that also cuts the
  per-frame sums to N * M items.
* The ungrouped Schur accumulation's ``lax.scan`` over slots is a Python loop.
* The solves are ``torch.linalg.solve_ex`` / ``inv_ex`` without error checks:
  a singular system gives non-finite values, which ``nan_to_num`` turns into
  finite ones, as after ``jnp.linalg.solve``; tracks without a valid
  observation get an identity point block and no update.
* The ``ftol`` early stop is a Python loop with one host read per iteration;
  with ``ftol == 0`` the loop reads nothing back.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.transforms import skew, so3_exp, so3_log


class BAProblem(NamedTuple):
    """Fixed-shape bundle-adjustment problem: N frames, T tracks, M
    observation slots per track; every tensor fp32 except ``obs_frame``
    (int64), all on one device."""

    rotations: torch.Tensor  # (N, 3, 3) R_cw world -> camera
    centers: torch.Tensor  # (N, 3) camera centers (world frame)
    points: torch.Tensor  # (T, 3) world points
    intrinsics: torch.Tensor  # (N, 4): fx, fy, cx, cy
    obs_frame: torch.Tensor  # (T, M) frame index per observation
    obs_uv: torch.Tensor  # (T, M, 2) observed pixel coords
    obs_valid: torch.Tensor  # (T, M) 1/0
    track_valid: torch.Tensor  # (T,) 1/0
    # pose priors (zero weights = no prior)
    prior_rotations: torch.Tensor  # (N, 3, 3)
    prior_centers: torch.Tensor  # (N, 3)
    prior_rot_weight: torch.Tensor  # (N,) 1/sigma^2
    prior_pos_weight: torch.Tensor  # (N,) 1/sigma^2
    # gravity alignment (zero weights = off): measured unit gravity direction
    # in each camera frame, pulled toward R_cw @ gravity_world
    gravity_dirs: torch.Tensor  # (N, 3)
    gravity_weight: torch.Tensor  # (N,)
    gravity_world: torch.Tensor  # (3,)


def make_problem(
    rotations, centers, points, intrinsics, obs_frame, obs_uv, obs_valid, track_valid=None,
    prior_rotations=None, prior_centers=None, prior_rot_weight=None, prior_pos_weight=None,
    gravity_dirs=None, gravity_weight=None, gravity_world=None, device=None,
) -> BAProblem:
    """Build a problem from numpy arrays or tensors (missing priors and
    gravity are off) on ``device`` (default: the CPU)."""
    dev = torch.device("cpu") if device is None else torch.device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32).to(dev)

    n, t = len(rotations), len(points)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return BAProblem(
        rotations=f32(rotations),
        centers=f32(centers),
        points=f32(points),
        intrinsics=f32(intrinsics),
        obs_frame=torch.as_tensor(np.asarray(obs_frame) if not torch.is_tensor(obs_frame)
                                  else obs_frame, dtype=torch.int64).to(dev),
        obs_uv=f32(obs_uv),
        obs_valid=f32(obs_valid),
        track_valid=torch.ones(t, device=dev) if track_valid is None else f32(track_valid),
        prior_rotations=(torch.eye(3, device=dev).expand(n, 3, 3).clone()
                         if prior_rotations is None else f32(prior_rotations)),
        prior_centers=zeros(n, 3) if prior_centers is None else f32(prior_centers),
        prior_rot_weight=zeros(n) if prior_rot_weight is None else f32(prior_rot_weight),
        prior_pos_weight=zeros(n) if prior_pos_weight is None else f32(prior_pos_weight),
        gravity_dirs=zeros(n, 3) if gravity_dirs is None else f32(gravity_dirs),
        gravity_weight=zeros(n) if gravity_weight is None else f32(gravity_weight),
        gravity_world=(torch.tensor([0.0, 0.0, -1.0], device=dev) if gravity_world is None
                       else f32(gravity_world)),
    )


def _project(rot, center, intr, X):
    """x_cam = R (X - c); uv = K pi(x_cam), per observation."""
    x_cam = torch.einsum("...ij,...j->...i", rot, X - center)
    z = x_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = intr[..., 0] * x_cam[..., 0] / z_safe + intr[..., 2]
    v = intr[..., 1] * x_cam[..., 1] / z_safe + intr[..., 3]
    return torch.stack([u, v], dim=-1), x_cam


def _gather(p: BAProblem):
    return p.rotations[p.obs_frame], p.centers[p.obs_frame], p.intrinsics[p.obs_frame]


def reprojection_errors(p: BAProblem) -> torch.Tensor:
    """(T, M) pixel reprojection error norms (inf where invalid or behind
    the camera)."""
    rot, cen, intr = _gather(p)
    uv_hat, x_cam = _project(rot, cen, intr, p.points[:, None, :])
    err = torch.linalg.norm(uv_hat - p.obs_uv, dim=-1)
    valid = (p.obs_valid > 0) & (p.track_valid[:, None] > 0) & (x_cam[..., 2] > 0)
    return torch.where(valid, err, torch.full_like(err, float("inf")))


def _robust_weights(r_norm, delta):
    """Huber IRLS weight: 1 inside delta, delta/|r| outside."""
    return torch.where(r_norm <= delta, torch.ones_like(r_norm), delta / r_norm.clamp_min(1e-12))


def _huber_cost(r_norm, delta):
    return torch.where(r_norm <= delta, 0.5 * r_norm**2, delta * (r_norm - 0.5 * delta))


def _prior_residuals(p: BAProblem):
    dr = so3_log(torch.einsum("nij,nkj->nik", p.rotations, p.prior_rotations))  # log(R R_p^T)
    return dr, p.centers - p.prior_centers


def _cost(p: BAProblem, huber_delta: float) -> torch.Tensor:
    """Huber reprojection cost plus the prior and gravity terms (a 0-dim
    tensor)."""
    rot, cen, intr = _gather(p)
    uv_hat, x_cam = _project(rot, cen, intr, p.points[:, None, :])
    r_norm = torch.linalg.norm(uv_hat - p.obs_uv, dim=-1)
    w_valid = p.obs_valid * p.track_valid[:, None] * (x_cam[..., 2] > 1e-6)
    cost = (w_valid * _huber_cost(r_norm, huber_delta)).sum()
    dr, dc = _prior_residuals(p)
    cost = cost + 0.5 * (p.prior_rot_weight * (dr * dr).sum(-1)).sum()
    cost = cost + 0.5 * (p.prior_pos_weight * (dc * dc).sum(-1)).sum()
    rg = p.rotations @ p.gravity_world - p.gravity_dirs
    return cost + 0.5 * (p.gravity_weight * (rg * rg).sum(-1)).sum()


def _anchor_rays(p: BAProblem):
    """Per-track anchor ray from the owner-frame observation (slot 0):
    (u_dir (T, 3) world unit bearing, rho (T,) inverse depth along it, c_a
    (T, 3) anchor centers)."""
    anchor = p.obs_frame[:, 0]
    c_a = p.centers[anchor]
    R_a = p.rotations[anchor]
    intr_a = p.intrinsics[anchor]
    uv0 = p.obs_uv[:, 0]
    bx = (uv0[:, 0] - intr_a[:, 2]) / intr_a[:, 0]
    by = (uv0[:, 1] - intr_a[:, 3]) / intr_a[:, 1]
    bearing = torch.stack([bx, by, torch.ones_like(bx)], dim=-1)
    bearing = bearing / torch.linalg.norm(bearing, dim=-1, keepdim=True)
    u_dir = torch.einsum("tji,tj->ti", R_a, bearing)  # R_cw^T b
    d = ((p.points - c_a) * u_dir).sum(-1).clamp_min(1e-9)
    return u_dir, 1.0 / d, c_a


def snap_points_to_anchor_rays(p: BAProblem) -> BAProblem:
    """Re-seat every track point on the ray through its detected keypoint at
    its current depth along that ray (PyTheia's InitializeInverseDepth)."""
    u_dir, rho, c_a = _anchor_rays(p)
    return p._replace(points=c_a + u_dir / rho[:, None])


class _Segments(NamedTuple):
    """How to sum rows into n segments in a fixed order: the stable argsort of
    the rows' segment index and each segment's row count."""

    order: torch.Tensor  # (R,) int64
    lengths: torch.Tensor  # (n,) int64


def _segments(index: torch.Tensor, n: int) -> _Segments:
    index = index.reshape(-1)
    # integer counts: exact in any order
    lengths = torch.zeros(n, dtype=torch.int64, device=index.device).index_add_(
        0, index, torch.ones_like(index))
    return _Segments(torch.argsort(index, stable=True), lengths)


def _segment_sum(values: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """(R, ...) rows summed into (n, ...) by segment, each segment in row
    order (empty segments give 0); deterministic on every device."""
    return torch.segment_reduce(values[seg.order], "sum", lengths=seg.lengths, unsafe=True)


class _ScatterPlan(NamedTuple):
    """The segment sums of one problem's LM steps, which depend on its
    ``obs_frame`` alone: per frame, and per (frame, frame) pair of the Schur
    complement (one plan per slot m1 without grouping)."""

    group: int | None  # tracks per owner group; None: no grouping
    frame: _Segments
    pair: list


def _scatter_plan(obs_frame: torch.Tensor, n: int, tracks_per_frame: int | None) -> _ScatterPlan:
    T, M = obs_frame.shape
    if tracks_per_frame is not None and T % max(tracks_per_frame, 1) == 0:
        group_frames = obs_frame.reshape(T // tracks_per_frame, tracks_per_frame, M)[:, 0, :]
        pairs = group_frames[:, :, None] * n + group_frames[:, None, :]
        return _ScatterPlan(tracks_per_frame, _segments(group_frames, n), [_segments(pairs, n * n)])
    return _ScatterPlan(None, _segments(obs_frame, n), [
        _segments(obs_frame[:, m1, None] * n + obs_frame, n * n) for m1 in range(M)])


def _gn_step(
    p: BAProblem,
    huber_delta: float,
    lm_lambda: torch.Tensor,
    fixed_cameras: torch.Tensor,
    optimize_focal: bool = False,
    inverse_depth: bool = False,
    tracks_per_frame: int | None = None,
    plan: _ScatterPlan | None = None,
):
    """One damped Gauss-Newton step. Camera dof 6 (rotation, center) or 7
    (+ a shared log-focal scale); point dof 3 (euclidean) or 1 (inverse depth
    along the owner-frame bearing). ``plan`` is ``_scatter_plan(p.obs_frame,
    N, tracks_per_frame)``, made here when not given. Returns (rotations,
    centers, points, intrinsics)."""
    N = p.rotations.shape[0]
    T, M = p.obs_frame.shape
    DC = 7 if optimize_focal else 6
    DP = 1 if inverse_depth else 3
    dev = p.rotations.device

    rot, cen, intr = _gather(p)  # (T, M, 3, 3), (T, M, 3), (T, M, 4)
    uv_hat, x_cam = _project(rot, cen, intr, p.points[:, None, :])
    r = uv_hat - p.obs_uv  # (T, M, 2)
    r_norm = torch.linalg.norm(r, dim=-1)
    w = (p.obs_valid * p.track_valid[:, None] * (x_cam[..., 2] > 1e-6)
         * _robust_weights(r_norm, huber_delta))  # (T, M)

    # d uv / d x_cam: (T, M, 2, 3)
    z = torch.where(x_cam[..., 2].abs() < 1e-8, torch.full_like(x_cam[..., 2], 1e-8),
                    x_cam[..., 2])
    fx, fy = intr[..., 0], intr[..., 1]
    zero = torch.zeros_like(z)
    Jpi = torch.stack([
        torch.stack([fx / z, zero, -fx * x_cam[..., 0] / (z * z)], dim=-1),
        torch.stack([zero, fy / z, -fy * x_cam[..., 1] / (z * z)], dim=-1),
    ], dim=-2)

    # d x_cam / d (w, dc) = [-[x_cam]x | -R]
    Jc = torch.cat([Jpi @ -skew(x_cam), Jpi @ -rot], dim=-1)  # (T, M, 2, 6)
    if optimize_focal:
        # f' = f exp(s): d u / d s = fx x / z
        Jf = torch.stack([fx * x_cam[..., 0] / z, fy * x_cam[..., 1] / z], dim=-1)
        Jc = torch.cat([Jc, Jf[..., None]], dim=-1)

    JpX = Jpi @ rot  # (T, M, 2, 3) d uv / d X
    if inverse_depth:
        u_dir, rho, c_a = _anchor_rays(p)
        dX_drho = -u_dir / (rho**2)[:, None]
        Jp = torch.einsum("tmij,tj->tmi", JpX, dX_drho)[..., None]  # (T, M, 2, 1)
    else:
        Jp = JpX

    # owner-grouped accumulation: (owner frame, keypoint) layout with the
    # same obs_frame rows within a group; sum over the group, then by frame
    if plan is None:
        plan = _scatter_plan(p.obs_frame, N, tracks_per_frame)
    K_g = plan.group or 1
    NG = T // K_g

    wJc = w[..., None, None] * Jc
    Hcc_obs = torch.einsum("tmki,tmkj->tmij", wJc, Jc)  # (T, M, DC, DC)
    bc_obs = -torch.einsum("tmki,tmk->tmi", wJc, r)  # (T, M, DC)
    Hcc = _segment_sum(Hcc_obs.reshape(NG, K_g, M, DC, DC).sum(1).reshape(-1, DC, DC), plan.frame)
    bc = _segment_sum(bc_obs.reshape(NG, K_g, M, DC).sum(1).reshape(-1, DC), plan.frame)

    wJp = w[..., None, None] * Jp
    Hpp = torch.einsum("tmki,tmkj->tij", wJp, Jp)  # (T, DP, DP)
    bp = -torch.einsum("tmki,tmk->ti", wJp, r)  # (T, DP)
    Hcp = torch.einsum("tmki,tmkj->tmij", wJc, Jp)  # (T, M, DC, DP)

    # pose priors on the camera diagonal blocks
    dr_prior, dc_prior = _prior_residuals(p)
    eye3 = torch.eye(3, device=dev)
    Hcc[:, :3, :3] += p.prior_rot_weight[:, None, None] * eye3
    Hcc[:, 3:6, 3:6] += p.prior_pos_weight[:, None, None] * eye3
    bc[:, :3] -= p.prior_rot_weight[:, None] * dr_prior
    bc[:, 3:6] -= p.prior_pos_weight[:, None] * dc_prior

    # gravity residual r_g = R g_w - g_meas; d(exp(w) R g_w)/dw = -[R g_w]x
    g_pred = p.rotations @ p.gravity_world  # (N, 3)
    r_g = g_pred - p.gravity_dirs
    Jg = -skew(g_pred)
    wg = p.gravity_weight[:, None]
    Hcc[:, :3, :3] += wg[..., None] * torch.einsum("nki,nkj->nij", Jg, Jg)
    bc[:, :3] -= torch.einsum("nki,nk->ni", Jg, wg * r_g)

    # LM damping, scaled by the diagonal
    Hcc = Hcc + torch.diag_embed(lm_lambda * (torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-6))
    Hpp = Hpp + torch.diag_embed(lm_lambda * (torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6))

    # tracks with no valid observation: identity point block, no update
    track_has_obs = w.sum(1) > 0
    Hpp = torch.where(track_has_obs[:, None, None], Hpp, torch.eye(DP, device=dev))
    Hpp_inv = torch.linalg.inv_ex(Hpp)[0]  # (T, DP, DP)

    # Schur complement on the cameras: S = Hcc - sum_t Hcp Hpp^-1 Hpc
    Y = torch.einsum("tmij,tjk->tmik", Hcp, Hpp_inv)  # (T, M, DC, DP)
    if plan.group is not None:
        # (m1, m2) frame-pair couplings summed over each owner group
        Yg = Y.reshape(NG, K_g, M, DC, DP)
        Hcpg = Hcp.reshape(NG, K_g, M, DC, DP)
        S_contrib = torch.einsum("nkaij,nkblj->nabil", Yg, Hcpg)  # (NG, M, M, DC, DC)
        S_flat = _segment_sum(S_contrib.reshape(-1, DC, DC), plan.pair[0])
    else:
        # one slot at a time, so the (T, M, M, DC, DC) coupling never exists
        S_flat = torch.zeros((N * N, DC, DC), dtype=Y.dtype, device=dev)
        for m1, seg in enumerate(plan.pair):
            contrib = torch.einsum("tij,tmkj->tmik", Y[:, m1], Hcp)  # (T, M, DC, DC)
            S_flat += _segment_sum(contrib.reshape(-1, DC, DC), seg)
    yb = torch.einsum("tmij,tj->tmi", Y, bp).reshape(NG, K_g, M, DC).sum(1)
    b_schur = bc - _segment_sum(yb.reshape(-1, DC), plan.frame)

    S = -S_flat.reshape(N, N, DC, DC)
    ar = torch.arange(N, device=dev)
    S[ar, ar] += Hcc

    # fixed cameras: identity rows / columns, zero right-hand side
    keep = (1.0 - fixed_cameras)[:, None]
    b_schur = b_schur * keep
    S = S * (keep[:, None, :, None] * keep[None, :, None, :])
    S[ar, ar] += torch.eye(DC, device=dev) * fixed_cameras[:, None, None]

    S_dense = S.permute(0, 2, 1, 3).reshape(DC * N, DC * N)
    delta_c = torch.linalg.solve_ex(S_dense, b_schur.reshape(-1, 1))[0].reshape(N, DC)
    delta_c = torch.nan_to_num(delta_c)

    # back-substitute the points: dX = Hpp^-1 (bp - Hpc dc)
    hpc_dc = torch.einsum("tmij,tmi->tj", Hcp, delta_c[p.obs_frame])  # (T, DP)
    delta_p = torch.einsum("tij,tj->ti", Hpp_inv, bp - hpc_dc)
    delta_p = torch.nan_to_num(delta_p) * track_has_obs[:, None]

    new_rot = so3_exp(delta_c[:, :3]) @ p.rotations
    new_cen = p.centers + delta_c[:, 3:6]
    if inverse_depth:
        rho_new = (rho + delta_p[:, 0]).clamp_min(1e-9)
        new_pts = c_a + u_dir / rho_new[:, None]
    else:
        new_pts = p.points + delta_p
    new_intr = p.intrinsics
    if optimize_focal:
        scale = torch.exp(delta_c[:, 6].clamp(-0.2, 0.2))
        new_intr = p.intrinsics.clone()
        new_intr[:, 0] *= scale
        new_intr[:, 1] *= scale
    return new_rot, new_cen, new_pts, new_intr


def bundle_adjust(
    problem: BAProblem,
    iterations: int = 10,
    huber_delta: float = 2.0,
    init_lambda: float = 1e-4,
    fixed_cameras: torch.Tensor | None = None,
    optimize_focal: bool = False,
    use_inverse_depth: bool = False,
    tracks_per_frame: int | None = None,
    ftol: float = 0.0,
    return_info: bool = False,
):
    """LM-damped Gauss-Newton BA: returns the problem with updated rotations,
    centers and points (and intrinsics with ``optimize_focal``), and with
    ``return_info`` also {"iterations", "final_cost"}.

    A step is accepted when it lowers the cost; the damping falls by 0.3 on
    acceptance (floor 1e-8) and rises by 10 on rejection (cap 1e4). With
    ``ftol > 0``, ``iterations`` is a maximum: the solve stops once an
    accepted step's relative cost decrease is below ftol, or a rejection
    finds the damping at its cap (Ceres' function_tolerance). ``ftol == 0``
    runs exactly ``iterations`` steps."""
    n = problem.rotations.shape[0]
    dev = problem.rotations.device
    fixc = (torch.zeros(n, device=dev) if fixed_cameras is None
            else torch.as_tensor(fixed_cameras, dtype=torch.float32).to(dev))
    if use_inverse_depth:
        problem = snap_points_to_anchor_rays(problem)

    prob = problem
    lam = torch.tensor(init_lambda, dtype=torch.float32, device=dev)
    cost = _cost(prob, huber_delta)
    plan = _scatter_plan(prob.obs_frame, n, tracks_per_frame)
    done = 0
    for done in range(1, iterations + 1):
        new_rot, new_cen, new_pts, new_intr = _gn_step(
            prob, huber_delta, lam, fixc, optimize_focal=optimize_focal,
            inverse_depth=use_inverse_depth, tracks_per_frame=tracks_per_frame, plan=plan)
        cand = prob._replace(rotations=new_rot, centers=new_cen, points=new_pts,
                             intrinsics=new_intr)
        new_cost = _cost(cand, huber_delta)
        accept = new_cost < cost
        prob = BAProblem(*(torch.where(accept, a, b) for a, b in zip(cand, prob)))
        rel = (cost - new_cost) / cost.clamp_min(1e-30)
        converged = torch.where(accept, rel < ftol, lam >= 1e4)
        lam = torch.where(accept, (lam * 0.3).clamp_min(1e-8), (lam * 10.0).clamp_max(1e4))
        cost = torch.where(accept, new_cost, cost)
        if ftol > 0.0 and bool(converged):  # one host read per iteration
            break
    if return_info:
        return prob, {"iterations": done, "final_cost": cost}
    return prob


def prune_outlier_tracks(p: BAProblem, max_reproj_px: float = 2.0,
                         min_tri_angle_deg: float = 0.25) -> torch.Tensor:
    """PyTheia's SetOutlierTracksToUnestimated: a track survives if its
    largest reprojection error is <= max_reproj_px and the largest angle
    between two of its observation rays is >= min_tri_angle_deg. Returns the
    updated track_valid (T,)."""
    err = reprojection_errors(p)
    valid = torch.isfinite(err)
    max_err = torch.where(valid, err, torch.zeros_like(err)).amax(1)
    has_obs = valid.any(1)
    rays = p.points[:, None, :] - p.centers[p.obs_frame]
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(1e-12)
    cosang = torch.einsum("tmi,tni->tmn", rays, rays)
    pair_ok = valid[:, :, None] & valid[:, None, :]
    cos_min = torch.where(pair_ok, cosang, torch.ones_like(cosang)).amin(dim=(1, 2))
    max_angle = torch.rad2deg(torch.arccos(cos_min.clamp(-1.0, 1.0)))
    keep = has_obs & (max_err <= max_reproj_px) & (max_angle >= min_tri_angle_deg)
    return p.track_valid * keep.float()


# iteration count and final cost of the most recent solve of this thread
# (last_ba_info); thread-local, as in the JAX package
_BA_INFO = threading.local()


def run_bundle_adjust(prob: BAProblem, iterations: int, huber_delta: float,
                      optimize_focal: bool = False, use_inverse_depth: bool = False,
                      tracks_per_frame: int | None = None, ftol: float = 1e-6) -> BAProblem:
    """The reconstruction's BA: ``iterations`` is a maximum with Ceres'
    function_tolerance 1e-6 (the JAX package's ``_jit_bundle_adjust``); the
    solve's info and its seconds (the calling thread's stream synchronised
    before and after, so the problem's upload is not counted) are kept for
    :func:`last_ba_info`."""
    _synchronize(prob.rotations.device)
    t0 = time.perf_counter()
    out, info = bundle_adjust(prob, iterations=iterations, huber_delta=huber_delta,
                              optimize_focal=optimize_focal, use_inverse_depth=use_inverse_depth,
                              tracks_per_frame=tracks_per_frame, ftol=ftol, return_info=True)
    _synchronize(prob.rotations.device)
    _BA_INFO.info = dict(info, seconds=time.perf_counter() - t0)
    return out


def _synchronize(device: torch.device) -> None:
    """Wait for the calling thread's stream only: the online consumer runs BA
    on a stream of its own beside the next chunk's forward."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def last_ba_info() -> dict | None:
    """{"iterations": int, "final_cost": float, "seconds": float} of the most
    recent :func:`run_bundle_adjust` of this thread, or None."""
    info = getattr(_BA_INFO, "info", None)
    if info is None:
        return None
    return {"iterations": int(info["iterations"]), "final_cost": float(info["final_cost"]),
            "seconds": info["seconds"]}
