"""Localization of another camera against an existing reconstruction.

Port of ``pi3_slam_tpu/sfm/localize.py``. Two modes, both driven by
``localize_camera.py``:

- **Image localization (PnP).** A query image's keypoints and descriptors are
  matched (mutual-NN cosine) against the map's track descriptors; the pose is
  solved by RANSAC over batched DLT minimal solves (every hypothesis in one
  batched SVD) followed by a Huber-IRLS Gauss-Newton refinement.
- **Chunk registration (Sim3).** A second camera's Pi3 chunks are registered
  onto the map by 3D-3D descriptor matching and a trimmed robust Umeyama fit:
  the second camera reconstructed in the map frame.

Pose conventions match ``sfm/ba.py``: rotations are world -> camera, centers
are camera centers in world, uv = K pi(R (X - c)), intrinsics (fx, fy, cx,
cy). The solves run in fp32 on ``device`` (TF32 off:
``device.select_device``).

Against the JAX version:

* RANSAC's minimal samples are drawn on a CPU ``torch.Generator`` (seeded
  from ``seed``), weighted and without replacement, then moved to the
  device, so a card run and a host run score the same hypotheses.
  ``sample_idx`` takes the samples from the caller instead (the tests pass
  JAX's own draws through it).
* Triangulation takes each track's null vector from a float64 eigh of
  A^T A where JAX takes an SVD of A.
* The refinement's Jacobian on the 6-dof tangent (left so3 increment, center
  offset) is written in closed form where JAX takes ``jax.jacfwd``.
* The correspondences are not padded to a power-of-two bucket: the JAX
  version did that to bound XLA recompiles, and masked rows take no part in
  sampling, scoring, refinement or the RMS.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..geometry.sim3 import Sim3, robust_umeyama, sim3_apply
from ..geometry.transforms import skew, so3_exp
from .reconstruction import ChunkReconstruction


class PnPResult(NamedTuple):
    rotation: torch.Tensor  # (3, 3) world->camera
    center: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int64
    inlier_rms_px: torch.Tensor  # ()


def _project(rot, center, intr, X):
    """uv = K pi(R (X - c)) and the camera-frame depth; ``rot`` (..., 3, 3)
    and ``center`` (..., 3) batch over hypotheses, X is (N, 3)."""
    x_cam = torch.einsum("...ij,...nj->...ni", rot, X - center[..., None, :])
    z = x_cam[..., 2]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    u = intr[0] * x_cam[..., 0] / z_safe + intr[2]
    v = intr[1] * x_cam[..., 1] / z_safe + intr[3]
    return torch.stack([u, v], dim=-1), z


def dlt_pose(X: torch.Tensor, xn: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct linear transform pose from >= 6 correspondences, batched over
    leading dims.

    X: (..., M, 3) world points; xn: (..., M, 2) normalized image coords
    (K^-1 pixels). Returns (R world->camera, camera center). The sign of the
    null vector is resolved by cheirality (majority positive projective
    depth), the scale by the polar decomposition of the rotation block.
    Degenerate samples yield a garbage pose that scores zero inliers in
    RANSAC, with no branching.
    """
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # (..., M, 4)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -xn[..., :1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    a = torch.cat([r1, r2], dim=-2)  # (..., 2M, 12)
    _, _, vh = torch.linalg.svd(a, full_matrices=True)
    p = vh[..., -1, :].reshape(vh.shape[:-2] + (3, 4))
    # cheirality: majority of projective depths positive
    w = torch.einsum("...mj,...j->...m", Xh, p[..., 2, :])
    sgn = torch.where(torch.sign(w).sum(-1) < 0, -1.0, 1.0).to(p.dtype)
    p = p * sgn[..., None, None]
    u, s, vt2 = torch.linalg.svd(p[..., :3])
    det = torch.linalg.det(u @ vt2)
    R = torch.cat([u[..., :, :2], u[..., :, 2:] * det[..., None, None]], dim=-1) @ vt2
    alpha = s.mean(-1)
    t = p[..., 3] / alpha.clamp_min(1e-12)[..., None]
    center = -torch.einsum("...ji,...j->...i", R, t)
    return R, center


def draw_samples(valid: torch.Tensor, num_samples: int, sample_size: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(num_samples, sample_size) minimal samples over the valid
    correspondences, each without replacement with probability proportional
    to ``valid``, drawn on the CPU generator: each row keeps the
    ``sample_size`` smallest exponential keys -log(u) / p (Efraimidis and
    Spirakis), the distribution of ``torch.multinomial(p, sample_size,
    replacement=False)``, in increasing key order. The keys are ranked with
    numpy: PyTorch's multithreaded CPU log and top-k of 256 x 1000 keys take
    tens of milliseconds."""
    valid_f = valid.detach().to("cpu", torch.float32).numpy()
    p_sel = valid_f / max(float(valid_f.sum()), 1e-9)
    u = torch.rand(num_samples, p_sel.shape[0], generator=generator).numpy()
    with np.errstate(divide="ignore"):
        keys = -np.log(u) / p_sel
    part = np.argpartition(keys, sample_size - 1, axis=1)[:, :sample_size]
    order = np.take_along_axis(keys, part, 1).argsort(axis=1, kind="stable")
    return torch.from_numpy(np.take_along_axis(part, order, 1))


def pose_jacobian(R: torch.Tensor, c: torch.Tensor, intr: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """d uv / d (w, dc) of uv = K pi(exp(w) R (X - c - dc)) at w = dc = 0:
    (N, 2, 6). d x_cam / d w = -[x_cam]x (left increment), d x_cam / d dc =
    -R, chained through the projection with ``_project``'s z_safe (no
    derivative through the clamped depth)."""
    x_cam = (X - c) @ R.T
    z = x_cam[:, 2]
    near = z.abs() < 1e-8
    z_safe = torch.where(near, torch.full_like(z, 1e-8), z)
    dz = torch.where(near, torch.zeros_like(z), torch.ones_like(z))
    zero = torch.zeros_like(z)
    du = torch.stack([intr[0] / z_safe, zero, -intr[0] * x_cam[:, 0] * dz / z_safe**2], -1)
    dv = torch.stack([zero, intr[1] / z_safe, -intr[1] * x_cam[:, 1] * dz / z_safe**2], -1)
    d_uv = torch.stack([du, dv], dim=-2)  # (N, 2, 3)
    d_x = torch.cat([-skew(x_cam), -R.expand(X.shape[0], 3, 3)], dim=-1)  # (N, 3, 6)
    return d_uv @ d_x


def _f32(x) -> torch.Tensor:
    """A float32 tensor of an array or tensor (on the tensor's device)."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=torch.float32)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ransac_pnp(
    points,
    uv,
    intrinsics,
    valid=None,
    generator: torch.Generator | None = None,
    *,
    sample_idx=None,
    num_samples: int = 256,
    sample_size: int = 8,
    inlier_px: float = 5.0,
    refine_iterations: int = 10,
    huber_px: float = 2.0,
    device=None,
    timings: dict | None = None,
) -> PnPResult:
    """Robust PnP: batched DLT hypotheses, inlier vote, Huber-GN refine.

    points (N, 3), uv (N, 2) pixel observations, intrinsics (fx, fy, cx, cy),
    valid (N,) mask (default: all). The ``num_samples`` minimal samples of
    ``sample_size`` come from ``sample_idx`` (S, m) when given, else from
    ``generator`` (a CPU generator; default seeded 0); every hypothesis is
    solved in one batched SVD and scored in one (S, N) reprojection. The
    first hypothesis with the most inliers wins (integer counts, first
    maximum). ``device`` defaults to the points' device; with ``timings`` the
    seconds of the hypotheses (``ransac_s``) and of the refinement
    (``refine_s``) are written into it, the device synchronised around each.
    """
    points, uv, intr = _f32(points), _f32(uv), _f32(intrinsics)
    dev = points.device if device is None else torch.device(device)
    points, uv, intr = points.to(dev), uv.to(dev), intr.to(dev)
    n = points.shape[0]
    valid_f = (torch.ones(n) if valid is None else _f32(valid)).to(dev)

    if timings is not None:
        _synchronize(dev)
    t0 = time.perf_counter()
    if sample_idx is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sample_idx = draw_samples(valid_f, num_samples, sample_size, generator)
    idx = torch.as_tensor(sample_idx if torch.is_tensor(sample_idx) else np.array(sample_idx),
                          dtype=torch.int64).to(dev)
    xn = torch.stack([(uv[:, 0] - intr[2]) / intr[0], (uv[:, 1] - intr[3]) / intr[1]], dim=-1)
    Rs, cs = dlt_pose(points[idx], xn[idx])  # (S, 3, 3), (S, 3)

    def score(R, c):
        uv_hat, z = _project(R, c, intr, points)
        err = torch.linalg.norm(uv_hat - uv, dim=-1)
        inl = (err < inlier_px) & (z > 0) & (valid_f > 0)
        return inl.sum(-1), inl

    counts, inls = score(Rs, cs)  # (S,), (S, N)
    best = torch.argmax(counts)
    R, c, inliers = Rs[best], cs[best], inls[best]
    if timings is not None:
        _synchronize(dev)
        timings["ransac_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

    w_in = inliers.to(torch.float32)
    eye6 = torch.eye(6, device=dev)
    for _ in range(refine_iterations):
        uv_hat, _ = _project(R, c, intr, points)
        r = (uv_hat - uv).reshape(-1)  # (2N,)
        rn = torch.linalg.norm(r.reshape(-1, 2), dim=-1)
        w_h = torch.where(rn <= huber_px, torch.ones_like(rn), huber_px / rn.clamp_min(1e-9))
        w = torch.repeat_interleave(w_in * w_h, 2)
        jac = pose_jacobian(R, c, intr, points).reshape(-1, 6)  # (2N, 6)
        jtw = jac.T * w[None, :]
        h = jtw @ jac + 1e-6 * eye6
        delta = -torch.linalg.solve(h, jtw @ r)
        R = so3_exp(delta[:3]) @ R
        c = c + delta[3:]

    n_fin, inl_fin = score(R, c)
    uv_hat, _ = _project(R, c, intr, points)
    err2 = ((uv_hat - uv) ** 2).sum(-1)
    rms = torch.sqrt(torch.where(inl_fin, err2, torch.zeros_like(err2)).sum()
                     / n_fin.clamp_min(1))
    if timings is not None:
        _synchronize(dev)
        timings["refine_s"] = time.perf_counter() - t0
    return PnPResult(rotation=R, center=c, inliers=inl_fin, num_inliers=n_fin,
                     inlier_rms_px=rms)


def triangulate_points(
    rotations,
    centers,
    intrinsics,
    obs_uv,
    obs_valid,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-view DLT triangulation, all tracks as one batched eigensolve.

    rotations (V, 3, 3) world->camera, centers (V, 3), intrinsics
    (fx, fy, cx, cy); obs_uv (T, V, 2) pixel observations with validity mask
    obs_valid (T, V) (invalid rows are zero-weighted). Returns (points (T, 3),
    reprojection rms px (T,), positive-depth view counts (T,)) on ``device``
    (default: the rotations' device).
    """
    rotations = _f32(rotations)
    dev = rotations.device if device is None else torch.device(device)
    rotations = rotations.to(dev)
    centers, intr = _f32(centers).to(dev), _f32(intrinsics).to(dev)
    obs_uv, wv = _f32(obs_uv).to(dev), _f32(obs_valid).to(dev)
    t = -torch.einsum("vij,vj->vi", rotations, centers)  # (V, 3)
    p_mat = torch.cat([rotations, t[..., None]], dim=-1)  # (V, 3, 4) normalized
    xn = torch.stack([(obs_uv[..., 0] - intr[2]) / intr[0],
                      (obs_uv[..., 1] - intr[3]) / intr[1]], dim=-1)  # (T, V, 2)
    w = wv[..., None]
    r1 = xn[..., 0:1] * p_mat[None, :, 2, :] - p_mat[None, :, 0, :]
    r2 = xn[..., 1:2] * p_mat[None, :, 2, :] - p_mat[None, :, 1, :]
    a = torch.cat([r1 * w, r2 * w], dim=1)  # (T, 2V, 4)
    # the right singular vector of the smallest singular value, as the
    # eigenvector of the smallest eigenvalue of A^T A in float64 (cuSOLVER
    # runs a batch of tall SVDs one matrix at a time: 0.56 s for 1,937 tracks
    # over 100 views on the card, against a batched 4 x 4 eigh)
    a64 = a.double()
    xh = torch.linalg.eigh(a64.transpose(1, 2) @ a64)[1][..., 0].to(a.dtype)  # (T, 4)
    denom = torch.where(xh[:, 3:4].abs() < 1e-9, torch.full_like(xh[:, 3:4], 1e-9), xh[:, 3:4])
    pts = xh[:, :3] / denom

    # quality: reprojection error + cheirality per view
    x_cam = torch.einsum("vij,tvj->tvi", rotations, pts[:, None, :] - centers[None])
    z = x_cam[..., 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = intr[0] * x_cam[..., 0] / zs + intr[2]
    vv = intr[1] * x_cam[..., 1] / zs + intr[3]
    err2 = (u - obs_uv[..., 0]) ** 2 + (vv - obs_uv[..., 1]) ** 2
    n_obs = wv.sum(dim=1).clamp_min(1.0)
    rms = torch.sqrt(torch.where(wv > 0, err2, torch.zeros_like(err2)).sum(dim=1) / n_obs)
    n_front = ((z > 0) & (wv > 0)).sum(dim=1)
    return pts, rms, n_front


def build_query_tracks(
    detections: List[dict], min_cosine: float = 0.85
) -> Tuple[np.ndarray, np.ndarray]:
    """Chain mutual-NN descriptor matches across consecutive query images
    into multi-view tracks (a light feature tracker for triangulating a
    second camera's own points in PnP mode, where no Pi3 geometry exists
    for the query camera).

    detections: per image {'keypoints': (K, 2), 'descriptors': (K, D)}.
    Returns (obs_uv (T, V, 2), obs_valid (T, V)) for tracks seen in >= 2
    images.
    """
    from .alignment import mutual_nn_match

    n_img = len(detections)
    track_of: List[dict] = [dict() for _ in range(n_img)]  # kp idx -> track id
    tracks: List[dict] = []  # track id -> {img: kp_idx}
    for k in range(1, n_img):
        prev, cur = detections[k - 1], detections[k]
        if prev["descriptors"].shape[0] == 0 or cur["descriptors"].shape[0] == 0:
            continue
        qi, pi = mutual_nn_match(cur["descriptors"], prev["descriptors"], min_cosine)
        for q, p in zip(qi, pi):
            tid = track_of[k - 1].get(int(p))
            if tid is None:
                tid = len(tracks)
                tracks.append({k - 1: int(p)})
                track_of[k - 1][int(p)] = tid
            tracks[tid][k] = int(q)
            track_of[k][int(q)] = tid

    multi = [tr for tr in tracks if len(tr) >= 2]
    obs_uv = np.zeros((len(multi), n_img, 2), np.float32)
    obs_valid = np.zeros((len(multi), n_img), np.float32)
    for ti, tr in enumerate(multi):
        for img, kp in tr.items():
            obs_uv[ti, img] = detections[img]["keypoints"][kp]
            obs_valid[ti, img] = 1.0
    return obs_uv, obs_valid


def _pool_map_tracks(
    recons: Sequence[ChunkReconstruction], cap_per_chunk: int = 4096
) -> Tuple[np.ndarray, np.ndarray]:
    """Pooled (points, descriptors) of live described tracks across the map."""
    from .alignment import subsample_live_tracks

    pts, descs = [], []
    for r in recons:
        if r.track_desc is None:
            continue
        live = subsample_live_tracks(r, cap_per_chunk)
        pts.append(r.points[live])
        descs.append(r.track_desc[live])
    if not pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 0), np.float32)
    return np.concatenate(pts).astype(np.float32), np.concatenate(descs).astype(np.float32)


@dataclasses.dataclass
class LocalizationResult:
    success: bool
    rotation: np.ndarray | None  # (3, 3) world->camera
    center: np.ndarray | None
    num_matches: int
    num_inliers: int
    inlier_rms_px: float


def localize_by_descriptors(
    map_recons: Sequence[ChunkReconstruction],
    keypoints: np.ndarray,
    descriptors: np.ndarray,
    intrinsics: np.ndarray,
    *,
    min_cosine: float = 0.85,
    min_inliers: int = 12,
    seed: int = 0,
    map_pool: Tuple[np.ndarray, np.ndarray] | None = None,
    device="cuda",
    timings: dict | None = None,
    **ransac_kwargs,
) -> LocalizationResult:
    """Localize one query image: match its descriptors to the map's track
    descriptors and solve robust PnP on ``device``, its samples drawn on a
    CPU generator seeded with ``seed``.

    map_pool: optional precomputed ``_pool_map_tracks`` output; the pool is
    invariant across query images, so callers localizing many images pool
    once. With ``timings`` the seconds of the matching (``match_s``), the
    hypotheses (``ransac_s``) and the refinement (``refine_s``) are written
    into it."""
    map_pts, map_desc = map_pool if map_pool is not None else _pool_map_tracks(map_recons)
    if map_pts.shape[0] == 0:
        return LocalizationResult(False, None, None, 0, 0, float("inf"))
    from .alignment import mutual_nn_match

    t0 = time.perf_counter()
    qi, mi = mutual_nn_match(
        descriptors / np.maximum(np.linalg.norm(descriptors, axis=-1, keepdims=True), 1e-9),
        map_desc,
        min_cosine,
    )
    if timings is not None:
        timings["match_s"] = time.perf_counter() - t0
    n_match = int(qi.size)
    # every RANSAC minimal sample draws sample_size distinct points
    sample_size = ransac_kwargs.get("sample_size", 8)
    if n_match < max(min_inliers, sample_size):
        return LocalizationResult(False, None, None, n_match, 0, float("inf"))

    res = ransac_pnp(
        torch.from_numpy(np.ascontiguousarray(map_pts[mi], np.float32)),
        torch.from_numpy(np.ascontiguousarray(keypoints[qi], np.float32)),
        torch.as_tensor(np.asarray(intrinsics, np.float32)),
        None,
        torch.Generator().manual_seed(seed),
        device=device,
        timings=timings,
        **ransac_kwargs,
    )
    n_inl = int(res.num_inliers)
    if n_inl < min_inliers:
        return LocalizationResult(False, None, None, n_match, n_inl, float(res.inlier_rms_px))
    return LocalizationResult(True, res.rotation.cpu().numpy(), res.center.cpu().numpy(),
                              n_match, n_inl, float(res.inlier_rms_px))


@dataclasses.dataclass
class RegistrationResult:
    success: bool
    sim3: Sim3 | None
    num_matches: int
    num_inliers: int
    inlier_rms: float


def register_reconstruction(
    map_recons: Sequence[ChunkReconstruction],
    query: ChunkReconstruction,
    *,
    min_cosine: float = 0.85,
    min_matches: int = 30,
    min_inliers: int = 20,
    inlier_scale_factor: float = 0.05,
    apply: bool = True,
    map_pool: Tuple[np.ndarray, np.ndarray] | None = None,
    device="cuda",
) -> RegistrationResult:
    """Sim3-register a second camera's chunk onto the map by 3D-3D
    descriptor matching (the registered chunk's tracks live in the map frame
    afterwards); the trimmed robust Umeyama fit runs in fp32 on ``device``.
    map_pool as in :func:`localize_by_descriptors`."""
    if query.track_desc is None:
        return RegistrationResult(False, None, 0, 0, float("inf"))
    map_pts, map_desc = map_pool if map_pool is not None else _pool_map_tracks(map_recons)
    if map_pts.shape[0] == 0:
        return RegistrationResult(False, None, 0, 0, float("inf"))
    from .alignment import mutual_nn_match

    live = np.nonzero(query.track_valid > 0)[0]
    qi, mi = mutual_nn_match(query.track_desc[live], map_desc, min_cosine)
    n_match = int(qi.size)
    if n_match < min_matches:
        return RegistrationResult(False, None, n_match, 0, float("inf"))
    src = query.points[live[qi]].astype(np.float32)
    dst = map_pts[mi]
    spread = np.median(np.linalg.norm(dst - np.median(dst, axis=0), axis=-1))
    tau = max(float(spread) * inlier_scale_factor, 1e-6)

    dev = torch.device(device)
    src_t, dst_t = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    t = robust_umeyama(src_t, dst_t, huber_delta=tau, iterations=8)
    res = torch.linalg.norm(sim3_apply(t, src_t) - dst_t, dim=-1).cpu().numpy()
    inl = res <= 2.0 * tau
    n_inl = int(inl.sum())
    if n_inl < min_inliers:
        return RegistrationResult(False, None, n_match, n_inl, float("inf"))
    if apply:
        from .alignment import apply_sim3_to_reconstruction

        apply_sim3_to_reconstruction(query, t)
    return RegistrationResult(True, t, n_match, n_inl, float(np.sqrt(np.mean(res[inl] ** 2))))
