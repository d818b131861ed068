"""Focal-length / z-shift recovery from pointmaps, and intrinsics estimation.

Port of ``pi3_slam_tpu/geometry/focal.py``: a fixed 30-iteration damped
Gauss-Newton solve over the scalar shift, batched over frames. Given a
pointmap P = (x, y, z) and the normalised view-plane uv, it minimises
|f * xy / (z + shift) - uv|^2 with f in closed form for each shift.

The JAX version differentiates the loss with jax.grad and jax.jacfwd; here
the first and second derivatives in the shift are written out in closed
form for all frames at once (the same quantities: the loss is a rational
function of one scalar). In eager PyTorch this keeps each iteration to a
few dozen batched elementwise ops, where function transforms of the loss
dispatch many times more small operations from the host. Runs in true fp32
(TF32 is off, see ``device.py``).
"""

from __future__ import annotations

import torch

from .maps import nearest_resize, normalized_view_plane_uv


def _loss_and_derivatives(shift, xy, z, uv, w):
    """Per frame: loss L(shift) = sum (w * (f * xy/(z+shift) - uv))^2 with
    f = <w a, uv> / max(<w a, a>, 1e-12), a = xy / (z + shift); its first and
    second derivatives in shift; and f. shift (F,), xy (F, M, 2), z (F, M),
    uv (M, 2), w (F, M)."""
    d = z + shift[:, None]
    live = d.abs() >= 1e-12  # clamped denominators are constant in the shift
    d = torch.where(live, d, torch.full_like(d, 1e-12))[..., None]
    live = live[..., None].to(d.dtype)
    a = xy / d  # (F, M, 2) and its shift derivatives
    a1 = -a / d * live
    a2 = 2 * a / (d * d) * live
    wv = w[..., None]

    def total(x):
        return x.sum(dim=(1, 2))

    A, A1, A2 = total(wv * a * uv), total(wv * a1 * uv), total(wv * a2 * uv)
    b_raw = total(wv * a * a)
    b_live = (b_raw >= 1e-12).to(d.dtype)  # max(B, 1e-12) is constant below
    B = b_raw.clamp_min(1e-12)
    B1 = 2 * total(wv * a * a1) * b_live
    B2 = 2 * total(wv * (a1 * a1 + a * a2)) * b_live
    f = A / B
    num1 = A1 * B - A * B1
    f1 = num1 / (B * B)
    f2 = (A2 * B - A * B2) / (B * B) - 2 * B1 * num1 / (B * B * B)
    f, f1, f2 = f[:, None, None], f1[:, None, None], f2[:, None, None]
    r = f * a - uv
    r1 = f1 * a + f * a1
    r2 = f2 * a + 2 * f1 * a1 + f * a2
    w2 = wv * wv
    return total(w2 * r * r), 2 * total(w2 * r * r1), 2 * total(w2 * (r1 * r1 + r * r2)), f[:, 0, 0]


def _solve_shift(points, uv, weight, iterations: int = 30):
    """Damped-GN solve for every frame at once. points (F, M, 3), uv (M, 2),
    weight (F, M) in {0, 1} -> (focal (F,), shift (F,))."""
    xy = points[..., :2]
    z = points[..., 2]
    w = weight.to(points.dtype)
    n = points.shape[0]
    shift = torch.zeros(n, dtype=points.dtype, device=points.device)
    lam = torch.full((n,), 1e-3, dtype=points.dtype, device=points.device)
    for _ in range(iterations):
        loss, g, h, _ = _loss_and_derivatives(shift, xy, z, uv, w)
        h_safe = torch.where(h.abs() < 1e-12, torch.full_like(h, 1e-12), h)
        new_shift = shift - g / (h_safe + lam * h_safe.abs())
        improved = _loss_and_derivatives(new_shift, xy, z, uv, w)[0] < loss
        shift = torch.where(improved, new_shift, shift)
        lam = torch.where(improved, (lam * 0.5).clamp_min(1e-6), lam * 4.0)
    focal = _loss_and_derivatives(shift, xy, z, uv, w)[3]
    # degenerate frame (fewer than 2 valid pixels): focal 1, shift 0
    valid = w.sum(-1) >= 2
    return torch.where(valid, focal, torch.ones_like(focal)), torch.where(
        valid, shift, torch.zeros_like(shift)
    )


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
    focal, shift = _solve_shift(points_lr, uv_lr, weight, iterations)
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
