"""Focal and z-shift recovery from pointmaps, the depth-edge mask and grid
sampling at keypoints: the geometry the chunk step and MoGe-2 run after their
models, in plain PyTorch.

Frozen copies of the port's ``geometry/focal.py`` (a fixed 30-iteration
damped Gauss-Newton over the scalar shift, MoGe's ``recover_focal_shift``),
``geometry/maps.py`` and ``ops/interpolate.grid_sample_frames``, kept here so
that the reference imports nothing of the program. The intrinsics the creator
derives from the same solve are not worked out again: on random weights the
solve is degenerate and they are not compared.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normalized_view_plane_uv(width: int, height: int, aspect_ratio: float | None = None,
                             device=None):
    """UV grid (H, W, 2) over the diagonally normalised view plane, at pixel
    centres."""
    ar = width / height if aspect_ratio is None else aspect_ratio
    span_x = ar / (1 + ar**2) ** 0.5
    span_y = 1 / (1 + ar**2) ** 0.5
    u = torch.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width, width,
                       device=device)
    v = torch.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height, height,
                       device=device)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    return torch.stack([uu, vv], dim=-1)


def nearest_resize(x, out_hw):
    """(..., H, W, C) -> (..., h, w, C), src = floor(dst * H / h)."""
    H, W = x.shape[-3], x.shape[-2]
    h, w = out_hw
    rows = torch.floor(torch.arange(h, device=x.device) * (H / h)).long()
    cols = torch.floor(torch.arange(w, device=x.device) * (W / w)).long()
    return x[..., rows[:, None], cols[None, :], :]


def _loss_and_derivatives(shift, xy, z, uv, w):
    d = z + shift[:, None]
    live = d.abs() >= 1e-12
    d = torch.where(live, d, torch.full_like(d, 1e-12))[..., None]
    live = live[..., None].to(d.dtype)
    a = xy / d
    a1 = -a / d * live
    a2 = 2 * a / (d * d) * live
    wv = w[..., None]

    def total(x):
        return x.sum(dim=(1, 2))

    A, A1, A2 = total(wv * a * uv), total(wv * a1 * uv), total(wv * a2 * uv)
    b_raw = total(wv * a * a)
    b_live = (b_raw >= 1e-12).to(d.dtype)
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
    xy, z = points[..., :2], points[..., 2]
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
    valid = w.sum(-1) >= 2
    return (torch.where(valid, focal, torch.ones_like(focal)),
            torch.where(valid, shift, torch.zeros_like(shift)))


def recover_focal_shift(points, mask=None, downsample_size=(64, 64), iterations: int = 30):
    """(focal, shift) per frame of (..., H, W, 3) pointmaps; the focal is
    relative to the half image diagonal."""
    shape = points.shape
    H, W = shape[-3], shape[-2]
    lead = shape[:-3]
    flat = points.reshape((-1,) + tuple(shape[-3:]))
    uv = normalized_view_plane_uv(W, H, device=points.device)
    pts = nearest_resize(flat, downsample_size)
    uv_lr = nearest_resize(uv, downsample_size).reshape(-1, 2)
    if mask is None:
        weight = torch.ones(pts.shape[:-1], dtype=points.dtype, device=points.device)
    else:
        m = mask.reshape((-1,) + tuple(shape[-3:-1])).to(points.dtype)
        weight = nearest_resize(m[..., None], downsample_size)[..., 0]
    focal, shift = _solve_shift(pts.reshape(pts.shape[0], -1, 3), uv_lr,
                                weight.reshape(weight.shape[0], -1), iterations)
    return focal.reshape(lead), shift.reshape(lead)


def depth_edge(depth, rtol: float, kernel_size: int = 3):
    """(..., H, W) -> bool: the kxk neighbourhood's max - min depth over the
    centre depth exceeds rtol."""
    lead = depth.shape[:-2]

    def pool(x):
        y = F.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), kernel_size, stride=1,
                         padding=kernel_size // 2)
        return y.reshape(lead + y.shape[-2:])

    diff = pool(depth) + pool(-depth)
    rel = torch.nan_to_num(diff / depth, nan=0.0, posinf=0.0, neginf=0.0)
    return rel > rtol


def sample_at(maps, keypoints, mode: str = "bilinear"):
    """maps (N, H, W, C) at keypoints (N, K, 2) pixel (x, y) -> (N, K, C):
    normalised with (size - 1), sampled with align_corners=False; bilinear
    clamps to the border, nearest rounds with floor(x + 0.5)."""
    n, h, w, c = maps.shape
    kx, ky = keypoints[..., 0].to(maps.dtype), keypoints[..., 1].to(maps.dtype)
    px = ((kx / (w - 1) * 2.0 - 1.0 + 1.0) * w - 1.0) / 2.0
    py = ((ky / (h - 1) * 2.0 - 1.0 + 1.0) * h - 1.0) / 2.0
    flat = maps.reshape(n, h * w, c)

    def gather(yi, xi):
        return torch.gather(flat, 1, (yi * w + xi).unsqueeze(-1).expand(-1, -1, c))

    if mode == "nearest":
        return gather(torch.floor(py + 0.5).clamp(0, h - 1).long(),
                      torch.floor(px + 0.5).clamp(0, w - 1).long())
    x, y = px.clamp(0.0, w - 1.0), py.clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    fx, fy = (x - x0).unsqueeze(-1), (y - y0).unsqueeze(-1)
    return (gather(y0, x0) * (1 - fy) * (1 - fx) + gather(y0, x1) * (1 - fy) * fx
            + gather(y1, x0) * fy * (1 - fx) + gather(y1, x1) * fy * fx)
