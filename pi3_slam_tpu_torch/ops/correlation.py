"""Correlation-based observation refinement (ZNCC patch matching).

Port of ``pi3_slam_tpu/ops/correlation.py``. A track's observations in the
frames other than its owner's are projections of the Pi3 geometry; this
re-measures each one photometrically: the owner frame's patch around the
detected keypoint is matched against a search window around the projection
by zero-mean normalised cross-correlation, with a quadratic sub-pixel fit of
the peak. Plain PyTorch on the inputs' device (the JAX version is XLA, no
Pallas kernel). The windows are one index gather; the JAX version's groups of
32 slices were a workaround for XLA's sequential slice-gather on the TPU.

The JAX semantics kept: coordinates clipped to ``w - 1.000001`` in float32
(which is ``w - 1`` for w >= 64, so the right neighbour index can reach one
past the row; the flat index is clamped to the image stack as the JAX gather
clamps it, which also keeps the last pixel of the last frame in range),
``round`` half to even, window starts taken as ``dynamic_slice`` takes them
(a negative start counts from the end, then the start is clamped so that the
window lies in the image), the first maximum of the scores, and the grey
image in [0, 1] (the gates ``tmpl_norm > 1e-4`` and ``denom >= 1e-6`` depend
on its scale).
"""

from __future__ import annotations

from typing import Tuple

import torch


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) -> (N, H, W) luma."""
    r, g, b = images[:, 0], images[:, 1], images[:, 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def bilinear_sample_flat(images: torch.Tensor, frame_idx: torch.Tensor,
                         uv: torch.Tensor) -> torch.Tensor:
    """Sample grey images (N, H, W) at (frame, u, v) points: frame_idx (...,)
    integer, uv (..., 2) pixels (u = x, v = y). Coordinates are clamped to the
    image; callers gate validity themselves."""
    n, h, w = images.shape
    f32 = images.dtype
    u = uv[..., 0].clamp(0.0).minimum(torch.tensor(w - 1.000001, dtype=f32, device=uv.device))
    v = uv[..., 1].clamp(0.0).minimum(torch.tensor(h - 1.000001, dtype=f32, device=uv.device))
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0 = u0.long()
    v0 = v0.long()
    flat = images.reshape(n * h * w)
    base = frame_idx.long() * (h * w)
    last = n * h * w - 1

    def at(vi, ui):
        return flat[(base + vi * w + ui).clamp(0, last)]

    s00 = at(v0, u0)
    s01 = at(v0, u0 + 1)
    s10 = at(v0 + 1, u0)
    s11 = at(v0 + 1, u0 + 1)
    return s00 * (1 - dv) * (1 - du) + s01 * (1 - dv) * du + s10 * dv * (1 - du) + s11 * dv * du


def zncc_refine_observations(
    gray: torch.Tensor,
    tmpl_frame: torch.Tensor,
    tmpl_uv: torch.Tensor,
    obs_frame: torch.Tensor,
    obs_uv: torch.Tensor,
    *,
    patch_radius: int = 3,
    search_radius: int = 4,
    min_zncc: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine projected observations by ZNCC template matching.

    gray (N, H, W); tmpl_frame (T,) owner frame of each track; tmpl_uv (T, 2)
    its detected keypoint; obs_frame (T, M), obs_uv (T, M, 2) projected
    observations. Returns (refined_uv (T, M, 2), zncc (T, M), refined (T, M)
    bool). An observation whose peak is weak (< min_zncc), on the search
    border, or whose windows leave the image keeps its projected coordinates
    with refined False.
    """
    n, h, w = gray.shape
    t, m = obs_frame.shape
    tm = t * m
    p = 2 * patch_radius + 1
    wp = p + 2 * search_radius
    d = 2 * search_radius + 1
    dev, f32 = gray.device, gray.dtype

    r = torch.arange(-patch_radius, patch_radius + 1, dtype=f32, device=dev)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    tmpl_offsets = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (P^2, 2) as (u, v)

    # templates (T, P^2), zero-mean
    tmpl = bilinear_sample_flat(gray, tmpl_frame[:, None], tmpl_uv[:, None, :] + tmpl_offsets)
    tmpl = tmpl - tmpl.mean(dim=1, keepdim=True)
    tmpl_norm = torch.sqrt((tmpl * tmpl).sum(dim=1))  # (T,)
    tmpl_e = tmpl.repeat_interleave(m, dim=0)  # (TM, P^2)
    tmpl_norm_e = tmpl_norm.repeat_interleave(m)

    # windows (TM, Wp, Wp) around the rounded projection, one gather; the
    # starts follow dynamic_slice (those observations fail the margin gate
    # below, but their scores are returned)
    base_uv = torch.round(obs_uv)
    base_flat = base_uv.reshape(tm, 2)
    margin = patch_radius + search_radius

    def start(i, dim, size):
        return torch.where(i < 0, i + dim, i).clamp(0, dim - size)

    x0 = start(base_flat[:, 0].long() - margin, w, wp)
    y0 = start(base_flat[:, 1].long() - margin, h, wp)
    f = start(obs_frame.reshape(tm).long(), n, 1)
    k = torch.arange(wp, device=dev)
    idx = ((f * (h * w) + y0 * w + x0)[:, None, None] + k[None, :, None] * w + k[None, None, :])
    win = gray.reshape(-1)[idx]  # (TM, Wp, Wp)

    # ZNCC of every displacement
    scores = []
    inv_p2 = 1.0 / (p * p)
    for ddy in range(d):
        for ddx in range(d):
            patch = win[:, ddy:ddy + p, ddx:ddx + p].reshape(tm, p * p)
            patch = patch - patch.sum(dim=1, keepdim=True) * inv_p2
            denom = tmpl_norm_e * torch.sqrt((patch * patch).sum(dim=1))
            scores.append((tmpl_e * patch).sum(dim=1) / denom.clamp_min(1e-6))
    sc = torch.stack(scores, dim=1)  # (TM, D^2)
    del win, scores

    best = torch.argmax(sc, dim=1)  # the first maximum
    by = (best // d).reshape(t, m)
    bx = (best % d).reshape(t, m)
    peak = sc.gather(1, best[:, None]).reshape(t, m)

    # quadratic sub-pixel fit along each axis (neighbours clamped to the grid)
    def grid_at(iy, ix):
        iy = iy.clamp(0, d - 1)
        ix = ix.clamp(0, d - 1)
        return sc.gather(1, (iy * d + ix).reshape(tm, 1)).reshape(t, m)

    def parabola(s_m, s_0, s_p):
        denom = 2.0 * s_0 - s_m - s_p
        return torch.where(denom > 1e-6, 0.5 * (s_p - s_m) / denom.clamp_min(1e-6),
                           torch.zeros_like(denom))

    sub_y = parabola(grid_at(by - 1, bx), peak, grid_at(by + 1, bx))
    sub_x = parabola(grid_at(by, bx - 1), peak, grid_at(by, bx + 1))
    sub = torch.stack([sub_x, sub_y], dim=-1).clamp(-1.0, 1.0)
    disp = torch.stack([(bx - search_radius).to(f32), (by - search_radius).to(f32)], dim=-1)
    refined_uv = base_uv + disp + sub

    win_in = ((base_uv[..., 0] >= margin) & (base_uv[..., 0] <= w - 1 - margin)
              & (base_uv[..., 1] >= margin) & (base_uv[..., 1] <= h - 1 - margin))
    tmpl_in = ((tmpl_uv[:, 0] >= patch_radius) & (tmpl_uv[:, 0] <= w - 1 - patch_radius)
               & (tmpl_uv[:, 1] >= patch_radius) & (tmpl_uv[:, 1] <= h - 1 - patch_radius)
               & (tmpl_norm > 1e-4))  # a textureless template matches anything
    on_border = (by == 0) | (by == d - 1) | (bx == 0) | (bx == d - 1)
    ok = win_in & tmpl_in[:, None] & ~on_border & (peak >= min_zncc)
    refined_uv = torch.where(ok[..., None], refined_uv, obs_uv)
    return refined_uv, peak, ok
