"""Dense-map utilities: depth discontinuity mask, normalised view-plane UV,
nearest-neighbour resize. Port of ``pi3_slam_tpu/geometry/maps.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_pool_same(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Stride-1 max pool over the last two dims, padded with -inf."""
    lead = x.shape[:-2]
    y = F.max_pool2d(
        x.reshape((-1, 1) + x.shape[-2:]), kernel_size, stride=1, padding=kernel_size // 2
    )
    return y.reshape(lead + y.shape[-2:])


def depth_edge(
    depth: torch.Tensor,
    atol: float | None = None,
    rtol: float | None = None,
    kernel_size: int = 3,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Depth-discontinuity mask (..., H, W) -> bool: the kxk neighbourhood's
    max - min depth exceeds ``atol`` or ``rtol`` times the centre depth."""
    if mask is None:
        diff = _max_pool_same(depth, kernel_size) + _max_pool_same(-depth, kernel_size)
    else:
        neg_inf = torch.full_like(depth, -torch.inf)
        diff = _max_pool_same(torch.where(mask, depth, neg_inf), kernel_size) + _max_pool_same(
            torch.where(mask, -depth, neg_inf), kernel_size
        )
    edge = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    if atol is not None:
        edge |= diff > atol
    if rtol is not None:
        rel = torch.nan_to_num(diff / depth, nan=0.0, posinf=0.0, neginf=0.0)
        edge |= rel > rtol
    return edge


def normalized_view_plane_uv(
    width: int, height: int, aspect_ratio: float | None = None, dtype=torch.float32, device=None
) -> torch.Tensor:
    """UV grid (H, W, 2) over the diagonally normalised view plane, at pixel
    centres."""
    if aspect_ratio is None:
        aspect_ratio = width / height
    span_x = aspect_ratio / (1 + aspect_ratio**2) ** 0.5
    span_y = 1 / (1 + aspect_ratio**2) ** 0.5
    u = torch.linspace(
        -span_x * (width - 1) / width, span_x * (width - 1) / width, width,
        dtype=dtype, device=device,
    )
    v = torch.linspace(
        -span_y * (height - 1) / height, span_y * (height - 1) / height, height,
        dtype=dtype, device=device,
    )
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    return torch.stack([uu, vv], dim=-1)


def nearest_resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize (..., H, W, C) maps to (..., h, w, C) with torch 'nearest'
    index semantics: src = floor(dst * H / h)."""
    H, W = x.shape[-3], x.shape[-2]
    h, w = out_hw
    rows = torch.floor(torch.arange(h, device=x.device) * (H / h)).long()
    cols = torch.floor(torch.arange(w, device=x.device) * (W / w)).long()
    return x[..., rows[:, None], cols[None, :], :]
