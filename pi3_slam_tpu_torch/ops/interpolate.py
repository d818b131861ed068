"""Resampling ops: DINOv2 position-embedding interpolation, MoGe's bilinear
map resizing, and the grid_sample-style keypoint sampling of the chunk step.

Port of ``pi3_slam_tpu/ops/interpolate.py``. The JAX package rebuilt torch's
bicubic and bilinear (antialiased) ``F.interpolate`` as interpolation-matrix
matmuls; here torch's own operator is the reference semantics, so it is
called directly (and held to the JAX matrices in the tests).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_pos_embed(
    pos_embed: torch.Tensor,
    grid_hw: tuple[int, int],
    interpolate_offset: float = 0.0,
    antialias: bool = True,
) -> torch.Tensor:
    """Interpolate a square (M*M, C) patch pos-embed grid to (h0*w0, C).

    DINOv2 ``interpolate_pos_encoding``: the Pi3 ``*_reg`` backbones use
    antialias=True and offset 0.0 (size-driven mapping); a non-zero offset
    gives the scale-factor-driven mapping of the plain backbones.
    """
    n, c = pos_embed.shape
    m = int(round(n**0.5))
    if m * m != n:
        raise ValueError("pos embed grid must be square")
    h0, w0 = grid_hw
    if (h0, w0) == (m, m):
        return pos_embed
    grid = pos_embed.float().reshape(1, m, m, c).permute(0, 3, 1, 2)
    if interpolate_offset:
        scale = ((h0 + interpolate_offset) / m, (w0 + interpolate_offset) / m)
        out = F.interpolate(grid, scale_factor=scale, mode="bicubic", antialias=antialias)
    else:
        out = F.interpolate(grid, size=(h0, w0), mode="bicubic", antialias=antialias)
    return out.permute(0, 2, 3, 1).reshape(h0 * w0, c).to(pos_embed.dtype)


def bilinear_resize(x: torch.Tensor, out_hw: tuple[int, int], antialias: bool = False) -> torch.Tensor:
    """Resize (..., C, H, W) maps to (..., C, h, w) with torch's bilinear
    ``F.interpolate`` (align_corners=False), optionally antialiased; computed
    in fp32 and cast back. The JAX package's ``bilinear_resize_hw`` rebuilt
    the same semantics on (..., H, W, C) as interpolation matrices."""
    out_hw = tuple(out_hw)
    if tuple(x.shape[-2:]) == out_hw:
        return x
    y = F.interpolate(x.reshape((-1,) + tuple(x.shape[-3:])).float(), size=out_hw,
                      mode="bilinear", align_corners=False, antialias=antialias)
    return y.reshape(tuple(x.shape[:-2]) + out_hw).to(x.dtype)


def grid_sample_frames(
    maps: torch.Tensor, keypoints_xy: torch.Tensor, mode: str = "bilinear"
) -> torch.Tensor:
    """Per-frame sampling of maps (N, H, W, C) at keypoints (N, K, 2) in pixel
    (x, y) -> (N, K, C).

    Keypoints are normalised the reference way, with (size - 1), and sampled
    with align_corners=False semantics, so the effective coordinate is
    ((kp / (size-1) * 2 - 1 + 1) * size - 1) / 2 (slightly off-centre, kept
    on purpose). Bilinear clamps to the border; nearest rounds with
    floor(x + 0.5).
    """
    n, h, w, c = maps.shape
    kx = keypoints_xy[..., 0].to(maps.dtype)
    ky = keypoints_xy[..., 1].to(maps.dtype)
    px = ((kx / (w - 1) * 2.0 - 1.0 + 1.0) * w - 1.0) / 2.0
    py = ((ky / (h - 1) * 2.0 - 1.0 + 1.0) * h - 1.0) / 2.0
    flat = maps.reshape(n, h * w, c)

    def gather(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        idx = (yi * w + xi).unsqueeze(-1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    if mode == "nearest":
        xi = torch.floor(px + 0.5).clamp(0, w - 1).long()
        yi = torch.floor(py + 0.5).clamp(0, h - 1).long()
        return gather(yi, xi)
    if mode != "bilinear":
        raise ValueError(f"unknown sampling mode {mode!r}")
    x = px.clamp(0.0, w - 1.0)
    y = py.clamp(0.0, h - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)
    return (
        gather(y0, x0) * (1 - fy) * (1 - fx)
        + gather(y0, x1) * (1 - fy) * fx
        + gather(y1, x0) * fy * (1 - fx)
        + gather(y1, x1) * fy * fx
    )
