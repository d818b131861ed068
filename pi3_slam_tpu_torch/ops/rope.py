"""2D rotary position embedding (RoPE2D).

Port of ``pi3_slam_tpu/ops/rope.py``. The head dim D splits into a y half and
an x half; within each half, GPT-NeoX style pairs (i, i + D/4) rotate by
angle pos * base**(-2i/(D/2)). ``rope_tables`` gives the per-token cos/sin
in head-dim lane order, which the fused qkv producer (ops/qkv_producer.py)
consumes; ``rope_2d`` applies the same tables to a (B, T, H, D) tensor.
"""

from __future__ import annotations

import torch


def rope_tables(
    positions: torch.Tensor, d: int, base: float = 100.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (B, T, 2) integer (y, x) -> (cos, sin), each (B, T, d) fp32
    in lane order [c_y | c_y | c_x | c_x] with quarters of d // 4."""
    dh = d // 2
    inv_freq = 1.0 / (
        base ** (torch.arange(0, dh, 2, dtype=torch.float32, device=positions.device) / dh)
    )
    ay = positions[..., 0, None].float() * inv_freq
    ax = positions[..., 1, None].float() * inv_freq
    cos = torch.cat([ay.cos(), ay.cos(), ax.cos(), ax.cos()], dim=-1)
    sin = torch.cat([ay.sin(), ay.sin(), ax.sin(), ax.sin()], dim=-1)
    return cos, sin


def rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """The rotation's partner term: [-x2 | x1] within each half of the head
    dim (x1, x2 the half's two D/4-wide quarters). (..., D) -> (..., D)."""
    d = x.shape[-1]
    q = d // 4
    x = x.unflatten(-1, (2, 2, q))  # (half, pair, lane)
    return torch.stack([-x[..., 1, :], x[..., 0, :]], dim=-2).flatten(-3)


def rope_2d(x: torch.Tensor, positions: torch.Tensor, base: float = 100.0) -> torch.Tensor:
    """Apply 2D RoPE to x (B, T, H, D) at positions (B, T, 2) (y, x), in fp32.
    Special tokens at position (0, 0) get the identity rotation."""
    cos, sin = rope_tables(positions, x.shape[-1], base)
    x32 = x.float()
    return (x32 * cos[:, :, None] + rotate_pairs(x32) * sin[:, :, None]).to(x.dtype)


def make_patch_positions(
    batch: int, h: int, w: int, num_special: int = 0, offset: int = 0, device=None
) -> torch.Tensor:
    """(batch, num_special + h*w, 2) int32 (y, x) positions, y-major raster;
    patch positions shifted by ``offset`` and ``num_special`` leading (0, 0)
    rows (the Pi3 register-token convention)."""
    ys = torch.arange(h, dtype=torch.int32, device=device)
    xs = torch.arange(w, dtype=torch.int32, device=device)
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(h * w, 2)
    grid = grid + offset
    if num_special:
        zeros = torch.zeros((num_special, 2), dtype=torch.int32, device=device)
        grid = torch.cat([zeros, grid], dim=0)
    return grid[None].expand(batch, grid.shape[0], 2)
