"""Token-grid -> dense-image rearrangement (pixel shuffle).

Port of ``pi3_slam_tpu/ops/pixel_shuffle.py``: per-token features laid out
channel-major (c * p^2 + i * p + j) scatter to an (H, W, C) image where token
(Y, X) fills pixels [Y*p:(Y+1)*p, X*p:(X+1)*p].
"""

from __future__ import annotations

import torch


def tokens_to_image(
    tokens: torch.Tensor, grid_hw: tuple[int, int], patch: int, channels: int
) -> torch.Tensor:
    """tokens (B, h*w, channels * patch**2) -> (B, h*patch, w*patch, channels)."""
    b, s, d = tokens.shape
    h, w = grid_hw
    if s != h * w or d != channels * patch * patch:
        raise ValueError(f"tokens {tuple(tokens.shape)} do not fit grid {h}x{w}, patch {patch}")
    x = tokens.reshape(b, h, w, channels, patch, patch)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, h, p_i, w, p_j, C)
    return x.reshape(b, h * patch, w * patch, channels)
