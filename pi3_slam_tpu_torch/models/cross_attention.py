"""Cross-attention block: the reference layer library's CrossAttentionRope /
CrossBlockRope, used by related visual-geometry models (Pi3 itself uses
self-attention only).

Port of ``pi3_slam_tpu/models/cross_attention.py``. Submodules carry the
names of the reference's CrossBlockRope state dict (``attn``,
``cross_attn.{q_proj,k_proj,v_proj,proj}``, ``norm1/2/3``, ``norm_y``,
``mlp.fc1/fc2``; LayerScale as the parameters ``ls1``, ``ls_y``, ``ls2``).
The self-attention is :func:`layers.attention`, so it takes the same kernels
as a ``Block`` (the packed route at head dim 64); the cross-attention runs
``ops.attention.sdpa`` over separate q, k and v projections, so on the card
it reaches the (B, T, H, D) attention kernels, and the MLP runs ``ops.mlp``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import sdpa
from ..ops.rope import apply_rope, rope_tables
from .layers import QK_NORM_EPS, Attention, attention, layer_norm, linear, mlp

Rope = tuple[torch.Tensor, torch.Tensor]
NORM_EPS = 1e-6  # the block norms' eps, as the JAX cross_block's default
ROPE_BASE = 100.0


class CrossAttention(nn.Module):
    """Separate q, k and v projections, the output projection and the
    optional per-head qk LayerNorm (eps 1e-5); run by :func:`cross_attention`."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False, device=None):
        super().__init__()
        kw = dict(device=device)
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim, **kw)
        self.k_proj = nn.Linear(dim, dim, **kw)
        self.v_proj = nn.Linear(dim, dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        head_dim = dim // num_heads
        self.q_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None
        self.k_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None


class Mlp(nn.Module):
    """fc1 / fc2 weights, run by :func:`layers.mlp`."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)


class CrossBlock(nn.Module):
    """Self-attention, cross-attention to the normed y, MLP: each pre-norm
    with a residual and optional LayerScale."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: int = 4,
        qk_norm: bool = False,
        layerscale: bool = False,
        device=None,
    ):
        super().__init__()
        kw = dict(device=device)
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=NORM_EPS, **kw)
        self.attn = Attention(dim, num_heads, qk_norm, **kw)
        self.ls1 = nn.Parameter(torch.ones(dim, **kw)) if layerscale else None
        self.norm2 = nn.LayerNorm(dim, eps=NORM_EPS, **kw)
        self.norm_y = nn.LayerNorm(dim, eps=NORM_EPS, **kw)
        self.cross_attn = CrossAttention(dim, num_heads, qk_norm, **kw)
        self.ls_y = nn.Parameter(torch.ones(dim, **kw)) if layerscale else None
        self.norm3 = nn.LayerNorm(dim, eps=NORM_EPS, **kw)
        self.mlp = Mlp(dim, dim * mlp_ratio, **kw)
        self.ls2 = nn.Parameter(torch.ones(dim, **kw)) if layerscale else None

    def forward(self, x, y, xpos: torch.Tensor | None = None, ypos: torch.Tensor | None = None):
        return cross_block(x, y, self, xpos, ypos)


def cross_attention(
    x: torch.Tensor,
    key_in: torch.Tensor,
    value_in: torch.Tensor,
    attn: CrossAttention,
    qrope: Rope | None = None,
    krope: Rope | None = None,
) -> torch.Tensor:
    """x (B, Tq, C) attends to key_in / value_in (B, Tk, C) -> (B, Tq, C);
    qrope / krope: (cos, sin) tables at the head dim for q and k, or None."""
    b, tq, c = x.shape
    h = attn.num_heads
    d = c // h
    q = linear(x, attn.q_proj.weight, attn.q_proj.bias).view(b, tq, h, d)
    k = linear(key_in, attn.k_proj.weight, attn.k_proj.bias).view(b, -1, h, d)
    v = linear(value_in, attn.v_proj.weight, attn.v_proj.bias).view(b, -1, h, d)
    if attn.q_norm is not None:
        q = layer_norm(q, attn.q_norm.weight, attn.q_norm.bias, attn.q_norm.eps)
        k = layer_norm(k, attn.k_norm.weight, attn.k_norm.bias, attn.k_norm.eps)
    if qrope is not None:
        q = apply_rope(q, *qrope)
    if krope is not None:
        k = apply_rope(k, *krope)
    out = sdpa(q, k, v).reshape(b, tq, c)
    return linear(out, attn.proj.weight, attn.proj.bias)


def cross_block(
    x: torch.Tensor,
    y: torch.Tensor,
    blk: CrossBlock,
    xpos: torch.Tensor | None = None,
    ypos: torch.Tensor | None = None,
) -> torch.Tensor:
    """x (B, Tx, C), y (B, Ty, C); xpos / ypos (B, T, 2) integer (y, x) RoPE
    positions of x and y, or None -> (B, Tx, C)."""
    d = x.shape[-1] // blk.num_heads
    xrope = None if xpos is None else rope_tables(xpos, d, ROPE_BASE)
    yrope = None if ypos is None else rope_tables(ypos, d, ROPE_BASE)

    def scaled(h: torch.Tensor, ls: torch.Tensor | None) -> torch.Tensor:
        return h if ls is None else h * ls.to(h.dtype)

    def norm(a: torch.Tensor, n: nn.LayerNorm) -> torch.Tensor:
        return layer_norm(a, n.weight, n.bias, NORM_EPS)

    h = attention(norm(x, blk.norm1), blk.attn, xrope)
    x = x + scaled(h, blk.ls1)
    y_n = norm(y, blk.norm_y)
    x = x + scaled(cross_attention(norm(x, blk.norm2), y_n, y_n, blk.cross_attn, xrope, yrope),
                   blk.ls_y)
    h = mlp(norm(x, blk.norm3), blk.mlp)
    return x + scaled(h, blk.ls2)
