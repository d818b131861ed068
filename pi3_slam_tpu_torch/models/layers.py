"""Transformer building blocks.

Port of ``pi3_slam_tpu/models/layers.py``. One pre-norm ``Block`` covers the
DINOv2 encoder block and Pi3's decoder / head blocks: optional LayerScale,
optional per-head qk LayerNorm (eps 1e-5), optional RoPE2D. Weights are
torch ``nn.Linear`` (out, in).

The attention and MLP halves go through the kernel wrappers of ``ops/``,
which dispatch by device only: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs its plain PyTorch version.

* encoder blocks (no qk-norm, no RoPE): the qkv projection is the packed
  attention input as it stands; the softmax scale rides the fp32 logits
  (``q_scale``).
* decoder / head blocks: the fused producer applies qk-norm, RoPE and the
  scale in one pass, then frame-local blocks run the single-pass entry point
  and the decoder's global blocks the flash entry point.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.block_mlp import block_mlp
from ..ops.packed_attention import attention_single_pass_packed, flash_attention_packed
from ..ops.qkv_producer import qkv_rope_producer

LOG2_E = math.log2(math.e)
QK_NORM_EPS = 1e-5


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps).to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """x @ weight^T + bias in x's dtype (weights cast like the JAX path)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


class Block(nn.Module):
    """Pre-norm block: x + ls1 * attn(norm1(x)); x + ls2 * mlp(norm2(x))."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: int = 4,
        qk_norm: bool = False,
        layerscale: bool = False,
        eps: float = 1e-6,
        device=None,
    ):
        super().__init__()
        kw = dict(device=device)
        self.num_heads = num_heads
        self.eps = eps
        self.norm1 = nn.LayerNorm(dim, eps=eps, **kw)
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        head_dim = dim // num_heads
        self.q_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None
        self.k_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None
        self.ls1 = nn.Parameter(torch.ones(dim, **kw)) if layerscale else None
        self.norm2 = nn.LayerNorm(dim, eps=eps, **kw)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio, **kw)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim, **kw)
        self.ls2 = nn.Parameter(torch.ones(dim, **kw)) if layerscale else None

    def forward(
        self,
        x: torch.Tensor,
        rope: tuple[torch.Tensor, torch.Tensor] | None = None,
        is_global: bool = False,
    ) -> torch.Tensor:
        """x (B, T, C); rope: (cos, sin) tables (B, T, 64) from
        ``ops.rope.rope_tables``, or None; is_global: the decoder's
        cross-frame block (flash entry point)."""
        h = attention(layer_norm(x, self.norm1.weight, self.norm1.bias, self.eps), self, rope, is_global)
        if self.ls1 is not None:
            h = h * self.ls1.to(h.dtype)
        x = x + h
        return block_mlp(
            x,
            self.norm2.weight,
            self.norm2.bias,
            self.fc1.weight,
            self.fc1.bias,
            self.fc2.weight,
            self.fc2.bias,
            ls=self.ls2,
            eps=self.eps,
        )


def attention(
    x: torch.Tensor,
    blk: Block,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    is_global: bool = False,
) -> torch.Tensor:
    """Self-attention of ``blk`` over x (B, T, C) -> (B, T, C)."""
    b, t, c = x.shape
    h = blk.num_heads
    d = c // h
    qkv = linear(x, blk.qkv.weight, blk.qkv.bias)
    if blk.q_norm is None and rope is None:
        out = attention_single_pass_packed(qkv, h, q_scale=d**-0.5 * LOG2_E)
    else:
        if rope is None:  # qk-norm without RoPE: identity rotation
            rope = (
                torch.ones((b, t, d), device=x.device),
                torch.zeros((b, t, d), device=x.device),
            )
        norm = {}
        if blk.q_norm is not None:
            norm = dict(
                q_norm_scale=blk.q_norm.weight,
                q_norm_bias=blk.q_norm.bias,
                k_norm_scale=blk.k_norm.weight,
                k_norm_bias=blk.k_norm.bias,
                eps=blk.q_norm.eps,
            )
        packed = qkv_rope_producer(qkv, rope[0], rope[1], h, t, **norm)
        attn = flash_attention_packed if is_global else attention_single_pass_packed
        out = attn(packed, h)
    return linear(out, blk.proj.weight, blk.proj.bias)
