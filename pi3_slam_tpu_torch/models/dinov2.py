"""DINOv2 ViT encoder (dinov2_vitl14_reg as used by Pi3).

Port of ``pi3_slam_tpu/models/dinov2.py``: patch embedding as patchify +
linear (the stride-14 convolution's math), cls + register tokens, the
antialiased bicubic position-embedding interpolation, the block stack as an
``nn.ModuleList``, and the final LayerNorm; ``intermediate_layers`` serves
MoGe-2 (plain ``dinov2_vits14``: no registers, offset 0.1, no antialias).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.interpolate import interpolate_pos_embed
from .layers import Block, apply_linear, layer_norm


@dataclass(frozen=True)
class DinoV2Config:
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    num_register_tokens: int = 4
    pos_embed_size: int = 37  # 518 // 14
    norm_eps: float = 1e-6
    interpolate_offset: float = 0.0
    interpolate_antialias: bool = True


VIT_LARGE = DinoV2Config()


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, 3, H, W) -> (B, h*w, 3*patch*patch) tokens, y-major raster, per-token
    feature order (channel, py, px) like torch Conv2d weight flattening."""
    b, c, H, W = images.shape
    h, w = H // patch, W // patch
    x = images.reshape(b, c, h, patch, w, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, h * w, c * patch * patch)


class DinoVisionTransformer(nn.Module):
    def __init__(self, cfg: DinoV2Config = VIT_LARGE, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg.embed_dim
        kw = dict(device=device)
        self.patch_embed = nn.Linear(3 * cfg.patch_size**2, c, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, c, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.pos_embed_size**2 + 1, c, **kw))
        self.register_tokens = nn.Parameter(torch.zeros(cfg.num_register_tokens, c, **kw))
        self.blocks = nn.ModuleList(
            Block(c, cfg.num_heads, cfg.mlp_ratio, layerscale=True, eps=cfg.norm_eps, **kw)
            for _ in range(cfg.depth)
        )
        self.norm = nn.LayerNorm(c, eps=cfg.norm_eps, **kw)

    def _embed(self, images: torch.Tensor) -> torch.Tensor:
        """Patch tokens, cls, position embedding and registers, computed in the
        patch embedding's dtype and handed to the blocks in theirs (MoGe-2
        keeps its patch embedding in fp32, its blocks in ``trunk_dtype``)."""
        cfg = self.cfg
        dtype = self.patch_embed.weight.dtype
        p = cfg.patch_size
        b, _, H, W = images.shape
        tokens = apply_linear(patchify(images.to(dtype), p), self.patch_embed)
        cls = self.cls_token.to(dtype).expand(b, 1, cfg.embed_dim)
        x = torch.cat([cls, tokens], dim=1)
        pos = self.pos_embed.float()
        patch_pos = interpolate_pos_embed(
            pos[1:], (H // p, W // p), cfg.interpolate_offset, cfg.interpolate_antialias
        )
        x = x + torch.cat([pos[:1], patch_pos], dim=0).to(dtype)[None]
        r = cfg.num_register_tokens
        if r:
            reg = self.register_tokens.to(dtype).expand(b, r, cfg.embed_dim)
            x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
        return x.to(self.blocks[0].qkv.weight.dtype)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """Encode (B, 3, H, W) model-normalised images.

        Returns 'cls_token' (B, C), 'register_tokens' (B, R, C) and
        'patch_tokens' (B, h*w, C), all after the final norm.
        """
        x = self._embed(images)
        for blk in self.blocks:
            x = blk(x)
        x = layer_norm(x, self.norm.weight, self.norm.bias, self.cfg.norm_eps)
        r = self.cfg.num_register_tokens
        return {
            "cls_token": x[:, 0],
            "register_tokens": x[:, 1 : r + 1],
            "patch_tokens": x[:, r + 1 :],
        }

    def intermediate_layers(self, images: torch.Tensor, n) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """DINOv2 ``get_intermediate_layers``: the outputs of the selected
        blocks, each through the final norm, as [(patch_tokens (B, h*w, C),
        cls_token (B, C)), ...]. n: the last n blocks, or a list of indices."""
        depth = len(self.blocks)
        indices = list(range(depth - n, depth)) if isinstance(n, int) else list(n)
        x = self._embed(images)
        outs = {}
        for i, blk in enumerate(self.blocks[: max(indices) + 1]):
            x = blk(x)
            if i in indices:
                outs[i] = layer_norm(x, self.norm.weight, self.norm.bias, self.cfg.norm_eps)
        r = self.cfg.num_register_tokens
        return [(outs[i][:, r + 1 :], outs[i][:, 0]) for i in indices]
