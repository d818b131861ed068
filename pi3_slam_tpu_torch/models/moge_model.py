"""MoGe-2 metric monocular depth model.

Port of ``pi3_slam_tpu/models/moge_model.py`` (a rebuild of microsoft/MoGe
v2): DINOv2 encoder (intermediate layers, 1x1 projections, summed), a
UV-concatenated multi-scale pyramid, the shared ConvStack neck, points /
mask / normal ConvStack heads, and the exp scale head on the cls token;
:func:`moge_infer_depth` recovers focal and shift and returns metric depth.

Inside, maps are NCHW (PyTorch's convolution layout; the JAX package ran
NHWC); the public outputs keep the JAX layout: ``points`` (B, H, W, 3),
``mask`` (B, H, W), ``normal`` (B, H, W, 3), ``metric_scale`` (B,). The
convolutions run in fp32 with TF32 off (cuDNN's default would be TF32). The
encoder blocks run in the dtype they are held in (fp32 as the creator builds
them, as the JAX runner computes; on the GPU through the fp32 entries of the
hand-written attention and block-MLP kernels); the patch embedding, the
neck, the heads and the scale head stay fp32.

The model configuration travels with a converted checkpoint (JSON inside the
npz), so any MoGe-2 variant (ViT-S / B / L) loads without code changes.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.focal import recover_focal_shift
from ..geometry.maps import normalized_view_plane_uv
from ..ops.interpolate import bilinear_resize
from .dinov2 import DinoV2Config, DinoVisionTransformer

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)

_BACKBONES = {
    "dinov2_vits14": dict(embed_dim=384, depth=12, num_heads=6),
    "dinov2_vitb14": dict(embed_dim=768, depth=12, num_heads=12),
    "dinov2_vitl14": dict(embed_dim=1024, depth=24, num_heads=16),
}


@dataclasses.dataclass(frozen=True)
class ConvStackConfig:
    dim_in: Tuple[Optional[int], ...]
    dim_res_blocks: Tuple[int, ...]
    dim_out: Tuple[Optional[int], ...]
    resamplers: Tuple[str, ...] | str = "pixel_shuffle"
    dim_times_res_block_hidden: int = 1
    num_res_blocks: Any = 1
    res_block_in_norm: str = "layer_norm"
    res_block_hidden_norm: str = "group_norm"

    def num_blocks_at(self, level: int) -> int:
        if isinstance(self.num_res_blocks, (list, tuple)):
            return self.num_res_blocks[level]
        return self.num_res_blocks

    def resampler_at(self, level: int) -> str:
        if isinstance(self.resamplers, (list, tuple)):
            return self.resamplers[level]
        return self.resamplers


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    backbone: str
    intermediate_layers: Any  # int or list
    encoder_dim_out: int
    neck: ConvStackConfig
    points_head: Optional[ConvStackConfig]
    mask_head: Optional[ConvStackConfig]
    normal_head: Optional[ConvStackConfig]
    scale_head_dims: Optional[Tuple[int, ...]]
    remap_output: str = "linear"
    num_tokens_range: Tuple[int, int] = (1200, 3600)

    @property
    def encoder_cfg(self) -> DinoV2Config:
        bb = _BACKBONES[self.backbone]
        # plain (non-reg) dinov2: no registers, offset-0.1 bicubic interpolation
        return DinoV2Config(
            embed_dim=bb["embed_dim"],
            depth=bb["depth"],
            num_heads=bb["num_heads"],
            num_register_tokens=0,
            interpolate_offset=0.1,
            interpolate_antialias=False,
        )

    @property
    def num_projections(self) -> int:
        n = self.intermediate_layers
        return n if isinstance(n, int) else len(n)

    def to_json(self) -> str:
        def cs(c):
            return None if c is None else dataclasses.asdict(c)

        return json.dumps(
            {
                "backbone": self.backbone,
                "intermediate_layers": self.intermediate_layers,
                "encoder_dim_out": self.encoder_dim_out,
                "neck": cs(self.neck),
                "points_head": cs(self.points_head),
                "mask_head": cs(self.mask_head),
                "normal_head": cs(self.normal_head),
                "scale_head_dims": self.scale_head_dims,
                "remap_output": self.remap_output,
                "num_tokens_range": self.num_tokens_range,
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "MoGeConfig":
        d = json.loads(s)

        def cs(x):
            if x is None:
                return None
            x = dict(x)
            for key in ("dim_in", "dim_res_blocks", "dim_out"):
                x[key] = tuple(x[key])
            if isinstance(x.get("resamplers"), list):
                x["resamplers"] = tuple(x["resamplers"])
            return ConvStackConfig(**x)

        return cls(
            backbone=d["backbone"],
            intermediate_layers=d["intermediate_layers"],
            encoder_dim_out=d["encoder_dim_out"],
            neck=cs(d["neck"]),
            points_head=cs(d["points_head"]),
            mask_head=cs(d["mask_head"]),
            normal_head=cs(d["normal_head"]),
            scale_head_dims=None if d["scale_head_dims"] is None else tuple(d["scale_head_dims"]),
            remap_output=d["remap_output"],
            num_tokens_range=tuple(d["num_tokens_range"]),
        )

    @classmethod
    def from_params(cls, params: Dict[str, Any]) -> "MoGeConfig":
        cfg_str = params.get("_config_json")
        if cfg_str is None:
            raise ValueError("converted MoGe params missing _config_json")
        s = cfg_str if isinstance(cfg_str, str) else str(np.asarray(cfg_str).item())
        return cls.from_json(s)


# ----- primitive NCHW ops -----


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Stride-1 convolution with torch's replicate padding for odd kernels
    (MoGe's ``padding_mode='replicate'``); 1x1 kernels take no padding."""
    kh, kw = conv.kernel_size
    if kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    return F.conv2d(x, conv.weight, conv.bias)


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm over (C/G, H, W) per group, in fp32, cast back.

    Not ``F.group_norm``: its CUDA kernel reduces each (sample, group) row in
    one thread block, and MoGe's high-resolution levels have a single group
    (the 'layer_norm' in-norm, and C/32 = 1 at 32 channels), so one block
    would walk 29 M values per norm at 832 x 1088. ``var_mean`` spreads a row
    over the whole card."""
    b, c = x.shape[:2]
    x32 = x.float().reshape(b, norm.num_groups, -1)
    var, mean = torch.var_mean(x32, dim=-1, correction=0, keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + norm.eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return (y * norm.weight.float().reshape(shape) + norm.bias.float().reshape(shape)).to(x.dtype)


# ----- ConvStack -----


def _norm(kind: str, channels: int, device) -> nn.GroupNorm | None:
    if kind == "group_norm":
        return nn.GroupNorm(channels // 32, channels, device=device)
    if kind == "layer_norm":
        return nn.GroupNorm(1, channels, device=device)
    if kind == "none":
        return None
    raise ValueError(f"unsupported norm: {kind}")


class ResidualConvBlock(nn.Module):
    """x + conv3x3(ReLU(norm(conv3x3(ReLU(norm(x)))))); MoGe's ConvStack keeps
    the width, so the skip is the identity."""

    def __init__(self, channels: int, hidden: int, cfg: ConvStackConfig, device=None):
        super().__init__()
        self.norm1 = _norm(cfg.res_block_in_norm, channels, device)
        self.conv1 = nn.Conv2d(channels, hidden, 3, device=device)
        self.norm2 = _norm(cfg.res_block_hidden_norm, hidden, device)
        self.conv2 = nn.Conv2d(hidden, channels, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.norm1 is None else group_norm(x, self.norm1)
        h = conv2d(torch.relu(h), self.conv1)
        if self.norm2 is not None:
            h = group_norm(h, self.norm2)
        return x + conv2d(torch.relu(h), self.conv2)


class Resampler(nn.Module):
    """2x pixel-shuffle upsampler: conv3x3 to 4x the output width, pixel
    shuffle in torch's channel-major (c, i, j) order, conv3x3."""

    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, 4 * c_out, 3, device=device)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(F.pixel_shuffle(conv2d(x, self.conv1), 2), self.conv2)


class ConvStack(nn.Module):
    """Per level: input 1x1 conv, add to the upsampled running map, residual
    blocks, output 1x1 conv; then upsample into the next level."""

    def __init__(self, cfg: ConvStackConfig, device=None):
        super().__init__()
        dims = cfg.dim_res_blocks
        for level in range(len(dims) - 1):
            if cfg.resampler_at(level) != "pixel_shuffle":
                raise ValueError("only pixel_shuffle resamplers are used by MoGe-2")
        self.input_blocks = nn.ModuleList(
            nn.Identity() if c_in is None else nn.Conv2d(c_in, c, 1, device=device)
            for c_in, c in zip(cfg.dim_in, dims)
        )
        self.res_blocks = nn.ModuleList(
            nn.ModuleList(
                ResidualConvBlock(c, cfg.dim_times_res_block_hidden * c, cfg, device)
                for _ in range(cfg.num_blocks_at(level))
            )
            for level, c in enumerate(dims)
        )
        self.resamplers = nn.ModuleList(
            Resampler(c_prev, c_next, device) for c_prev, c_next in zip(dims[:-1], dims[1:])
        )
        self.output_blocks = nn.ModuleList(
            nn.Identity() if c_out is None else nn.Conv2d(c, c_out, 1, device=device)
            for c_out, c in zip(cfg.dim_out, dims)
        )

    def forward(self, in_features: List[torch.Tensor | None]) -> List[torch.Tensor]:
        out_features = []
        x = None
        for level, (inp, blocks, out) in enumerate(
            zip(self.input_blocks, self.res_blocks, self.output_blocks)
        ):
            feature = in_features[level]
            if feature is not None and isinstance(inp, nn.Conv2d):
                feature = conv2d(feature, inp)
            if level == 0:
                x = feature
            elif feature is not None:
                x = x + feature
            for blk in blocks:
                x = blk(x)
            out_features.append(conv2d(x, out) if isinstance(out, nn.Conv2d) else x)
            if level < len(self.resamplers):
                x = self.resamplers[level](x)
        return out_features


# ----- MoGe forward / infer -----


@functools.cache
def _image_normalization(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """IMAGE_MEAN and IMAGE_STD as (1, 3, 1, 1) tensors on ``device``, made
    once: a host-to-device copy waits for the stream, and the forward is
    queued behind the Pi3 chunk step without waiting for it."""
    return (torch.tensor(IMAGE_MEAN, device=device).reshape(1, 3, 1, 1),
            torch.tensor(IMAGE_STD, device=device).reshape(1, 3, 1, 1))


class MoGe(nn.Module):
    def __init__(self, cfg: MoGeConfig, device=None):
        super().__init__()
        self.cfg = cfg
        enc = cfg.encoder_cfg
        self.backbone = DinoVisionTransformer(enc, device=device)
        self.output_projections = nn.ModuleList(
            nn.Conv2d(enc.embed_dim, cfg.encoder_dim_out, 1, device=device)
            for _ in range(cfg.num_projections)
        )
        self.neck = ConvStack(cfg.neck, device)
        for head in ("points_head", "mask_head", "normal_head"):
            head_cfg = getattr(cfg, head)
            setattr(self, head, None if head_cfg is None else ConvStack(head_cfg, device))
        dims = cfg.scale_head_dims
        self.scale_head = None if dims is None else nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, image: torch.Tensor, num_tokens: int) -> Dict[str, torch.Tensor]:
        """image (B, 3, H, W) in [0, 1] -> 'points' (B, H, W, 3), 'mask'
        (B, H, W), 'normal' (B, H, W, 3), 'metric_scale' (B,), as the config
        has them; fp32."""
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            return self._forward(image.float(), num_tokens)

    def _forward(self, image: torch.Tensor, num_tokens: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, _, H, W = image.shape
        ar = W / H
        base_h = int((num_tokens / ar) ** 0.5)
        base_w = int((num_tokens * ar) ** 0.5)
        dev = image.device

        img14 = bilinear_resize(image, (base_h * 14, base_w * 14), antialias=True)
        mean, std = _image_normalization(dev)
        layers = self.backbone.intermediate_layers((img14 - mean) / std, cfg.intermediate_layers)
        cls_token = layers[-1][1].float()

        feat = None
        for (tokens, _), proj in zip(layers, self.output_projections):
            fmap = tokens.float().reshape(B, base_h, base_w, -1).permute(0, 3, 1, 2)
            f = conv2d(fmap, proj)
            feat = f if feat is None else feat + f

        # multi-scale inputs: level 0 = features + uv, levels 1.. = uv only
        in_features: List[torch.Tensor] = []
        for level in range(len(cfg.neck.dim_res_blocks)):
            uv = normalized_view_plane_uv(base_w * 2**level, base_h * 2**level, aspect_ratio=ar,
                                          device=dev)
            uv = uv.permute(2, 0, 1)[None].expand(B, -1, -1, -1)
            in_features.append(torch.cat([feat, uv], dim=1) if level == 0 else uv)
        neck_out = self.neck(in_features)

        def head(stack: ConvStack) -> torch.Tensor:  # -> (B, H, W, C) at the input size
            return bilinear_resize(stack(neck_out)[-1], (H, W)).permute(0, 2, 3, 1)

        result: Dict[str, torch.Tensor] = {}
        if self.points_head is not None:
            pts = head(self.points_head)
            if cfg.remap_output == "exp":
                xy, z = pts[..., :2], pts[..., 2:]
                z = torch.exp(z)
                pts = torch.cat([xy * z, z], dim=-1)
            elif cfg.remap_output == "sinh":
                pts = torch.sinh(pts)
            elif cfg.remap_output == "sinh_exp":
                pts = torch.cat([torch.sinh(pts[..., :2]), torch.exp(pts[..., 2:])], dim=-1)
            result["points"] = pts
        if self.mask_head is not None:
            result["mask"] = torch.sigmoid(head(self.mask_head)[..., 0])
        if self.normal_head is not None:
            nrm = head(self.normal_head)
            result["normal"] = nrm / nrm.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        if self.scale_head is not None:
            h = cls_token
            for i, lin in enumerate(self.scale_head):
                h = F.linear(h, lin.weight, lin.bias)
                if i < len(self.scale_head) - 1:
                    h = torch.relu(h)
            result["metric_scale"] = torch.exp(h[..., 0])
        return result


def moge_infer_depth(model: MoGe, image: torch.Tensor, num_tokens: int | None = None) -> torch.Tensor:
    """(3, H, W) [0, 1] -> (H, W) metric depth, inf outside the validity mask
    (MoGe's infer with the defaults the SLAM pipeline uses: the most tokens of
    the range, mask applied)."""
    if num_tokens is None:
        num_tokens = model.cfg.num_tokens_range[1]
    out = model(image[None], num_tokens)
    points = out["points"][0]
    mask = out.get("mask")
    valid = mask[0] > 0.5 if mask is not None else torch.ones(points.shape[:2], dtype=torch.bool,
                                                              device=points.device)
    _, shift = recover_focal_shift(points[None], valid[None])
    depth = points[..., 2] + shift[0]
    valid = valid & (depth > 0)
    if "metric_scale" in out:
        depth = depth * out["metric_scale"][0]
    return torch.where(valid, depth, torch.full_like(depth, torch.inf))
