"""MoGe v1 monocular geometry model (affine-invariant points, no metric scale).

Port of ``pi3_slam_tpu/models/moge_v1.py`` (a rebuild of microsoft/MoGe's
``moge/model/v1.py``). The SLAM pipeline runs MoGe-2; v1 checkpoints
(``Ruicheng/moge-vitl`` and its siblings) are part of the reference's model
zoo and convert with ``tools/convert_checkpoint.py --model moge``.

* The backbone is the port's ``DinoVisionTransformer`` (plain DINOv2: no
  registers, position-embedding offset 0.1, no antialias); its intermediate
  layers are each projected by a 1x1 convolution and summed.
* :class:`MoGeV1Head` holds its weights in ``moge/model/v1.py``'s naming
  (``projects``, ``upsample_blocks``, ``output_block``; residual blocks as
  ``layers.0-5``), so a reference state dict's ``head.*`` keys load as they
  are. Three upsample blocks: UV concat, ``ConvTranspose2d(k2, s2)`` (the JAX
  package lowers it to a 1x1 convolution and a pixel shuffle; the weights map
  across, ``models/convert.moge_v1_state_from_jax``), a replicate-padded 3x3
  convolution, residual blocks; then a bilinear resize to the resized image,
  UV concat, and one output block each for points (3 channels) and mask (1).
* :func:`moge_v1_forward` resizes the input bicubic-antialiased to the
  ``num_tokens`` resolution, normalises it, resizes it bilinear-antialiased
  to the 14-multiple grid, and resizes the outputs back in fp32 before the
  remap; :func:`moge_v1_infer` recovers focal and shift, projects the points
  from the depth and puts ``inf`` outside the mask.

Maps are NCHW inside (PyTorch's convolution layout); the outputs keep the JAX
layout: ``points`` (B, H, W, 3), ``mask`` (B, H, W). Everything computes in
fp32, the JAX default: the convolutions with TF32 off, and on the GPU the
encoder blocks through the fp32 entries of the hand-written packed-attention
and block-MLP kernels (``models/layers.attention``'s route without qk-norm or
RoPE). ``build_moge_v1(trunk_dtype=torch.bfloat16)`` holds the blocks in bf16
instead (their bf16 entries), a control, not the model's path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.focal import recover_focal_shift
from ..geometry.maps import normalized_view_plane_uv
from ..ops.interpolate import bicubic_resize, bilinear_resize
from .dinov2 import DinoV2Config, DinoVisionTransformer
from .moge_model import _BACKBONES, _image_normalization, conv2d, group_norm


@dataclass(frozen=True)
class MoGeV1Config:
    backbone: str = "dinov2_vitb14"
    intermediate_layers: Union[int, Tuple[int, ...]] = 4
    dim_proj: int = 512
    dim_upsample: Tuple[int, ...] = (256, 128, 128)
    dim_times_res_block_hidden: int = 1
    num_res_blocks: int = 1
    remap_output: str = "linear"
    res_block_norm: str = "group_norm"
    num_tokens_range: Tuple[int, int] = (1200, 2500)
    last_res_blocks: int = 0
    last_conv_channels: int = 32
    last_conv_size: int = 1
    mask_threshold: float = 0.5

    @property
    def encoder_cfg(self) -> DinoV2Config:
        bb = _BACKBONES[self.backbone]
        return DinoV2Config(embed_dim=bb["embed_dim"], depth=bb["depth"],
                            num_heads=bb["num_heads"], num_register_tokens=0,
                            interpolate_offset=0.1, interpolate_antialias=False)

    @property
    def layer_indices(self) -> Tuple[int, ...]:
        if isinstance(self.intermediate_layers, int):
            depth = _BACKBONES[self.backbone]["depth"]
            return tuple(range(depth - self.intermediate_layers, depth))
        return tuple(self.intermediate_layers)

    @classmethod
    def from_model_config(cls, mc: Dict[str, Any]) -> "MoGeV1Config":
        """A checkpoint's 'model_config' (or the '_v1_config_json' a converted
        file carries) -> MoGeV1Config: 'encoder' names the backbone, the legacy
        'trained_area_range' (pixels) becomes 'num_tokens_range', a bool
        'remap_output' means 'exp' or 'linear'; unknown keys are ignored."""
        mc = dict(mc)
        if "encoder" in mc:
            mc["backbone"] = mc.pop("encoder")
        if "trained_area_range" in mc:
            lo, hi = mc.pop("trained_area_range")
            mc["num_tokens_range"] = (lo // 14**2, hi // 14**2)
        kw = {k: v for k, v in mc.items() if k in cls.__dataclass_fields__}
        for key in ("dim_upsample", "num_tokens_range", "intermediate_layers"):
            if isinstance(kw.get(key), list):
                kw[key] = tuple(kw[key])
        if isinstance(kw.get("remap_output"), bool):
            kw["remap_output"] = "exp" if kw["remap_output"] else "linear"
        return cls(**kw)


def _norm(kind: str, channels: int) -> nn.Module:
    """v1's norms: 'group_norm' GroupNorm(c / 32), 'layer_norm' GroupNorm(1),
    'none' an Identity (no weights)."""
    if kind == "group_norm":
        return nn.GroupNorm(channels // 32, channels)
    if kind == "layer_norm":
        return nn.GroupNorm(1, channels)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unsupported norm: {kind}")


class ResidualConvBlock(nn.Module):
    """``layers`` = GroupNorm(1), ReLU, conv3x3, hidden norm, ReLU, conv3x3
    (replicate padding), added to the input (v1's blocks keep the width)."""

    def __init__(self, channels: int, hidden: int, norm: str):
        super().__init__()
        self.layers = nn.Sequential(
            nn.GroupNorm(1, channels), nn.ReLU(), nn.Conv2d(channels, hidden, 3),
            _norm(norm, hidden), nn.ReLU(), nn.Conv2d(hidden, channels, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm1, _, conv1, norm2, _, conv2 = self.layers
        h = conv2d(torch.relu(group_norm(x, norm1)), conv1)
        if isinstance(norm2, nn.GroupNorm):
            h = group_norm(h, norm2)
        return x + conv2d(torch.relu(h), conv2)


def _uv_concat(x: torch.Tensor, aspect_ratio: float) -> torch.Tensor:
    b, _, h, w = x.shape
    uv = normalized_view_plane_uv(w, h, aspect_ratio=aspect_ratio, dtype=x.dtype, device=x.device)
    return torch.cat([x, uv.permute(2, 0, 1)[None].expand(b, -1, -1, -1)], dim=1)


class MoGeV1Head(nn.Module):
    def __init__(self, cfg: MoGeV1Config):
        super().__init__()
        embed = cfg.encoder_cfg.embed_dim
        self.projects = nn.ModuleList(nn.Conv2d(embed, cfg.dim_proj, 1)
                                      for _ in cfg.layer_indices)
        ups = []
        for c_in, c_out in zip((cfg.dim_proj,) + tuple(cfg.dim_upsample[:-1]), cfg.dim_upsample):
            ups.append(nn.Sequential(
                nn.Sequential(nn.ConvTranspose2d(c_in + 2, c_out, 2, stride=2),
                              nn.Conv2d(c_out, c_out, 3)),
                *(ResidualConvBlock(c_out, cfg.dim_times_res_block_hidden * c_out,
                                    cfg.res_block_norm) for _ in range(cfg.num_res_blocks))))
        self.upsample_blocks = nn.ModuleList(ups)
        c_last = cfg.last_conv_channels
        self.output_block = nn.ModuleList(
            nn.Sequential(
                nn.Conv2d(cfg.dim_upsample[-1] + 2, c_last, 3),
                *(ResidualConvBlock(c_last, cfg.dim_times_res_block_hidden * c_last,
                                    cfg.res_block_norm) for _ in range(cfg.last_res_blocks)),
                nn.ReLU(),
                nn.Conv2d(c_last, c_out, cfg.last_conv_size))
            for c_out in (3, 1))

    def forward(self, features: List[Tuple[torch.Tensor, torch.Tensor]], grid_hw: Tuple[int, int],
                image_hw: Tuple[int, int]) -> List[torch.Tensor]:
        """features [(patch tokens (B, h*w, C), cls token)] -> [points (B, 3,
        H, W), mask (B, 1, H, W)] at image_hw, fp32."""
        hp, wp = grid_hw
        ar = image_hw[1] / image_hw[0]
        x = None
        for (tokens, _), proj in zip(features, self.projects):
            f = conv2d(tokens.float().reshape(tokens.shape[0], hp, wp, -1).permute(0, 3, 1, 2),
                       proj)
            x = f if x is None else x + f
        for blk in self.upsample_blocks:
            deconv, conv = blk[0]
            x = F.conv_transpose2d(_uv_concat(x, ar), deconv.weight, deconv.bias, stride=2)
            x = conv2d(x, conv)
            for rb in list(blk)[1:]:
                x = rb(x)
        x = _uv_concat(bilinear_resize(x, image_hw), ar)
        outputs = []
        for ob in self.output_block:
            y = conv2d(x, ob[0])
            for rb in list(ob)[1:-2]:
                y = rb(y)
            outputs.append(conv2d(torch.relu(y), ob[-1]))
        return outputs


class MoGeV1(nn.Module):
    """The backbone and the head; run by :func:`moge_v1_forward`."""

    def __init__(self, cfg: MoGeV1Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = DinoVisionTransformer(cfg.encoder_cfg, device=device)
        self.head = MoGeV1Head(cfg).to(device)


def _remap_points(points: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("linear", "none"):
        return points
    if kind == "sinh":
        return torch.sinh(points)
    if kind == "exp":
        xy, z = points[..., :2], torch.exp(points[..., 2:])
        return torch.cat([xy * z, z], dim=-1)
    if kind == "sinh_exp":
        return torch.cat([torch.sinh(points[..., :2]), torch.exp(points[..., 2:])], dim=-1)
    raise ValueError(f"invalid remap_output: {kind}")


def moge_v1_forward(model: MoGeV1, image: torch.Tensor, num_tokens: int) -> Dict[str, torch.Tensor]:
    """image (B, 3, H, W) in [0, 1] -> {'points': (B, H, W, 3), 'mask': (B, H,
    W)}, fp32; the mask is the raw score, before the threshold (v1's forward)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=False):
        cfg = model.cfg
        image = image.float()
        B, _, H, W = image.shape
        resize_factor = ((num_tokens * 14**2) / (H * W)) ** 0.5
        rh, rw = int(H * resize_factor), int(W * resize_factor)
        img = bicubic_resize(image, (rh, rw), antialias=True)
        mean, std = _image_normalization(image.device)
        hp, wp = rh // 14, rw // 14
        img14 = bilinear_resize((img - mean) / std, (hp * 14, wp * 14), antialias=True)
        features = model.backbone.intermediate_layers(img14, list(cfg.layer_indices))
        points, mask = model.head(features, (hp, wp), (rh, rw))
        points = bilinear_resize(points, (H, W)).permute(0, 2, 3, 1)
        mask = bilinear_resize(mask, (H, W))[:, 0]
        return {"points": _remap_points(points, cfg.remap_output), "mask": mask}


def moge_v1_infer(model: MoGeV1, image: torch.Tensor, num_tokens: int | None = None
                  ) -> Dict[str, torch.Tensor]:
    """(3, H, W) or (B, 3, H, W) in [0, 1] -> 'points' (force-projected from
    the depth), 'depth', 'intrinsics' (normalised, centre 0.5), 'mask' (the
    score above ``mask_threshold``); points and depth are ``inf`` outside the
    mask. Affine-invariant: v1 has no metric scale head."""
    if num_tokens is None:
        num_tokens = model.cfg.num_tokens_range[1]
    squeeze = image.dim() == 3
    out = moge_v1_forward(model, image[None] if squeeze else image, num_tokens)
    result = moge_v1_postprocess(model.cfg, out)
    return {k: v[0] for k, v in result.items()} if squeeze else result


def moge_v1_postprocess(cfg: MoGeV1Config, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """:func:`moge_v1_infer`'s steps after the forward, on
    :func:`moge_v1_forward`'s outputs (B, H, W, ...)."""
    points = out["points"]
    H, W = points.shape[1:3]
    ar = W / H
    mask = out["mask"] > cfg.mask_threshold
    focal, shift = recover_focal_shift(points, mask)
    fx = focal / 2 * (1 + ar**2) ** 0.5 / ar
    fy = focal / 2 * (1 + ar**2) ** 0.5
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    intrinsics = torch.stack([torch.stack([fx, z, 0.5 * o], -1), torch.stack([z, fy, 0.5 * o], -1),
                              torch.stack([z, z, o], -1)], dim=-2)
    depth = points[..., 2] + shift[:, None, None]
    uv = normalized_view_plane_uv(W, H, aspect_ratio=ar, device=points.device)
    xy = uv[None] / focal[:, None, None, None] * depth[..., None]
    inf = torch.full_like(depth, torch.inf)
    return {
        "points": torch.where(mask[..., None], torch.cat([xy, depth[..., None]], dim=-1),
                              inf[..., None]),
        "depth": torch.where(mask, depth, inf),
        "intrinsics": intrinsics,
        "mask": mask,
    }
