"""Plain MoGe-2: metric monocular depth on one frame, in plain PyTorch.

The benchmark's reference for the port's ``models/moge_model.py`` and
``models/moge.py`` (MoGe-2, Wang et al. 2025, github.com/microsoft/MoGe): a
plain DINOv2 trunk (the ``Encoder`` of ``pi3.py``), the summed 1x1
projections of its last blocks, the UV pyramid, the ConvStack neck and the
points and mask heads, the exp scale head on the cls token, then the focal
and shift solve of ``focal.py`` and the metric depth the chunk creator uses.
Everything runs in float32 with TF32 off, as the configuration states;
``Precision(fp8=True)`` (the control) runs it in TF32, the precision below.
The modules carry the port's parameter names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .focal import normalized_view_plane_uv, recover_focal_shift
from .pi3 import IMAGE_MEAN, IMAGE_STD, Encoder, Precision, allow_tf32


def conv2d(x, conv: nn.Conv2d):
    """Stride-1 convolution, replicate padding for odd kernels above 1x1."""
    kh, kw = conv.kernel_size
    if kh > 1 or kw > 1:
        x = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode="replicate")
    return F.conv2d(x, conv.weight, conv.bias)


def group_norm(x, norm: nn.GroupNorm):
    return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)


def _norm(kind: str, channels: int):
    if kind == "none":
        return None
    groups = 1 if kind == "layer_norm" else channels // 32
    return nn.GroupNorm(groups, channels, device="meta")


class ResidualConvBlock(nn.Module):
    def __init__(self, c: int, hidden: int, stack: dict):
        super().__init__()
        self.norm1 = _norm(stack.get("res_block_in_norm", "layer_norm"), c)
        self.conv1 = nn.Conv2d(c, hidden, 3, device="meta")
        self.norm2 = _norm(stack.get("res_block_hidden_norm", "group_norm"), hidden)
        self.conv2 = nn.Conv2d(hidden, c, 3, device="meta")

    def forward(self, x):
        h = x if self.norm1 is None else group_norm(x, self.norm1)
        h = conv2d(torch.relu(h), self.conv1)
        if self.norm2 is not None:
            h = group_norm(h, self.norm2)
        return x + conv2d(torch.relu(h), self.conv2)


class Resampler(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, 4 * c_out, 3, device="meta")
        self.conv2 = nn.Conv2d(c_out, c_out, 3, device="meta")

    def forward(self, x):
        return conv2d(F.pixel_shuffle(conv2d(x, self.conv1), 2), self.conv2)


class ConvStack(nn.Module):
    def __init__(self, stack: dict):
        super().__init__()
        dims = stack["dim_res_blocks"]
        mult = stack.get("dim_times_res_block_hidden", 1)
        blocks = stack.get("num_res_blocks", 1)
        self.input_blocks = nn.ModuleList(
            nn.Identity() if c_in is None else nn.Conv2d(c_in, c, 1, device="meta")
            for c_in, c in zip(stack["dim_in"], dims))
        self.res_blocks = nn.ModuleList(
            nn.ModuleList(ResidualConvBlock(c, mult * c, stack)
                          for _ in range(blocks[i] if isinstance(blocks, list) else blocks))
            for i, c in enumerate(dims))
        self.resamplers = nn.ModuleList(Resampler(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.output_blocks = nn.ModuleList(
            nn.Identity() if c_out is None else nn.Conv2d(c, c_out, 1, device="meta")
            for c_out, c in zip(stack["dim_out"], dims))

    def forward(self, features):
        outs, x = [], None
        for level, (inp, blocks, out) in enumerate(
                zip(self.input_blocks, self.res_blocks, self.output_blocks)):
            f = features[level]
            if f is not None and isinstance(inp, nn.Conv2d):
                f = conv2d(f, inp)
            x = f if level == 0 else (x + f if f is not None else x)
            for blk in blocks:
                x = blk(x)
            outs.append(conv2d(x, out) if isinstance(out, nn.Conv2d) else x)
            if level < len(self.resamplers):
                x = self.resamplers[level](x)
        return outs


def encoder_config(moge: dict) -> dict:
    """The plain DINOv2 of MoGe-2: no registers, the offset-0.1 bicubic
    position-embedding interpolation without antialias."""
    return dict(moge["encoder"], patch_size=14, num_register_tokens=0, pos_embed_size=37,
                norm_eps=1e-6, interpolate_offset=0.1, interpolate_antialias=False)


class MoGe(nn.Module):
    """``moge``: the configuration file's ``metric_depth`` model."""

    def __init__(self, moge: dict):
        super().__init__()
        self.cfg = moge
        enc = encoder_config(moge)
        self.backbone = Encoder(enc)
        self.output_projections = nn.ModuleList(
            nn.Conv2d(enc["embed_dim"], moge["encoder_dim_out"], 1, device="meta")
            for _ in range(moge["intermediate_layers"]))
        self.neck = ConvStack(moge["neck"])
        self.points_head = ConvStack(moge["points_head"])
        self.mask_head = ConvStack(moge["mask_head"])
        dims = moge["scale_head_dims"]
        self.scale_head = nn.ModuleList(nn.Linear(a, b, device="meta")
                                        for a, b in zip(dims[:-1], dims[1:]))

    @torch.no_grad()
    def depth(self, image_u8, prec: Precision | None = None):
        """(3, H, W) uint8 -> (H, W) metric depth, inf outside the mask."""
        return self.infer(image_u8, prec)["depth"]

    @torch.no_grad()
    def infer(self, image_u8, prec: Precision | None = None) -> dict:
        """(3, H, W) uint8 -> the model's points (H, W, 3), mask (H, W) and
        metric_scale, and the metric depth (H, W), inf outside the mask."""
        with allow_tf32(prec is not None and prec.fp8):
            return self._infer(image_u8.float()[None] / 255.0)

    def _infer(self, image):
        cfg = self.cfg
        _, _, H, W = image.shape
        ar = W / H
        n = cfg["num_tokens_range"][1]
        bh, bw = int((n / ar) ** 0.5), int((n * ar) ** 0.5)
        img14 = F.interpolate(image, size=(bh * 14, bw * 14), mode="bilinear",
                              align_corners=False, antialias=True)
        mean = torch.tensor(IMAGE_MEAN, device=image.device).reshape(1, 3, 1, 1)
        std = torch.tensor(IMAGE_STD, device=image.device).reshape(1, 3, 1, 1)
        layers = self.backbone.intermediate_layers((img14 - mean) / std,
                                                   cfg["intermediate_layers"])
        feat = None
        for (tokens, _), proj in zip(layers, self.output_projections):
            f = conv2d(tokens.reshape(1, bh, bw, -1).permute(0, 3, 1, 2), proj)
            feat = f if feat is None else feat + f
        features = []
        for level in range(len(cfg["neck"]["dim_res_blocks"])):
            uv = normalized_view_plane_uv(bw * 2**level, bh * 2**level, ar, image.device)
            uv = uv.permute(2, 0, 1)[None]
            features.append(torch.cat([feat, uv], dim=1) if level == 0 else uv)
        neck = self.neck(features)

        def head(stack):
            out = F.interpolate(stack(neck)[-1], size=(H, W), mode="bilinear",
                                align_corners=False)
            return out.permute(0, 2, 3, 1)[0]

        points = head(self.points_head)
        mask = torch.sigmoid(head(self.mask_head)[..., 0])
        h = layers[-1][1]
        for i, lin in enumerate(self.scale_head):
            h = F.linear(h, lin.weight, lin.bias)
            if i < len(self.scale_head) - 1:
                h = torch.relu(h)
        scale = torch.exp(h[0, 0])
        valid = mask > 0.5
        _, shift = recover_focal_shift(points[None], valid[None])
        depth = points[..., 2] + shift[0]
        valid = valid & (depth > 0)
        return {"points": points, "mask": mask, "metric_scale": scale,
                "depth": torch.where(valid, depth * scale, torch.full_like(depth, torch.inf))}
