"""VGGT-1B visual-geometry transformer.

VGGT (Wang et al., "VGGT: Visual Geometry Grounded Transformer", CVPR 2025;
github.com/facebookresearch/vggt, hf ``facebook/VGGT-1B``), the model Pi3 was
built from, on the port's chunk path:

* the aggregator: DINOv2-L/14-reg patch tokens, then one camera token and
  four register tokens a frame, frame 0 taking a learned set of its own (the
  reference frame), then alternating frame / global ``Block`` pairs
  (qk-norm, 2-D RoPE, LayerScale); each pair's two outputs concatenated into
  2C-wide tokens, kept only at the layers the heads read;
* the camera head: ``camera_iterations`` rounds of adaLN on the last kept
  layer's camera tokens, modulated by the previous pose encoding, a trunk of
  ``Block``s at 2C attending across the chunk's frames and an MLP to the
  9-wide pose encoding (translation, quaternion scalar last, two fields of
  view, ``absT_quaR_FoV``);
* two DPT heads (depth: ``exp`` and ``1 + exp`` confidence; world points:
  ``inv_log`` and ``1 + exp``), each over the four kept layers.

The trunk (encoder and aggregator) runs in the module's dtype through the
port's kernels, as Pi3's does; the heads run in fp32 (weights held in fp32,
cuDNN and cuBLAS with TF32 off, the trunk blocks of the camera head on the
fp32 kernel entries), as VGGT runs them outside autocast. The track head is
not built: VGGT runs it only for query points, which SLAM never passes.

The forward returns what the chunk step reads: the point head's world
points, local points (depth times the pixel rays of the predicted
intrinsics), the depth confidence, camera-to-world poses (the inverse of
VGGT's camera-from-world ``[R|t]``) and the intrinsics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.maps import normalized_view_plane_uv
from ..ops.rope import make_patch_positions, rope_tables
from ..utils.timing import span
from .dinov2 import VIT_LARGE, DinoV2Config, DinoVisionTransformer
from .layers import Block, apply_linear, layer_norm

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
POSE_ENCODING_DIM = 9  # absT_quaR_FoV: translation 3, quaternion 4, field of view 2


@dataclass(frozen=True)
class VGGTConfig:
    encoder: DinoV2Config = VIT_LARGE
    patch_size: int = 14
    embed_dim: int = 1024
    # frame / global block pairs
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    num_register_tokens: int = 4
    rope_base: float = 100.0
    # the aggregator's and camera head's LayerNorms (torch's default)
    norm_eps: float = 1e-5
    camera_depth: int = 4
    camera_num_heads: int = 16
    camera_mlp_ratio: int = 4
    camera_iterations: int = 4
    adaln_eps: float = 1e-6
    dpt_features: int = 256
    dpt_out_channels: tuple = (256, 512, 1024, 1024)
    # the aggregator layers the heads read; the camera head reads the last
    dpt_layers: tuple = (4, 11, 17, 23)

    @staticmethod
    def from_dict(d: dict) -> "VGGTConfig":
        d = dict(d)
        enc = d.pop("encoder", None)
        for key in ("dpt_out_channels", "dpt_layers"):
            if key in d:
                d[key] = tuple(d[key])
        return VGGTConfig(**d) if enc is None else VGGTConfig(encoder=DinoV2Config(**enc), **d)


def _mlp(x: torch.Tensor, fc1: nn.Linear, fc2: nn.Linear) -> torch.Tensor:
    return apply_linear(F.gelu(apply_linear(x, fc1)), fc2)


class CameraHead(nn.Module):
    """The iterative adaLN camera head (VGGT's ``CameraHead``)."""

    def __init__(self, cfg: VGGTConfig, device=None):
        super().__init__()
        kw = dict(device=device)
        d = 2 * cfg.embed_dim
        self.cfg = cfg
        self.token_norm = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.trunk = nn.ModuleList(
            Block(d, cfg.camera_num_heads, cfg.camera_mlp_ratio, layerscale=True,
                  eps=cfg.norm_eps, **kw) for _ in range(cfg.camera_depth))
        self.trunk_norm = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(POSE_ENCODING_DIM, **kw))
        self.embed_pose = nn.Linear(POSE_ENCODING_DIM, d, **kw)
        self.modulation = nn.Linear(d, 3 * d, **kw)
        self.fc1 = nn.Linear(d, d // 2, **kw)
        self.fc2 = nn.Linear(d // 2, POSE_ENCODING_DIM, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, N, 2C) fp32 camera tokens -> (B, N, 9) activated pose
        encoding of the last iteration. fp32 throughout: cuBLAS with TF32
        off (``device.select_device``), the trunk's blocks on the kernels'
        fp32 entries."""
        cfg = self.cfg
        d = tokens.shape[-1]
        tokens = layer_norm(tokens, self.token_norm.weight, self.token_norm.bias, cfg.norm_eps)
        normed = F.layer_norm(tokens, (d,), eps=cfg.adaln_eps)
        pred = None
        for _ in range(cfg.camera_iterations):
            enc = self.empty_pose_tokens.expand(tokens.shape[:-1] + (POSE_ENCODING_DIM,)) \
                if pred is None else pred
            shift, scale, gate = apply_linear(F.silu(apply_linear(enc, self.embed_pose)),
                                              self.modulation).chunk(3, dim=-1)
            h = gate * (normed * (1 + scale) + shift) + tokens
            for blk in self.trunk:
                h = blk(h)
            h = layer_norm(h, self.trunk_norm.weight, self.trunk_norm.bias, cfg.norm_eps)
            delta = _mlp(h, self.fc1, self.fc2)
            pred = delta if pred is None else pred + delta
        return activate_pose(pred)


def activate_pose(enc: torch.Tensor) -> torch.Tensor:
    """Translation and quaternion linear, fields of view through ReLU."""
    return torch.cat([enc[..., :7], torch.relu(enc[..., 7:])], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (x, y, z, w: scalar last) -> (..., 3, 3) rotations;
    any non-zero length (the 2 / |q|^2 form)."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    m = torch.stack((
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
    ), dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_camera(enc: torch.Tensor, hw: tuple[int, int]):
    """(..., 9) pose encodings -> (camera-to-world poses (..., 4, 4),
    intrinsics (..., 3, 3)): the camera-from-world [R|t] inverted; fy =
    (H/2) / tan(fov_h/2), fx = (W/2) / tan(fov_w/2), principal point at the
    image centre (W/2, H/2)."""
    H, W = hw
    R = quaternion_to_matrix(enc[..., 3:7])
    t = enc[..., :3]
    Rt = R.transpose(-1, -2)
    pose = torch.zeros(enc.shape[:-1] + (4, 4), dtype=enc.dtype, device=enc.device)
    pose[..., :3, :3] = Rt
    pose[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    pose[..., 3, 3] = 1.0
    K = torch.zeros(enc.shape[:-1] + (3, 3), dtype=enc.dtype, device=enc.device)
    K[..., 0, 0] = (W / 2.0) / torch.tan(enc[..., 8] / 2.0)
    K[..., 1, 1] = (H / 2.0) / torch.tan(enc[..., 7] / 2.0)
    K[..., 0, 2] = W / 2.0
    K[..., 1, 2] = H / 2.0
    K[..., 2, 2] = 1.0
    return pose, K


def depth_to_local_points(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """depth (..., H, W) and intrinsics (..., 3, 3) -> (..., H, W, 3) camera
    points: ((u - cx) / fx * d, (v - cy) / fy * d, d) at pixel indices."""
    H, W = depth.shape[-2:]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)
    fx, fy = K[..., 0, 0, None, None], K[..., 1, 1, None, None]
    cx, cy = K[..., 0, 2, None, None], K[..., 1, 2, None, None]
    x = (u - cx) / fx * depth
    y = (v[:, None] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def uv_position_embedding(height: int, width: int, channels: int, aspect_ratio: float,
                          device, ratio: float = 0.1) -> torch.Tensor:
    """(channels, height, width) sine embedding of the view plane's UV grid
    (``geometry.maps.normalized_view_plane_uv``, VGGT's ``create_uv_grid``)
    times ``ratio``: the first half embeds u, the second v, each [sin | cos]
    at frequencies 100^-(i / (c/4)) (VGGT's ``position_grid_to_embed``, in
    float64 on the float32 grid)."""
    grid = normalized_view_plane_uv(width, height, aspect_ratio, device=device)
    grid = grid.reshape(-1, 2).double()
    half = channels // 2
    omega = 1.0 / 100.0 ** (torch.arange(half // 2, dtype=torch.float64, device=device)
                            / (half / 2.0))

    def embed(pos):
        out = pos[:, None] * omega[None]
        return torch.cat([out.sin(), out.cos()], dim=1)

    emb = torch.cat([embed(grid[:, 0]), embed(grid[:, 1])], dim=1).float()
    return (emb * ratio).reshape(height, width, channels).permute(2, 0, 1)


def _upsample(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


class ResidualUnit(nn.Module):
    """ReLU, 3x3 conv, ReLU, 3x3 conv, plus the skip. The published unit's
    ReLU works in place, so its skip carries relu(x)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, device=device)

    def forward(self, x):
        x = torch.relu(x)
        return self.conv2(torch.relu(self.conv1(x))) + x


class FusionBlock(nn.Module):
    """RefineNet fusion: (+ residual unit of the skip), residual unit,
    bilinear upsampling (align_corners=True), 1x1 out-conv."""

    def __init__(self, c: int, has_residual: bool = True, device=None):
        super().__init__()
        self.unit1 = ResidualUnit(c, device) if has_residual else None
        self.unit2 = ResidualUnit(c, device)
        self.out_conv = nn.Conv2d(c, c, 1, device=device)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.unit1(skip)
        x = self.unit2(x)
        size = size or (2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(_upsample(x, size))


class DPTHead(nn.Module):
    """VGGT's DPT head over four kept aggregator layers, fp32."""

    def __init__(self, cfg: VGGTConfig, out_dim: int, device=None):
        super().__init__()
        kw = dict(device=device)
        d = 2 * cfg.embed_dim
        oc = cfg.dpt_out_channels
        f = cfg.dpt_features
        self.cfg = cfg
        self.norm = nn.LayerNorm(d, eps=cfg.norm_eps, **kw)
        self.projects = nn.ModuleList(nn.Conv2d(d, c, 1, **kw) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **kw),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **kw),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **kw),
        ])
        self.layer_rn = nn.ModuleList(nn.Conv2d(c, f, 3, padding=1, bias=False, **kw)
                                      for c in oc)
        self.refinenet = nn.ModuleList([FusionBlock(f, True, device) for _ in range(3)]
                                       + [FusionBlock(f, False, device)])
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1, **kw)
        self.output_conv2a = nn.Conv2d(f // 2, 32, 3, padding=1, **kw)
        self.output_conv2b = nn.Conv2d(32, out_dim, 1, **kw)

    def forward(self, layers: list, grid_hw: tuple[int, int], image_hw: tuple[int, int],
                num_special: int) -> torch.Tensor:
        """layers: the kept (BN, T, 2C) fp32 tokens -> (BN, out_dim, H, W),
        before the activation; fp32 convolutions with cuDNN's TF32 off."""
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            return self._forward(layers, grid_hw, image_hw, num_special)

    def _forward(self, layers, grid_hw, image_hw, num_special):
        h, w = grid_hw
        H, W = image_hw
        ar = W / H
        feats = []
        for i, x in enumerate(layers):
            x = layer_norm(x[:, num_special:], self.norm.weight, self.norm.bias,
                           self.cfg.norm_eps)
            x = x.transpose(1, 2).reshape(x.shape[0], -1, h, w)
            x = self.projects[i](x)
            x = x + uv_position_embedding(h, w, x.shape[1], ar, x.device)
            feats.append(self.layer_rn[i](self.resize_layers[i](x)))
        r4, r3, r2, r1 = self.refinenet[3], self.refinenet[2], self.refinenet[1], self.refinenet[0]
        out = r4(feats[3], size=feats[2].shape[-2:])
        out = r3(out, feats[2], size=feats[1].shape[-2:])
        out = r2(out, feats[1], size=feats[0].shape[-2:])
        out = r1(out, feats[0])
        out = _upsample(self.output_conv1(out), (H, W))
        out = out + uv_position_embedding(H, W, out.shape[1], ar, out.device)
        return self.output_conv2b(torch.relu(self.output_conv2a(out)))


class VGGT(nn.Module):
    name = "vggt"
    # confidence_mask's share where the creator's config leaves it unset:
    # VGGT-SLAM's --conf_threshold 25
    default_conf_threshold = 0.25

    def __init__(self, cfg: VGGTConfig = VGGTConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device)
        c = cfg.embed_dim
        if cfg.dpt_layers[-1] != cfg.depth - 1 or sorted(cfg.dpt_layers) != list(cfg.dpt_layers):
            raise ValueError(f"dpt_layers {cfg.dpt_layers}: increasing, the last the "
                             f"aggregator's last ({cfg.depth - 1}), which the camera head reads")
        self.encoder = DinoVisionTransformer(cfg.encoder, **kw)
        # set 0 for frame 0 (the reference frame), set 1 for the others
        self.camera_token = nn.Parameter(torch.zeros(2, 1, c, **kw))
        self.register_token = nn.Parameter(torch.zeros(2, cfg.num_register_tokens, c, **kw))

        def blocks():
            return nn.ModuleList(
                Block(c, cfg.num_heads, cfg.mlp_ratio, qk_norm=True, layerscale=True,
                      eps=cfg.norm_eps, **kw) for _ in range(cfg.depth))

        self.frame_blocks = blocks()
        self.global_blocks = blocks()
        self.camera_head = CameraHead(cfg, device)
        self.depth_head = DPTHead(cfg, 2, device)
        self.point_head = DPTHead(cfg, 4, device)

    @property
    def num_special(self) -> int:
        return 1 + self.cfg.num_register_tokens

    def aggregate(self, patches: torch.Tensor, B: int, N: int, grid_hw: tuple[int, int]):
        """Encoder patch tokens (B*N, hw, C) -> the kept layers, {index:
        (B*N, T, 2C)} in the trunk's dtype, T = hw + 1 + registers."""
        cfg = self.cfg
        h, w = grid_hw
        bn, hw, c = patches.shape
        first = torch.zeros(N, dtype=torch.long, device=patches.device)
        first[1:] = 1
        special = torch.cat([self.camera_token, self.register_token], dim=1)[first]
        special = special.to(patches.dtype).repeat(B, 1, 1)
        x = torch.cat([special, patches], dim=1)
        t = x.shape[1]
        pos = make_patch_positions(bn, h, w, num_special=self.num_special, offset=1,
                                   device=patches.device)
        cos, sin = rope_tables(pos, c // cfg.num_heads, cfg.rope_base)
        rope_global = (cos.reshape(B, N * t, -1), sin.reshape(B, N * t, -1))
        kept = {}
        for i in range(cfg.depth):
            x = self.frame_blocks[i](x, rope=(cos, sin))
            x_frame = x
            x = self.global_blocks[i](x.reshape(B, N * t, c), rope=rope_global).reshape(bn, t, c)
            if i in cfg.dpt_layers:
                kept[i] = torch.cat([x_frame, x], dim=-1)
        return kept

    def forward(self, imgs: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, N, 3, H, W) images in [0, 1] -> {'points', 'local_points'
        (B,N,H,W,3), 'conf' (B,N,H,W,1), 'camera_poses' (B,N,4,4),
        'intrinsics' (B,N,3,3)}, fp32."""
        cfg = self.cfg
        B, N, _, H, W = imgs.shape
        p = cfg.patch_size
        grid = (H // p, W // p)
        mean = torch.tensor(IMAGE_MEAN, dtype=imgs.dtype, device=imgs.device).reshape(1, 1, 3, 1, 1)
        std = torch.tensor(IMAGE_STD, dtype=imgs.dtype, device=imgs.device).reshape(1, 1, 3, 1, 1)
        with span("vggt.encoder"):
            x = ((imgs - mean) / std).reshape(B * N, 3, H, W)
            patches = self.encoder(x)["patch_tokens"]
        with span("vggt.aggregator"):
            kept = self.aggregate(patches, B, N, grid)
            layers = [kept[i].float() for i in cfg.dpt_layers]
            del kept, patches
        with span("vggt.camera_head"):
            cam_tokens = layers[-1][:, 0].reshape(B, N, -1)
            pose_enc = self.camera_head(cam_tokens)
            poses, K = pose_encoding_to_camera(pose_enc, (H, W))
        with span("vggt.depth_head"):
            d = self.depth_head(layers, grid, (H, W), self.num_special)
            depth = torch.exp(d[:, 0]).reshape(B, N, H, W)
            conf = (1 + torch.exp(d[:, 1])).reshape(B, N, H, W, 1)
            del d
        with span("vggt.point_head"):
            y = self.point_head(layers, grid, (H, W), self.num_special)
            xyz = y[:, :3].permute(0, 2, 3, 1)
            points = (torch.sign(xyz) * torch.expm1(xyz.abs())).reshape(B, N, H, W, 3)
            del y
        return {
            "points": points,
            "local_points": depth_to_local_points(depth, K),
            "conf": conf,
            "camera_poses": poses,
            "intrinsics": K,
        }

    @staticmethod
    def confidence_mask(conf: torch.Tensor, threshold: float) -> torch.Tensor:
        """conf (N, H, W), VGGT's ``1 + exp`` depth confidence -> the pixels
        at or above the chunk's ``threshold`` quantile: the lowest share
        ``threshold`` of the chunk's confidences dropped (VGGT-SLAM's
        ``--conf_threshold 25`` is 0.25)."""
        return conf >= chunk_quantile(conf, threshold)


def chunk_quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of all of ``values``, interpolated linearly between
    the order statistics at q (n - 1) (numpy's ``percentile`` default)."""
    v = values.reshape(-1).sort().values
    pos = q * (v.numel() - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, v.numel() - 1)
    return v[lo] + (pos - lo) * (v[hi] - v[lo])

