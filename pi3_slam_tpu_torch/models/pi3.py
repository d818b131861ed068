"""Pi3 visual-geometry transformer.

Port of ``pi3_slam_tpu/models/pi3.py``: DINOv2-L/14-reg encoder -> decoder
of alternating frame / global attention blocks (RoPE2D + qk-norm +
LayerScale) -> three transformer heads (points / confidence / camera) ->
pixel-shuffled dense maps, exp-z local points, SVD-orthogonalised camera
poses, world points = pose @ local.

The trunk (encoder, decoder, head decoders) runs in the module's dtype
(``--compute-dtype``: bf16 by default, or fp32, each through the kernels'
entries of that dtype on the GPU); the final point / confidence / camera
heads run in fp32 with the weights upcast, as the reference runs them outside
autocast.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

import torch
from torch import nn

from ..geometry.transforms import homogenize_points, svd_orthogonalize
from ..ops.pixel_shuffle import tokens_to_image
from ..ops.rope import make_patch_positions, rope_tables
from ..utils.timing import span
from .dinov2 import VIT_LARGE, DinoV2Config, DinoVisionTransformer
from .layers import Block, apply_linear

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class Pi3Config:
    encoder: DinoV2Config = VIT_LARGE
    patch_size: int = 14
    dec_embed_dim: int = 1024
    dec_num_heads: int = 16
    dec_depth: int = 36
    mlp_ratio: int = 4
    num_register_tokens: int = 5
    rope_base: float = 100.0
    norm_eps: float = 1e-6
    head_dim: int = 1024
    head_depth: int = 5
    head_num_heads: int = 16
    camera_dim: int = 512
    # frames per k/v group in the global blocks (1: exact attention)
    global_kv_merge: int = 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Pi3Config":
        d = json.loads(s)
        enc = d.pop("encoder")
        return Pi3Config(encoder=DinoV2Config(**enc), **d)


class TransformerDecoder(nn.Module):
    """Head decoder: project, RoPE blocks (no qk-norm, no LayerScale),
    linear out. Frame-wise attention."""

    def __init__(self, in_dim, dim, out_dim, depth, num_heads, mlp_ratio, eps, device=None):
        super().__init__()
        kw = dict(device=device)
        self.project = nn.Linear(in_dim, dim, **kw)
        self.blocks = nn.ModuleList(
            Block(dim, num_heads, mlp_ratio, eps=eps, **kw) for _ in range(depth)
        )
        self.out = nn.Linear(dim, out_dim, **kw)


class ResConv(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.fc1 = nn.Linear(d, d, device=device)
        self.fc2 = nn.Linear(d, d, device=device)
        self.fc3 = nn.Linear(d, d, device=device)


class CameraHead(nn.Module):
    def __init__(self, d, device=None):
        super().__init__()
        kw = dict(device=device)
        self.res_conv = nn.ModuleList(ResConv(d, **kw) for _ in range(2))
        self.mlp1 = nn.Linear(d, d, **kw)
        self.mlp2 = nn.Linear(d, d, **kw)
        self.fc_t = nn.Linear(d, 3, **kw)
        self.fc_rot = nn.Linear(d, 9, **kw)


class Pi3(nn.Module):
    def __init__(self, cfg: Pi3Config = Pi3Config(), device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device)
        c = cfg.dec_embed_dim
        p = cfg.patch_size
        self.encoder = DinoVisionTransformer(cfg.encoder, **kw)
        self.register_token = nn.Parameter(torch.zeros(cfg.num_register_tokens, c, **kw))
        # even blocks attend within a frame, odd blocks across the chunk
        self.decoder = nn.ModuleList(
            Block(c, cfg.dec_num_heads, cfg.mlp_ratio, qk_norm=True, layerscale=True,
                  eps=cfg.norm_eps, **kw)
            for _ in range(cfg.dec_depth)
        )

        def head(out_dim):
            return TransformerDecoder(2 * c, cfg.head_dim, out_dim, cfg.head_depth,
                                      cfg.head_num_heads, cfg.mlp_ratio, cfg.norm_eps, **kw)

        self.point_decoder = head(cfg.head_dim)
        self.conf_decoder = head(cfg.head_dim)
        self.camera_decoder = head(cfg.camera_dim)
        self.point_head = nn.Linear(cfg.head_dim, 3 * p * p, **kw)
        self.conf_head = nn.Linear(cfg.head_dim, p * p, **kw)
        self.camera_head = CameraHead(cfg.camera_dim, **kw)

    def _decode(self, hidden: torch.Tensor, B: int, N: int, grid_hw: tuple[int, int]):
        """Alternating frame / global decoder. hidden (B*N, hw, C) encoder
        patch tokens -> (hidden_cat (B*N, hw+R, 2C) = concat of the last two
        blocks' outputs, frame positions (B*N, hw+R, 2))."""
        cfg = self.cfg
        h, w = grid_hw
        bn, hw, c = hidden.shape
        reg = cfg.num_register_tokens
        register = self.register_token.to(hidden.dtype).expand(bn, reg, c)
        x = torch.cat([register, hidden], dim=1)
        t = hw + reg
        # patch positions shifted +1; register tokens at (0, 0)
        pos_frame = make_patch_positions(bn, h, w, num_special=reg, offset=1, device=hidden.device)
        cos, sin = rope_tables(pos_frame, c // cfg.dec_num_heads, cfg.rope_base)
        rope_frame = (cos, sin)
        rope_global = (cos.reshape(B, N * t, -1), sin.reshape(B, N * t, -1))
        kv_groups = (N, t, cfg.global_kv_merge)
        x_frame = x
        for i in range(0, cfg.dec_depth, 2):
            x_frame = self.decoder[i](x, rope=rope_frame)
            x = self.decoder[i + 1](
                x_frame.reshape(B, N * t, c), rope=rope_global, kv_groups=kv_groups
            ).reshape(bn, t, c)
        return torch.cat([x_frame, x], dim=-1), pos_frame

    def _head_decoder_forward(self, dec: TransformerDecoder, hidden, positions) -> torch.Tensor:
        cfg = self.cfg
        h = apply_linear(hidden, dec.project)
        rope = rope_tables(positions, h.shape[-1] // cfg.head_num_heads, cfg.rope_base)
        for blk in dec.blocks:
            h = blk(h, rope=rope)
        return apply_linear(h, dec.out)

    def _camera_head_forward(self, feat: torch.Tensor) -> torch.Tensor:
        """Residual linear blocks, token-mean pool, 2-layer MLP, then fp32
        translation / rotation with SVD orthogonalisation -> (BN, 4, 4)."""
        p = self.camera_head
        relu = torch.relu
        x = feat
        for rc in p.res_conv:
            h = relu(apply_linear(x, rc.fc1))
            h = relu(apply_linear(h, rc.fc2))
            h = relu(apply_linear(h, rc.fc3))
            x = x + h
        pooled = x.mean(dim=1)
        h = relu(apply_linear(pooled, p.mlp1))
        h32 = relu(apply_linear(h, p.mlp2)).float()
        t = apply_linear(h32, p.fc_t)
        R = svd_orthogonalize(apply_linear(h32, p.fc_rot))
        pose = torch.zeros((feat.shape[0], 4, 4), dtype=torch.float32, device=feat.device)
        pose[:, :3, :3] = R
        pose[:, :3, 3] = t
        pose[:, 3, 3] = 1.0
        return pose

    def forward(self, imgs: torch.Tensor) -> dict[str, torch.Tensor]:
        """(B, N, 3, H, W) images in [0, 1] -> {'points', 'local_points'
        (B,N,H,W,3), 'conf' (B,N,H,W,1), 'camera_poses' (B,N,4,4)}, fp32."""
        cfg = self.cfg
        B, N, _, H, W = imgs.shape
        p = cfg.patch_size
        ph, pw = H // p, W // p
        mean = torch.tensor(IMAGE_MEAN, dtype=imgs.dtype, device=imgs.device).reshape(1, 1, 3, 1, 1)
        std = torch.tensor(IMAGE_STD, dtype=imgs.dtype, device=imgs.device).reshape(1, 1, 3, 1, 1)
        with span("pi3.encoder"):
            imgs = (imgs - mean) / std
            hidden = self.encoder(imgs.reshape(B * N, 3, H, W))["patch_tokens"]
        with span("pi3.decoder"):
            hidden_cat, pos = self._decode(hidden, B, N, (ph, pw))
        with span("pi3.heads"):
            point_hidden = self._head_decoder_forward(self.point_decoder, hidden_cat, pos)
            conf_hidden = self._head_decoder_forward(self.conf_decoder, hidden_cat, pos)
            camera_hidden = self._head_decoder_forward(self.camera_decoder, hidden_cat, pos)
            return self._dense_heads(point_hidden, conf_hidden, camera_hidden, B, N, H, W)

    def _dense_heads(self, point_hidden: torch.Tensor, conf_hidden: torch.Tensor,
                     camera_hidden: torch.Tensor, B: int, N: int, H: int, W: int
                     ) -> dict[str, torch.Tensor]:
        """The point, confidence and camera heads on the head decoders'
        outputs (B*N, R + h*w, C), in fp32, and the world points."""
        cfg = self.cfg
        p = cfg.patch_size
        ph, pw = H // p, W // p
        reg = cfg.num_register_tokens
        pt = point_hidden[:, reg:].float()
        ret = tokens_to_image(
            apply_linear(pt, self.point_head), (ph, pw), p, 3
        ).reshape(B, N, H, W, 3)
        xy, z = ret[..., :2], ret[..., 2:]
        z = torch.exp(z)
        local_points = torch.cat([xy * z, z], dim=-1)
        cf = conf_hidden[:, reg:].float()
        conf = tokens_to_image(
            apply_linear(cf, self.conf_head), (ph, pw), p, 1
        ).reshape(B, N, H, W, 1)
        camera_poses = self._camera_head_forward(camera_hidden[:, reg:]).reshape(B, N, 4, 4)
        points = torch.einsum(
            "bnij,bnhwj->bnhwi", camera_poses, homogenize_points(local_points)
        )[..., :3]
        return {
            "points": points,
            "local_points": local_points,
            "conf": conf,
            "camera_poses": camera_poses,
        }
