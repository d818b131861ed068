"""Plain VGGT-1B: the DINOv2-L/14-reg patch tokens, the aggregator of frame /
global blocks with per-frame camera and register tokens (frame 0 its own
set), the iterative adaLN camera head and the depth and point DPT heads, in
plain PyTorch, float32 with TF32 off.

The benchmark's reference for the port's ``models/vggt.py`` and the tier-1
tests' (VGGT, Wang et al., CVPR 2025; github.com/facebookresearch/vggt, hf
``facebook/VGGT-1B``). It follows the published equations with none of the
port's kernels: every product a float32 ``F.linear``, ``matmul`` or cuDNN
convolution, attention the row-blocked softmax of ``pi3.py`` (so 16,656
global tokens fit). The transformer blocks and DINOv2 are ``pi3.py``'s plain
``Block`` and ``Encoder``; the modules carry the port's parameter names, so
one state dict serves both. Imports nothing of the program and no JAX.

Departures from the published code, each without effect on the numbers a
chunk stores:

* the track head is not built (VGGT runs it only for query points);
* only the four aggregator layers the heads read are kept (VGGT keeps all
  24 and reads those four);
* the DPT heads run all of a chunk's frames at once (VGGT's
  ``frames_chunk_size`` 8 splits the same per-frame work);
* the special tokens are held as (2, 1, C) and (2, 4, C) (VGGT: (1, 2, 1,
  C) and (1, 2, 4, C)), the camera head's modulation linear is ``modulation``
  (VGGT: ``poseLN_modulation.1``), its MLP ``fc1`` / ``fc2`` (``pose_branch``),
  the DPT's scratch convolutions ``layer_rn.i`` and ``refinenet.i`` with
  residual units ``unit1`` / ``unit2``, its last two convolutions
  ``output_conv2a`` / ``output_conv2b``: names only;
* the residual unit's ReLU works in place as the published module builds it
  (``nn.ReLU(inplace=True)``): its skip adds relu(x), which is written out;
* the DPT's sine position embedding is computed in float64 on the float32
  UV grid and rounded to float32 (VGGT: float64 frequencies on the float32
  grid, its product's type left to ``einsum``).

``Precision(fp8=True)`` is the control: the trunk's products (DINOv2 and the
aggregator, the configuration's bf16 part) on float8 e4m3 operands and the
fp32 heads in TF32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .pi3 import (IMAGE_MEAN, IMAGE_STD, PROBE_NOISE, Block, Encoder, Precision, allow_tf32,
                  layer_norm, linear, patch_positions, rope_tables)
from .focal import depth_edge, normalized_view_plane_uv, sample_at

POSE_DIM = 9


class CameraHead(nn.Module):
    def __init__(self, model: dict):
        super().__init__()
        d = 2 * model["embed_dim"]
        eps = model["norm_eps"]
        self.token_norm = nn.LayerNorm(d, eps=eps, device="meta")
        self.trunk = nn.ModuleList(
            Block(d, model["camera_num_heads"], model["camera_mlp_ratio"], layerscale=True,
                  eps=eps) for _ in range(model["camera_depth"]))
        self.trunk_norm = nn.LayerNorm(d, eps=eps, device="meta")
        self.empty_pose_tokens = nn.Parameter(torch.zeros(POSE_DIM, device="meta"))
        self.embed_pose = nn.Linear(POSE_DIM, d, device="meta")
        self.modulation = nn.Linear(d, 3 * d, device="meta")
        self.fc1 = nn.Linear(d, d // 2, device="meta")
        self.fc2 = nn.Linear(d // 2, POSE_DIM, device="meta")


class ResidualUnit(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, device="meta")
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, device="meta")


class FusionBlock(nn.Module):
    def __init__(self, c, has_residual):
        super().__init__()
        self.unit1 = ResidualUnit(c) if has_residual else None
        self.unit2 = ResidualUnit(c)
        self.out_conv = nn.Conv2d(c, c, 1, device="meta")


class DPTHead(nn.Module):
    def __init__(self, model: dict, out_dim: int):
        super().__init__()
        d = 2 * model["embed_dim"]
        oc = model["dpt_out_channels"]
        f = model["dpt_features"]
        self.norm = nn.LayerNorm(d, eps=model["norm_eps"], device="meta")
        self.projects = nn.ModuleList(nn.Conv2d(d, c, 1, device="meta") for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4, device="meta"),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2, device="meta"),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, device="meta"),
        ])
        self.layer_rn = nn.ModuleList(nn.Conv2d(c, f, 3, padding=1, bias=False, device="meta")
                                      for c in oc)
        self.refinenet = nn.ModuleList([FusionBlock(f, True) for _ in range(3)]
                                       + [FusionBlock(f, False)])
        self.output_conv1 = nn.Conv2d(f, f // 2, 3, padding=1, device="meta")
        self.output_conv2a = nn.Conv2d(f // 2, 32, 3, padding=1, device="meta")
        self.output_conv2b = nn.Conv2d(32, out_dim, 1, device="meta")


def conv(x, c: nn.Module):
    """A convolution with the module's weights, stride and zero padding."""
    return F.conv2d(x, c.weight, c.bias, c.stride, c.padding)


def residual_unit(x, u: ResidualUnit):
    x = torch.relu(x)  # the published in-place ReLU: the skip carries relu(x)
    return conv(torch.relu(conv(x, u.conv1)), u.conv2) + x


def fusion(x, blk: FusionBlock, skip=None, size=None):
    if skip is not None:
        x = x + residual_unit(skip, blk.unit1)
    x = residual_unit(x, blk.unit2)
    size = size or (2 * x.shape[-2], 2 * x.shape[-1])
    x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
    return conv(x, blk.out_conv)


def position_embedding(h: int, w: int, c: int, aspect: float, device, ratio: float = 0.1):
    """(c, h, w): VGGT's ``create_uv_grid`` (the view plane's diagonal at
    unit length, pixel centres, float32: ``focal.normalized_view_plane_uv``)
    embedded by ``position_grid_to_embed`` in float64 (u then v, each sin
    then cos of the coordinate times 100^-(i / (c/4)), i < c/4), times
    ratio."""
    grid = normalized_view_plane_uv(w, h, aspect, device=device).reshape(-1, 2).double()
    quarter = c // 4
    omega = 1.0 / 100.0 ** (torch.arange(quarter, dtype=torch.float64, device=device)
                            / quarter)
    parts = []
    for pos in (grid[:, 0], grid[:, 1]):
        a = pos[:, None] * omega[None]
        parts += [a.sin(), a.cos()]
    return (torch.cat(parts, dim=1).float() * ratio).reshape(h, w, c).permute(2, 0, 1)


def dpt(head: DPTHead, layers: list, grid: tuple, hw: tuple, special: int):
    """The four kept (BN, T, 2C) layers -> (BN, out, H, W), before the
    activation."""
    (h, w), (H, W) = grid, hw
    feats = []
    for i, tokens in enumerate(layers):
        x = layer_norm(tokens[:, special:], head.norm)
        x = x.transpose(1, 2).reshape(x.shape[0], -1, h, w)
        x = conv(x, head.projects[i])
        x = x + position_embedding(h, w, x.shape[1], W / H, x.device)
        r = head.resize_layers[i]
        if isinstance(r, nn.ConvTranspose2d):
            x = F.conv_transpose2d(x, r.weight, r.bias, r.stride)
        elif isinstance(r, nn.Conv2d):
            x = conv(x, r)
        feats.append(conv(x, head.layer_rn[i]))
    rn = head.refinenet
    out = fusion(feats[3], rn[3], size=feats[2].shape[-2:])
    out = fusion(out, rn[2], feats[2], size=feats[1].shape[-2:])
    out = fusion(out, rn[1], feats[1], size=feats[0].shape[-2:])
    out = fusion(out, rn[0], feats[0])
    out = F.interpolate(conv(out, head.output_conv1), size=(H, W), mode="bilinear",
                        align_corners=True)
    out = out + position_embedding(H, W, out.shape[1], W / H, out.device)
    return conv(torch.relu(conv(out, head.output_conv2a)), head.output_conv2b)


def camera(head: CameraHead, model: dict, tokens):
    """(B, N, 2C) camera tokens -> (B, N, 9) activated pose encoding: the
    ``camera_iterations`` rounds of adaLN modulated by the last round's
    encoding (the first round's by the empty one), the trunk across the
    frames and the MLP's delta added to the encoding; translation and
    quaternion linear, fields of view through ReLU."""
    tokens = layer_norm(tokens, head.token_norm)
    normed = F.layer_norm(tokens, tokens.shape[-1:], eps=model["adaln_eps"])
    pred = None
    for _ in range(model["camera_iterations"]):
        enc = head.empty_pose_tokens.expand(tokens.shape[:-1] + (POSE_DIM,)) \
            if pred is None else pred
        mod = linear(F.silu(linear(enc, head.embed_pose)), head.modulation)
        shift, scale, gate = mod.chunk(3, dim=-1)
        h = gate * (normed * (1 + scale) + shift) + tokens
        for blk in head.trunk:
            h = blk(h)
        h = layer_norm(h, head.trunk_norm)
        delta = linear(F.gelu(linear(h, head.fc1)), head.fc2)
        pred = delta if pred is None else pred + delta
    return torch.cat([pred[..., :7], torch.relu(pred[..., 7:])], dim=-1)


def quaternion_to_matrix(q):
    """(..., 4) scalar-last quaternions -> (..., 3, 3) (pytorch3d's formula,
    as VGGT's ``quat_to_mat``)."""
    i, j, k, r = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    m = torch.stack((1 - s * (j * j + k * k), s * (i * j - k * r), s * (i * k + j * r),
                     s * (i * j + k * r), 1 - s * (i * i + k * k), s * (j * k - i * r),
                     s * (i * k - j * r), s * (j * k + i * r), 1 - s * (i * i + j * j)), -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def cameras(enc, H: int, W: int):
    """Pose encodings (N, 9) -> (camera-to-world (N, 4, 4), fx (N,), fy (N,)):
    [R|t] camera-from-world inverted, focal lengths from the fields of view."""
    R = quaternion_to_matrix(enc[:, 3:7])
    t = enc[:, :3]
    pose = torch.zeros((enc.shape[0], 4, 4), dtype=enc.dtype, device=enc.device)
    pose[:, :3, :3] = R.transpose(1, 2)
    pose[:, :3, 3] = -torch.einsum("nji,nj->ni", R, t)
    pose[:, 3, 3] = 1.0
    fy = (H / 2.0) / torch.tan(enc[:, 7] / 2.0)
    fx = (W / 2.0) / torch.tan(enc[:, 8] / 2.0)
    return pose, fx, fy


class VGGT(nn.Module):
    """``model``: the configuration file's ``model`` (``VGGTConfig`` keys)."""

    def __init__(self, model: dict):
        super().__init__()
        self.cfg = model
        c = model["embed_dim"]
        self.encoder = Encoder(dict(model["encoder"], patch_size=model["patch_size"]))
        self.camera_token = nn.Parameter(torch.zeros(2, 1, c, device="meta"))
        self.register_token = nn.Parameter(torch.zeros(2, model["num_register_tokens"], c,
                                                       device="meta"))

        def blocks():
            return nn.ModuleList(
                Block(c, model["num_heads"], model["mlp_ratio"], qk_norm=True, layerscale=True,
                      eps=model["norm_eps"]) for _ in range(model["depth"]))

        self.frame_blocks = blocks()
        self.global_blocks = blocks()
        self.camera_head = CameraHead(model)
        self.depth_head = DPTHead(model, 2)
        self.point_head = DPTHead(model, 4)

    def aggregate(self, images, prec=None):
        """(N, 3, H, W) in [0, 1] -> the kept layers [(N, T, 2C)] in order."""
        cfg = self.cfg
        N, _, H, W = images.shape
        p = cfg["patch_size"]
        gh, gw = H // p, W // p
        mean = torch.tensor(IMAGE_MEAN, device=images.device).reshape(1, 3, 1, 1)
        std = torch.tensor(IMAGE_STD, device=images.device).reshape(1, 3, 1, 1)
        patches = self.encoder((images - mean) / std, prec)
        which = torch.tensor([0] + [1] * (N - 1), device=images.device)
        special = torch.cat([self.camera_token, self.register_token], dim=1)[which]
        x = torch.cat([special, patches], dim=1)
        t, c = x.shape[1], x.shape[2]
        ns = special.shape[1]
        rope = rope_tables(patch_positions(N, gh, gw, ns, 1, images.device),
                           c // cfg["num_heads"], cfg["rope_base"])
        rope_global = (rope[0].reshape(1, N * t, -1), rope[1].reshape(1, N * t, -1))
        kept = []
        for i in range(cfg["depth"]):
            x = self.frame_blocks[i](x, rope=rope, prec=prec)
            x_frame = x
            x = self.global_blocks[i](x.reshape(1, N * t, c), rope=rope_global,
                                      prec=prec).reshape(N, t, c)
            if i in cfg["dpt_layers"]:
                kept.append(torch.cat([x_frame, x], dim=-1))
        return kept

    def camera(self, tokens):
        """(1, N, 2C) camera tokens -> (N, 9) activated pose encoding."""
        return camera(self.camera_head, self.cfg, tokens)[0]

    def forward(self, images, prec: Precision | None = None):
        """(N, 3, H, W) in [0, 1], one chunk -> points, local_points (N, H, W,
        3), conf (N, H, W, 1), camera_poses (N, 4, 4), fx, fy (N,), and the
        probe: the camera head again on its input tokens with a bf16 unit of
        noise (random signs from a fixed generator), its poses
        (camera_poses_probe) and the depth on its rays (local_points_probe)."""
        cfg = self.cfg
        N, _, H, W = images.shape
        p = cfg["patch_size"]
        grid = (H // p, W // p)
        special = 1 + cfg["num_register_tokens"]
        layers = self.aggregate(images, prec)
        out_prec = Precision() if prec is None else prec
        with allow_tf32(out_prec.fp8):
            tokens = layers[-1][None, :, 0]
            enc = self.camera(tokens)
            poses, fx, fy = cameras(enc, H, W)
            g = torch.Generator(device=tokens.device).manual_seed(0)
            sign = torch.randint(0, 2, tokens.shape, generator=g, device=tokens.device) * 2 - 1
            probe, pfx, pfy = cameras(self.camera(tokens * (1 + PROBE_NOISE * sign)), H, W)
            d = dpt(self.depth_head, layers, grid, (H, W), special)
            depth, conf = torch.exp(d[:, 0]), 1 + torch.exp(d[:, 1])
            y = dpt(self.point_head, layers, grid, (H, W), special)
        xyz = y[:, :3].permute(0, 2, 3, 1)
        points = torch.sign(xyz) * torch.expm1(xyz.abs())
        u = torch.arange(W, dtype=torch.float32, device=images.device)
        v = torch.arange(H, dtype=torch.float32, device=images.device)

        def unproject(fx, fy):
            x_cam = (u[None, None, :] - W / 2.0) / fx[:, None, None] * depth
            y_cam = (v[None, :, None] - H / 2.0) / fy[:, None, None] * depth
            return torch.stack([x_cam, y_cam, depth], dim=-1)

        return {"points": points, "local_points": unproject(fx, fy), "conf": conf[..., None],
                "camera_poses": poses, "camera_poses_probe": probe, "fx": fx, "fy": fy,
                "local_points_probe": unproject(pfx, pfy)}


def confidence_mask(conf, share: float):
    """conf (N, H, W) -> conf at or above the chunk's ``share`` quantile
    (numpy's linear ``percentile``, as VGGT-SLAM takes it)."""
    threshold = float(np.percentile(conf.double().cpu().numpy(), 100.0 * share))
    return conf >= threshold


@torch.no_grad()
def chunk_outputs(model: VGGT, images_u8: torch.Tensor, keypoints: torch.Tensor,
                  conf_share: float, edge_rtol: float, prec=None) -> dict:
    """The chunk step's outputs for VGGT, float32, on the images' device
    (the keys of ``chunk.chunk_outputs``, and the probe's local points at the
    keypoints)."""
    out = model(images_u8.float() / 255.0, prec)
    local, world, conf = out["local_points"], out["points"], out["conf"]
    masks = confidence_mask(conf[..., 0], conf_share) & ~depth_edge(local[..., 2], edge_rtol)
    return {
        "points_kp": sample_at(world, keypoints),
        "local_points_kp": sample_at(local, keypoints),
        "conf_kp": sample_at(conf, keypoints, "nearest"),
        "masks_kp": sample_at(masks[..., None].float(), keypoints, "nearest")[..., 0] > 0.5,
        "camera_poses": out["camera_poses"],
        "camera_poses_probe": out["camera_poses_probe"],
        "local_points_probe_kp": sample_at(out["local_points_probe"], keypoints),
        "depth0": local[0, ..., 2],
        "mask0": masks[0],
    }
