"""ALIKED keypoint detector and descriptor (Zhao et al. 2023) in PyTorch.

Port of ``pi3_slam_tpu/models/aliked.py``. The module's parameter names are
the lightglue ALIKED layout (``block1.conv1.weight``, ``block2.bn1.*``,
``score_head.{0,2,4,6}``, ``desc_head.offset_conv.{0,2}``,
``desc_head.sf_conv``, ``desc_head.agg_weights``), so the state dict that
:func:`aliked_state_from_jax` makes from the JAX tree is also what
``models/convert.convert_aliked_state_dict`` reads.

Structure (aliked-n16: c1..c4 = 16/32/64/128, dim = 128, K = 3, M = 16):

  backbone   ConvBlock(3, c1) -> avgpool 2 -> ResBlock(c1, c2) -> avgpool 4 ->
             ResBlock(c2, c3) -> avgpool 4 -> ResBlock(c3, c4); SELU gates,
             inference BatchNorm, 1x1-conv shortcuts. The pools take VALID
             windows and floor (308 -> 154 -> 38 -> 9).
  pyramid    1x1 conv of each scale to dim / 4, align-corners bilinear
             upsampling to full resolution, concat, L2 normalisation.
  score head 1x1 conv dim -> 8, 3x3 8 -> 4, 3x3 4 -> 4, 3x3 4 -> 1 (SELU
             between), sigmoid.
  DKD        NMS (a max pool with -inf padding), border suppression, top-k in
             XLA's tie order (a stable descending sort: equal scores keep the
             lower flat index first, so the filler slots past the survivors
             land where the JAX package puts them), soft-argmax over the NMS
             window with the JAX gather's index rules.
  SDDH       KxK bilinear patch around each keypoint -> offset conv (a full
             contraction over the (iy, ix, channel) patch) -> bilinear samples
             at keypoint + offsets -> 1x1 sf_conv -> aggregation with
             (M, dim, dim) weights -> L2 normalisation.

Everything runs in fp32 on the inputs' device; the convolutions go to cuDNN
with TF32 off (``device.select_device``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class ALIKEDConfig:
    c1: int = 16
    c2: int = 32
    c3: int = 64
    c4: int = 128
    dim: int = 128
    kernel_size: int = 3  # SDDH patch size K
    n_pos: int = 16  # SDDH deformable sample count M
    nms_radius: int = 2
    detection_threshold: float = 0.005
    max_keypoints: int = 1000
    bn_eps: float = 1e-5


CONFIGS = {
    # c1, c2, c3, c4, dim, K, M: the lightglue / ALIKED model zoo
    "aliked-t16": ALIKEDConfig(8, 16, 32, 64, 64, 3, 16),
    "aliked-n16": ALIKEDConfig(16, 32, 64, 128, 128, 3, 16),
    "aliked-n16rot": ALIKEDConfig(16, 32, 64, 128, 128, 3, 16),
    "aliked-n32": ALIKEDConfig(16, 32, 64, 128, 128, 3, 32),
}


class ConvBlock(nn.Module):
    """conv3x3-BN-SELU twice."""

    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.selu(self.bn1(self.conv1(x)))
        return F.selu(self.bn2(self.conv2(x)))


class ResBlock(ConvBlock):
    """conv3x3-BN-SELU, conv3x3-BN, plus a 1x1-conv shortcut, SELU."""

    def __init__(self, cin: int, cout: int, eps: float):
        super().__init__(cin, cout, eps)
        self.downsample = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.selu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.selu(out + self.downsample(x))


class SDDH(nn.Module):
    """Sparse deformable descriptor head."""

    def __init__(self, dim: int, k: int, m: int):
        super().__init__()
        self.k, self.m = k, m
        self.offset_conv = nn.Sequential(nn.Conv2d(dim, 2 * m, k), nn.SELU(),
                                         nn.Conv2d(2 * m, 2 * m, 1))
        self.sf_conv = nn.Conv2d(dim, dim, 1, bias=False)
        self.agg_weights = nn.Parameter(torch.zeros(m, dim, dim))


class ALIKED(nn.Module):
    def __init__(self, cfg: ALIKEDConfig = CONFIGS["aliked-n16"]):
        super().__init__()
        self.cfg = cfg
        eps = cfg.bn_eps
        d4 = cfg.dim // 4
        self.block1 = ConvBlock(3, cfg.c1, eps)
        self.block2 = ResBlock(cfg.c1, cfg.c2, eps)
        self.block3 = ResBlock(cfg.c2, cfg.c3, eps)
        self.block4 = ResBlock(cfg.c3, cfg.c4, eps)
        self.conv1 = nn.Conv2d(cfg.c1, d4, 1, bias=False)
        self.conv2 = nn.Conv2d(cfg.c2, d4, 1, bias=False)
        self.conv3 = nn.Conv2d(cfg.c3, d4, 1, bias=False)
        self.conv4 = nn.Conv2d(cfg.dim, d4, 1, bias=False)
        self.score_head = nn.Sequential(
            nn.Conv2d(cfg.dim, 8, 1), nn.SELU(),
            nn.Conv2d(8, 4, 3, padding=1), nn.SELU(),
            nn.Conv2d(4, 4, 3, padding=1), nn.SELU(),
            nn.Conv2d(4, 1, 3, padding=1),
        )
        self.desc_head = SDDH(cfg.dim, cfg.kernel_size, cfg.n_pos)


def aliked_dense_maps(model: ALIKED, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (N, 3, H, W) in [0, 1] -> (feature map (N, H, W, dim),
    L2-normalised; score map (N, H, W) in (0, 1))."""
    H, W = images.shape[-2:]

    def up(x):  # align-corners bilinear; a 1-pixel side repeats its value
        return F.interpolate(x, size=(H, W), mode="bilinear", align_corners=True)

    x1 = model.block1(images)
    x2 = model.block2(F.avg_pool2d(x1, 2))
    x3 = model.block3(F.avg_pool2d(x2, 4))
    x4 = model.block4(F.avg_pool2d(x3, 4))
    feats = torch.cat([
        F.selu(model.conv1(x1)),
        up(F.selu(model.conv2(x2))),
        up(F.selu(model.conv3(x3))),
        up(F.selu(model.conv4(x4))),
    ], dim=1)
    feats = F.normalize(feats, dim=1, eps=1e-12)
    score = torch.sigmoid(model.score_head(feats)[:, 0])
    return feats.permute(0, 2, 3, 1).contiguous(), score


def _wrap_clamp(i: torch.Tensor, n: int) -> torch.Tensor:
    """The JAX gather's index rules: a negative index counts from the end,
    then an index out of range is clamped."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def detect_keypoints(score_map: torch.Tensor, max_keypoints: int, nms_radius: int = 2,
                     threshold: float = 0.005, temperature: float = 0.1) -> Dict[str, torch.Tensor]:
    """score_map (N, H, W) -> {'keypoints': (N, K, 2) (x, y) pixels,
    'scores': (N, K), 'valid': (N, K) bool}, K = max_keypoints. Slots below
    the threshold or past the NMS survivors have valid False and coordinates
    clamped inside the image."""
    N, H, W = score_map.shape
    r = nms_radius
    win = 2 * r + 1
    dev = score_map.device
    pooled = F.max_pool2d(score_map[:, None], win, stride=1, padding=r)[:, 0]
    is_max = score_map >= pooled
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    interior = (yy >= r) & (yy < H - r) & (xx >= r) & (xx < W - r)
    cand = torch.where(is_max & interior, score_map, torch.zeros_like(score_map))

    # top-k in XLA's order: descending, equal values by ascending flat index
    scores, idx = torch.sort(cand.reshape(N, H * W), dim=1, descending=True, stable=True)
    scores, idx = scores[:, :max_keypoints], idx[:, :max_keypoints]
    ky = idx // W
    kx = idx % W
    valid = scores > threshold

    offs = torch.arange(-r, r + 1, device=dev)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    py = _wrap_clamp(ky[..., None, None] + oy, H)
    px = _wrap_clamp(kx[..., None, None] + ox, W)
    flat = (py * W + px).reshape(N, -1)
    patch = torch.gather(score_map.reshape(N, H * W), 1, flat).reshape(N, max_keypoints, -1)
    w_soft = torch.softmax(patch / temperature, dim=-1).reshape(N, max_keypoints, win, win)
    dy = (w_soft * oy.float()).sum(dim=(-2, -1))
    dx = (w_soft * ox.float()).sum(dim=(-2, -1))
    kp = torch.stack([kx.float() + dx, ky.float() + dy], dim=-1)
    kp = torch.minimum(kp.clamp_min(0.0), torch.tensor([W - 1.0, H - 1.0], device=dev))
    return {"keypoints": kp, "scores": scores, "valid": valid}


def bilinear_sample(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """fmap (N, H, W, C); xy (N, ..., 2) pixel coordinates -> (N, ..., C).
    The coordinate is clamped into the image and the far neighbour taken as
    min(x0 + 1, W - 1), as the JAX package samples (not grid_sample's border
    rule)."""
    N, H, W, C = fmap.shape
    lead = xy.shape[1:-1]
    x = xy[..., 0].reshape(N, -1).clamp(0.0, W - 1.0)
    y = xy[..., 1].reshape(N, -1).clamp(0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = fmap.reshape(N, H * W, C)
    rows = torch.arange(N, device=fmap.device)[:, None]

    def at(yi, xi):
        return flat[rows, yi * W + xi]

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
           + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    return out.reshape((N,) + tuple(lead) + (C,))


def describe_keypoints(model: ALIKED, feature_map: torch.Tensor,
                       keypoints: torch.Tensor) -> torch.Tensor:
    """SDDH: feature map (N, H, W, dim), keypoints (N, K, 2) (x, y) ->
    descriptors (N, K, dim), L2-normalised."""
    head = model.desc_head
    k, m = head.k, head.m
    N, H, W, dim = feature_map.shape
    r = k // 2
    offs = torch.arange(-r, r + 1, dtype=torch.float32, device=feature_map.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    patch_offsets = torch.stack([ox, oy], dim=-1).reshape(-1, 2)  # (K*K, 2), iy outer
    patches = bilinear_sample(feature_map, keypoints[:, :, None, :] + patch_offsets)
    # the KxK offset conv on a KxK patch is one contraction over (iy, ix, c)
    conv1, conv2 = head.offset_conv[0], head.offset_conv[2]
    w1 = conv1.weight.permute(0, 2, 3, 1).reshape(2 * m, k * k * dim)
    off = F.selu(patches.reshape(N, -1, k * k * dim) @ w1.T + conv1.bias)
    off = off @ conv2.weight[:, :, 0, 0].T + conv2.bias
    pos = keypoints[:, :, None, :] + off.reshape(N, -1, m, 2)  # offsets in (x, y)
    samples = bilinear_sample(feature_map, pos)  # (N, K, M, dim)
    sf = samples @ head.sf_conv.weight[:, :, 0, 0].T
    desc = torch.einsum("nkmc,mcd->nkd", sf, head.agg_weights)
    return desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def aliked_extract(model: ALIKED, images: torch.Tensor,
                   max_keypoints: int = 1000) -> Dict[str, torch.Tensor]:
    """Full forward: images (N, 3, H, W) in [0, 1] or uint8 -> {'keypoints'
    (N, K, 2), 'descriptors' (N, K, dim), 'scores' (N, K), 'valid' (N, K)},
    at the model config's NMS radius and detection threshold."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    cfg = model.cfg
    feats, score = aliked_dense_maps(model, images.float())
    det = detect_keypoints(score, max_keypoints, cfg.nms_radius, cfg.detection_threshold)
    det["descriptors"] = describe_keypoints(model, feats, det["keypoints"])
    return det


# --- the JAX parameter tree (HWIO conv kernels) <-> the module


def _oihw(w) -> torch.Tensor:
    """HWIO kernel -> torch conv weight (out, in, kh, kw)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def _vec(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def aliked_state_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX tree (``init_aliked_params`` or a converted ``.npz``; a
    ``_model_name`` leaf is ignored) -> the module's state dict, which is in
    the lightglue naming. A bias the tree leaves out is zero, as the JAX
    convolutions treat it."""
    sd: Dict[str, torch.Tensor] = {}

    def bn(prefix, p):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{prefix}.{leaf}"] = _vec(p[leaf])
        sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    for b in range(1, 5):
        p = tree[f"block{b}"]
        for i in (1, 2):
            sd[f"block{b}.conv{i}.weight"] = _oihw(p[f"conv{i}_kernel"])
            bn(f"block{b}.bn{i}", p[f"conv{i}_bn"])
        if b > 1:
            w = _oihw(p["downsample_kernel"])
            sd[f"block{b}.downsample.weight"] = w
            sd[f"block{b}.downsample.bias"] = (_vec(p["downsample_bias"]) if "downsample_bias" in p
                                               else torch.zeros(w.shape[0]))
    for i in range(1, 5):
        sd[f"conv{i}.weight"] = _oihw(tree[f"conv{i}_kernel"])
        s = tree["score_head"]
        w = _oihw(s[f"conv{i}_kernel"])
        sd[f"score_head.{2 * (i - 1)}.weight"] = w
        bias = s.get(f"conv{i}_bias")
        sd[f"score_head.{2 * (i - 1)}.bias"] = _vec(bias) if bias is not None else torch.zeros(w.shape[0])
    for i, j in ((1, 0), (2, 2)):
        sd[f"desc_head.offset_conv.{j}.weight"] = _oihw(tree[f"offset_conv{i}_kernel"])
        sd[f"desc_head.offset_conv.{j}.bias"] = _vec(tree[f"offset_conv{i}_bias"])
    sd["desc_head.sf_conv.weight"] = _oihw(tree["sf_conv_kernel"])
    sd["desc_head.agg_weights"] = _vec(tree["agg_weights"])
    return sd


def build_aliked(cfg: ALIKEDConfig, state: Dict[str, torch.Tensor], device="cpu") -> ALIKED:
    """The module in eval mode, fp32, on ``device``."""
    model = ALIKED(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device=device, dtype=torch.float32).eval()


def init_aliked_params(seed: int, cfg: ALIKEDConfig = CONFIGS["aliked-n16"]) -> Dict[str, Any]:
    """Numpy copy of the JAX package's random init (the same values for the
    same seed): the parameter tree the converter writes."""
    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout, scale=None):
        std = scale or (1.0 / np.sqrt(kh * kw * cin))
        return (rng.random((kh, kw, cin, cout)).astype(np.float32) - 0.5) * 2 * std

    def bn(c):
        return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
                "running_mean": np.zeros(c, np.float32), "running_var": np.ones(c, np.float32)}

    def conv_block(cin, cout):
        return {"conv1_kernel": conv(3, 3, cin, cout), "conv1_bn": bn(cout),
                "conv2_kernel": conv(3, 3, cout, cout), "conv2_bn": bn(cout)}

    def res_block(cin, cout):
        return {**conv_block(cin, cout), "downsample_kernel": conv(1, 1, cin, cout),
                "downsample_bias": np.zeros(cout, np.float32)}

    d4 = cfg.dim // 4
    M = cfg.n_pos
    K = cfg.kernel_size
    return {
        "block1": conv_block(3, cfg.c1),
        "block2": res_block(cfg.c1, cfg.c2),
        "block3": res_block(cfg.c2, cfg.c3),
        "block4": res_block(cfg.c3, cfg.c4),
        "conv1_kernel": conv(1, 1, cfg.c1, d4),
        "conv2_kernel": conv(1, 1, cfg.c2, d4),
        "conv3_kernel": conv(1, 1, cfg.c3, d4),
        "conv4_kernel": conv(1, 1, cfg.dim, d4),
        "score_head": {
            "conv1_kernel": conv(1, 1, cfg.dim, 8), "conv1_bias": np.zeros(8, np.float32),
            "conv2_kernel": conv(3, 3, 8, 4), "conv2_bias": np.zeros(4, np.float32),
            "conv3_kernel": conv(3, 3, 4, 4), "conv3_bias": np.zeros(4, np.float32),
            "conv4_kernel": conv(3, 3, 4, 1), "conv4_bias": np.zeros(1, np.float32),
        },
        "offset_conv1_kernel": conv(K, K, cfg.dim, 2 * M),
        "offset_conv1_bias": np.zeros(2 * M, np.float32),
        "offset_conv2_kernel": conv(1, 1, 2 * M, 2 * M),
        "offset_conv2_bias": np.zeros(2 * M, np.float32),
        "sf_conv_kernel": conv(1, 1, cfg.dim, cfg.dim),
        "agg_weights": rng.random((M, cfg.dim, cfg.dim)).astype(np.float32) * 0.1,
    }
