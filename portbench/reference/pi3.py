"""Plain Pi3: the DINOv2-L/14-reg encoder, the alternating frame / global
decoder and the point, confidence and camera heads, in plain PyTorch.

The benchmark's reference for the port's ``models/pi3.py`` (Pi3, Wang et al.
2025, github.com/yyfz/Pi3; DINOv2, Oquab et al. 2023). It follows the same
equations with none of the port's kernels, fused producers, packed layouts
or meshes: every product is a float32 ``F.linear`` or ``matmul``, attention
is a row-blocked softmax(q k^T / sqrt(d)) v, the global blocks' kv-merge
averages k and v over groups of frames and attends the same way. The modules
carry the port's parameter names, so one state dict serves both.

``Precision`` switches the products of the transformer blocks (the model's
bf16 trunk) to a lower precision for the benchmark's control: inputs and
weights rounded to float8 e4m3 with one scale a tensor, and the fp32 parts
(the final heads, MoGe-2) in TF32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
QK_NORM_EPS = 1e-5
E4M3_MAX = 448.0
# the probe's relative noise on the camera head's input tokens: one bf16 unit
PROBE_NOISE = 2.0**-8
# query rows per attention block: (heads, rows, keys) logits in fp32 stay
# near 4 GB at 64,300 keys
ATTN_ROWS = 1024


@dataclass
class Precision:
    """fp8: the trunk's products on float8-rounded operands (the control)."""

    fp8: bool = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor, back in
    x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def linear(x, layer: nn.Linear, prec: Precision | None = None):
    w, b = layer.weight, layer.bias
    if prec is not None and prec.fp8:
        x, w = fp8_round(x), fp8_round(w)
    return F.linear(x, w, b)


def layer_norm(x, norm: nn.LayerNorm):
    return F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, norm.eps)


def softmax_attention(q, k, v, prec: Precision | None = None):
    """q (B, Tq, H, D), k and v (B, Tk, H, D) -> (B, Tq, H, D)."""
    if prec is not None and prec.fp8:
        q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))  # (B, H, T, D)
    out = torch.empty_like(qh)
    for s in range(0, qh.shape[2], ATTN_ROWS):
        logits = torch.matmul(qh[:, :, s : s + ATTN_ROWS], kh.transpose(-1, -2)) * scale
        out[:, :, s : s + ATTN_ROWS] = torch.matmul(torch.softmax(logits, dim=-1), vh)
        del logits
    return out.transpose(1, 2)


def rope_tables(positions, d: int, base: float):
    """(y, x) positions (B, T, 2) -> cos, sin (B, T, d): the head dim halves
    rotate by y and x, NeoX pairs (i, i + d/4) within each half."""
    dh = d // 2
    inv_freq = 1.0 / (base ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                            device=positions.device) / dh))
    ay = positions[..., 0, None].float() * inv_freq
    ax = positions[..., 1, None].float() * inv_freq
    cos = torch.cat([ay.cos(), ay.cos(), ax.cos(), ax.cos()], dim=-1)
    sin = torch.cat([ay.sin(), ay.sin(), ax.sin(), ax.sin()], dim=-1)
    return cos, sin


def apply_rope(x, cos, sin):
    q = x.shape[-1] // 4
    parts = x.unflatten(-1, (2, 2, q))
    rotated = torch.stack([-parts[..., 1, :], parts[..., 0, :]], dim=-2).flatten(-3)
    return x * cos[:, :, None] + rotated * sin[:, :, None]


def patch_positions(batch: int, h: int, w: int, num_special: int, offset: int, device):
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(h * w, 2) + offset
    grid = torch.cat([torch.zeros((num_special, 2), dtype=grid.dtype, device=device), grid])
    return grid[None].expand(batch, grid.shape[0], 2)


class Block(nn.Module):
    """x + ls1 * attn(norm1 x); x + ls2 * fc2(GELU(fc1(norm2 x)))."""

    def __init__(self, dim, num_heads, mlp_ratio=4, qk_norm=False, layerscale=False, eps=1e-6):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = nn.LayerNorm(dim, eps=eps, device="meta")
        self.qkv = nn.Linear(dim, 3 * dim, device="meta")
        self.proj = nn.Linear(dim, dim, device="meta")
        hd = dim // num_heads
        self.q_norm = nn.LayerNorm(hd, eps=QK_NORM_EPS, device="meta") if qk_norm else None
        self.k_norm = nn.LayerNorm(hd, eps=QK_NORM_EPS, device="meta") if qk_norm else None
        self.ls1 = nn.Parameter(torch.ones(dim, device="meta")) if layerscale else None
        self.norm2 = nn.LayerNorm(dim, eps=eps, device="meta")
        self.fc1 = nn.Linear(dim, dim * mlp_ratio, device="meta")
        self.fc2 = nn.Linear(dim * mlp_ratio, dim, device="meta")
        self.ls2 = nn.Parameter(torch.ones(dim, device="meta")) if layerscale else None

    def forward(self, x, rope=None, kv_merge=None, prec=None):
        """rope: (cos, sin) (B, T, head dim); kv_merge: (frames, tokens a
        frame, m): keys and values averaged over groups of m frames."""
        b, t, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = linear(layer_norm(x, self.norm1), self.qkv, prec).view(b, t, 3, h, d).unbind(2)
        if self.q_norm is not None:
            q, k = layer_norm(q, self.q_norm), layer_norm(k, self.k_norm)
        if rope is not None:
            q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        if kv_merge is not None:
            nf, tpf, m = kv_merge
            k, v = (a.reshape(b, nf // m, m, tpf, h, d).mean(dim=2).reshape(b, -1, h, d)
                    for a in (k, v))
        a = linear(softmax_attention(q, k, v, prec).reshape(b, t, c), self.proj, prec)
        x = x + (a * self.ls1 if self.ls1 is not None else a)
        hdn = F.gelu(linear(layer_norm(x, self.norm2), self.fc1, prec))
        m_out = linear(hdn, self.fc2, prec)
        return x + (m_out * self.ls2 if self.ls2 is not None else m_out)


class Encoder(nn.Module):
    """DINOv2: patch embedding (the stride-14 convolution as patchify +
    linear), cls, interpolated position embedding, registers, blocks, norm."""

    def __init__(self, enc: dict):
        super().__init__()
        self.cfg = enc
        c = enc["embed_dim"]
        p = enc["patch_size"]
        self.patch_embed = nn.Linear(3 * p * p, c, device="meta")
        self.cls_token = nn.Parameter(torch.zeros(1, c, device="meta"))
        self.pos_embed = nn.Parameter(torch.zeros(enc["pos_embed_size"] ** 2 + 1, c,
                                                  device="meta"))
        self.register_tokens = nn.Parameter(torch.zeros(enc["num_register_tokens"], c,
                                                        device="meta"))
        self.blocks = nn.ModuleList(
            Block(c, enc["num_heads"], enc["mlp_ratio"], layerscale=True, eps=enc["norm_eps"])
            for _ in range(enc["depth"]))
        self.norm = nn.LayerNorm(c, eps=enc["norm_eps"], device="meta")

    def embed(self, images, prec=None):
        enc = self.cfg
        p = enc["patch_size"]
        b, ch, H, W = images.shape
        h, w = H // p, W // p
        patches = images.reshape(b, ch, h, p, w, p).permute(0, 2, 4, 1, 3, 5).reshape(b, h * w, -1)
        tokens = linear(patches, self.patch_embed, prec)
        x = torch.cat([self.cls_token.expand(b, 1, -1), tokens], dim=1)
        m = enc["pos_embed_size"]
        pos = self.pos_embed
        grid = pos[1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
        if (h, w) == (m, m):
            patch_pos = pos[1:]
        else:
            off = enc["interpolate_offset"]
            if off:
                out = F.interpolate(grid, scale_factor=((h + off) / m, (w + off) / m),
                                    mode="bicubic", antialias=enc["interpolate_antialias"])
            else:
                out = F.interpolate(grid, size=(h, w), mode="bicubic",
                                    antialias=enc["interpolate_antialias"])
            patch_pos = out.permute(0, 2, 3, 1).reshape(h * w, -1)
        x = x + torch.cat([pos[:1], patch_pos])[None]
        r = enc["num_register_tokens"]
        if r:
            x = torch.cat([x[:, :1], self.register_tokens.expand(b, r, -1), x[:, 1:]], dim=1)
        return x

    def forward(self, images, prec=None):
        x = self.embed(images, prec)
        for blk in self.blocks:
            x = blk(x, prec=prec)
        return layer_norm(x, self.norm)[:, self.cfg["num_register_tokens"] + 1:]

    def intermediate_layers(self, images, n: int, prec=None):
        """[(patch tokens, cls)] of the last n blocks, each through the norm."""
        x = self.embed(images, prec)
        depth = len(self.blocks)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, prec=prec)
            if i >= depth - n:
                y = layer_norm(x, self.norm)
                outs.append((y[:, self.cfg["num_register_tokens"] + 1:], y[:, 0]))
        return outs


class HeadDecoder(nn.Module):
    def __init__(self, in_dim, dim, out_dim, depth, num_heads, mlp_ratio, eps):
        super().__init__()
        self.project = nn.Linear(in_dim, dim, device="meta")
        self.blocks = nn.ModuleList(Block(dim, num_heads, mlp_ratio, eps=eps)
                                    for _ in range(depth))
        self.out = nn.Linear(dim, out_dim, device="meta")


class ResConv(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc1 = nn.Linear(d, d, device="meta")
        self.fc2 = nn.Linear(d, d, device="meta")
        self.fc3 = nn.Linear(d, d, device="meta")


class CameraHead(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.res_conv = nn.ModuleList(ResConv(d) for _ in range(2))
        self.mlp1 = nn.Linear(d, d, device="meta")
        self.mlp2 = nn.Linear(d, d, device="meta")
        self.fc_t = nn.Linear(d, 3, device="meta")
        self.fc_rot = nn.Linear(d, 9, device="meta")


def tokens_to_image(tokens, gh: int, gw: int, p: int, ch: int):
    b = tokens.shape[0]
    x = tokens.reshape(b, gh, gw, ch, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, gh * p, gw * p, ch)


def svd_orthogonalize(m):
    """9D -> SO(3): rows normalised, the closest rotation to the transpose."""
    m = m.reshape(m.shape[:-1] + (3, 3))
    m = m / torch.linalg.norm(m, dim=-1, keepdim=True).clamp_min(1e-12)
    u, _, vh = torch.linalg.svd(m.transpose(-1, -2), full_matrices=False)
    v = vh.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(v @ ut)
    v = torch.cat([v[..., :, :-1], v[..., :, -1:] * det[..., None, None]], dim=-1)
    return v @ ut


class Pi3(nn.Module):
    """``model``: the configuration file's ``model`` (``Pi3Config`` keys)."""

    def __init__(self, model: dict):
        super().__init__()
        self.cfg = model
        c = model["dec_embed_dim"]
        enc = dict(model["encoder"], patch_size=model["patch_size"])
        self.encoder = Encoder(enc)
        self.register_token = nn.Parameter(torch.zeros(model["num_register_tokens"], c,
                                                       device="meta"))
        self.decoder = nn.ModuleList(
            Block(c, model["dec_num_heads"], model["mlp_ratio"], qk_norm=True, layerscale=True,
                  eps=model["norm_eps"]) for _ in range(model["dec_depth"]))

        def head(out_dim):
            return HeadDecoder(2 * c, model["head_dim"], out_dim, model["head_depth"],
                               model["head_num_heads"], model["mlp_ratio"], model["norm_eps"])

        p = model["patch_size"]
        self.point_decoder = head(model["head_dim"])
        self.conf_decoder = head(model["head_dim"])
        self.camera_decoder = head(model["camera_dim"])
        self.point_head = nn.Linear(model["head_dim"], 3 * p * p, device="meta")
        self.conf_head = nn.Linear(model["head_dim"], p * p, device="meta")
        self.camera_head = CameraHead(model["camera_dim"])

    def forward(self, imgs, prec: Precision | None = None):
        """(B, N, 3, H, W) in [0, 1] -> points, local_points (B, N, H, W, 3),
        conf (B, N, H, W, 1), camera_poses (B, N, 4, 4), and
        camera_poses_probe: the camera head again on its input tokens with a
        bf16 unit of noise (random signs from a fixed generator), which
        measures how far rounding of that size moves each pose."""
        cfg = self.cfg
        B, N, _, H, W = imgs.shape
        p = cfg["patch_size"]
        gh, gw = H // p, W // p
        mean = torch.tensor(IMAGE_MEAN, device=imgs.device).reshape(1, 1, 3, 1, 1)
        std = torch.tensor(IMAGE_STD, device=imgs.device).reshape(1, 1, 3, 1, 1)
        hidden = self.encoder(((imgs - mean) / std).reshape(B * N, 3, H, W), prec)
        bn, hw, c = hidden.shape
        reg = cfg["num_register_tokens"]
        x = torch.cat([self.register_token.expand(bn, reg, c), hidden], dim=1)
        t = hw + reg
        pos = patch_positions(bn, gh, gw, reg, 1, imgs.device)
        heads = cfg["dec_num_heads"]
        rope = rope_tables(pos, c // heads, cfg["rope_base"])
        rope_global = (rope[0].reshape(B, N * t, -1), rope[1].reshape(B, N * t, -1))
        m = cfg.get("global_kv_merge", 1)
        merge = (N, t, m) if m > 1 and N % m == 0 else None
        x_frame = x
        for i in range(0, cfg["dec_depth"], 2):
            x_frame = self.decoder[i](x, rope=rope, prec=prec)
            x = self.decoder[i + 1](x_frame.reshape(B, N * t, c), rope=rope_global,
                                    kv_merge=merge, prec=prec).reshape(bn, t, c)
        hidden_cat = torch.cat([x_frame, x], dim=-1)
        del x, x_frame, hidden

        def run_head(dec):
            h = linear(hidden_cat, dec.project, prec)
            r = rope_tables(pos, h.shape[-1] // cfg["head_num_heads"], cfg["rope_base"])
            for blk in dec.blocks:
                h = blk(h, rope=r, prec=prec)
            return linear(h, dec.out, prec)[:, reg:]

        out_prec = Precision() if prec is None else prec
        with allow_tf32(out_prec.fp8):
            pts = tokens_to_image(linear(run_head(self.point_decoder), self.point_head),
                                  gh, gw, p, 3).reshape(B, N, H, W, 3)
            xy, z = pts[..., :2], torch.exp(pts[..., 2:])
            local = torch.cat([xy * z, z], dim=-1)
            conf = tokens_to_image(linear(run_head(self.conf_decoder), self.conf_head),
                                   gh, gw, p, 1).reshape(B, N, H, W, 1)
            cam = run_head(self.camera_decoder)
            poses = self._camera(cam).reshape(B, N, 4, 4)
            g = torch.Generator(device=cam.device).manual_seed(0)
            sign = torch.randint(0, 2, cam.shape, generator=g, device=cam.device) * 2 - 1
            probe = self._camera(cam * (1 + PROBE_NOISE * sign)).reshape(B, N, 4, 4)
        points = torch.einsum("bnij,bnhwj->bnhwi", poses,
                              torch.cat([local, torch.ones_like(local[..., :1])], dim=-1))[..., :3]
        return {"points": points, "local_points": local, "conf": conf, "camera_poses": poses,
                "camera_poses_probe": probe}

    def _camera(self, feat):
        cam = self.camera_head
        x = feat
        for rc in cam.res_conv:
            h = torch.relu(linear(x, rc.fc1))
            h = torch.relu(linear(h, rc.fc2))
            h = torch.relu(linear(h, rc.fc3))
            x = x + h
        h = torch.relu(linear(torch.relu(linear(x.mean(dim=1), cam.mlp1)), cam.mlp2))
        R = svd_orthogonalize(linear(h, cam.fc_rot))
        pose = torch.zeros((feat.shape[0], 4, 4), dtype=torch.float32, device=feat.device)
        pose[:, :3, :3] = R
        pose[:, :3, 3] = linear(h, cam.fc_t)
        pose[:, 3, 3] = 1.0
        return pose


class allow_tf32:
    """Allow TF32 in cuBLAS and cuDNN inside the block where ``on``; the
    reference itself always runs with both off."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
