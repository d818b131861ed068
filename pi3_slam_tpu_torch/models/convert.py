"""Parameter conversion between the JAX package's Pi3 and MoGe-2 parameter
trees and this port's ``Pi3`` and ``MoGe`` modules.

* :func:`pi3_state_from_jax` turns the JAX tree (numpy leaves, as
  ``pi3_slam_tpu.models.init_pi3_params`` or ``load_params_npz`` give it;
  linear kernels (in, out), block stacks with a leading layer axis) into the
  port's ``state_dict`` (``nn.Linear`` weights (out, in), one module per
  block).
* :func:`load_pi3_checkpoint` reads the JAX package's ``.npz`` checkpoint
  format, including the embedded ``_pi3_config_json``.
* :func:`init_pi3_params` is a numpy copy of the JAX random init (same
  values for the same integer seed), so a full-width model with random
  weights needs no JAX.
* :func:`moge_state_from_jax`, :func:`load_moge_checkpoint` and
  :func:`init_moge_params` do the same for MoGe-2 (conv kernels HWIO ->
  OIHW); :func:`save_params_npz` writes either tree in the JAX package's
  ``.npz`` format, and :func:`moge_vits_config` is the configuration of
  random-weight MoGe-2 runs.
* :func:`cross_block_state_from_jax` and :func:`init_cross_block_params` do
  the same for the cross-attention block (``models/cross_attention.py``);
  no cross-block checkpoint is in the repository, so runs use the random
  tree, and :func:`build_cross_block` makes the module from a state dict.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .cross_attention import CrossBlock
from .dinov2 import DinoV2Config
from .moge_model import ConvStackConfig, MoGe, MoGeConfig
from .pi3 import Pi3, Pi3Config

# JAX block leaf -> port parameter name (kernels are transposed)
_BLOCK_LEAVES = {
    "norm1_scale": "norm1.weight",
    "norm1_bias": "norm1.bias",
    "qkv_kernel": "qkv.weight",
    "qkv_bias": "qkv.bias",
    "proj_kernel": "proj.weight",
    "proj_bias": "proj.bias",
    "ls1": "ls1",
    "q_norm_scale": "q_norm.weight",
    "q_norm_bias": "q_norm.bias",
    "k_norm_scale": "k_norm.weight",
    "k_norm_bias": "k_norm.bias",
    "norm2_scale": "norm2.weight",
    "norm2_bias": "norm2.bias",
    "fc1_kernel": "fc1.weight",
    "fc1_bias": "fc1.bias",
    "fc2_kernel": "fc2.weight",
    "fc2_bias": "fc2.bias",
    "ls2": "ls2",
}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _linear(sd: dict, name: str, kernel, bias) -> None:
    sd[f"{name}.weight"] = _tensor(np.asarray(kernel, dtype=np.float32).T)
    sd[f"{name}.bias"] = _tensor(bias)


def _blocks(sd: dict, prefix: str, stacked: Dict[str, Any], indices) -> None:
    for layer, idx in enumerate(indices):
        for leaf, name in _BLOCK_LEAVES.items():
            if leaf not in stacked:
                continue
            a = np.asarray(stacked[leaf][layer], dtype=np.float32)
            sd[f"{prefix}.{idx}.{name}"] = _tensor(a.T if leaf.endswith("_kernel") else a)


def _dinov2(sd: dict, prefix: str, enc: Dict[str, Any]) -> None:
    _linear(sd, f"{prefix}.patch_embed", enc["patch_embed_kernel"], enc["patch_embed_bias"])
    for leaf in ("cls_token", "pos_embed", "register_tokens"):
        sd[f"{prefix}.{leaf}"] = _tensor(enc[leaf])
    sd[f"{prefix}.norm.weight"] = _tensor(enc["norm_scale"])
    sd[f"{prefix}.norm.bias"] = _tensor(enc["norm_bias"])
    depth = len(enc["blocks"]["qkv_kernel"])
    _blocks(sd, f"{prefix}.blocks", enc["blocks"], range(depth))


def pi3_state_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Pi3 parameter tree -> ``Pi3`` state_dict (fp32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    _dinov2(sd, "encoder", tree["encoder"])

    dec = tree["decoder"]
    sd["register_token"] = _tensor(dec["register_token"])
    pairs = len(dec["even_blocks"]["qkv_kernel"])
    _blocks(sd, "decoder", dec["even_blocks"], range(0, 2 * pairs, 2))
    _blocks(sd, "decoder", dec["odd_blocks"], range(1, 2 * pairs, 2))

    for name in ("point_decoder", "conf_decoder", "camera_decoder"):
        hd = tree[name]
        _linear(sd, f"{name}.project", hd["project_kernel"], hd["project_bias"])
        _blocks(sd, f"{name}.blocks", hd["blocks"], range(len(hd["blocks"]["qkv_kernel"])))
        _linear(sd, f"{name}.out", hd["out_kernel"], hd["out_bias"])
    for name in ("point_head", "conf_head"):
        _linear(sd, name, tree[name]["kernel"], tree[name]["bias"])

    cam = tree["camera_head"]
    for i in range(2):
        rc = cam[f"res_conv{i}"]
        for j in (1, 2, 3):
            _linear(sd, f"camera_head.res_conv.{i}.fc{j}", rc[f"fc{j}_kernel"], rc[f"fc{j}_bias"])
    for name in ("mlp1", "mlp2", "fc_t", "fc_rot"):
        _linear(sd, f"camera_head.{name}", cam[f"{name}_kernel"], cam[f"{name}_bias"])
    return sd


def build_pi3(
    cfg: Pi3Config, state: Dict[str, torch.Tensor], device: torch.device, dtype: torch.dtype
) -> Pi3:
    """A ``Pi3`` holding ``state`` on ``device`` in ``dtype`` (built on the
    meta device, so no throw-away random init is paid for)."""
    model = Pi3(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device=device, dtype=dtype).eval()


def _conv(sd: dict, name: str, p: Dict[str, Any], leaf: str = "") -> None:
    """A JAX HWIO conv kernel (kh, kw, in, out) -> torch OIHW, and its bias."""
    kernel = np.asarray(p[f"{leaf}kernel"], dtype=np.float32)
    sd[f"{name}.weight"] = _tensor(kernel.transpose(3, 2, 0, 1))
    sd[f"{name}.bias"] = _tensor(p[f"{leaf}bias"])


def _conv_stack(sd: dict, prefix: str, p: Dict[str, Any]) -> None:
    for kind in ("input_blocks", "output_blocks"):
        for i, conv in enumerate(p[kind]):
            if conv is not None:
                _conv(sd, f"{prefix}.{kind}.{i}", conv)
    for i, level in enumerate(p["res_blocks"]):
        for j, blk in enumerate(level):
            name = f"{prefix}.res_blocks.{i}.{j}"
            _conv(sd, f"{name}.conv1", blk, "conv1_")
            _conv(sd, f"{name}.conv2", blk, "conv2_")
            for norm in ("norm1", "norm2"):
                if f"{norm}_scale" in blk:
                    sd[f"{name}.{norm}.weight"] = _tensor(blk[f"{norm}_scale"])
                    sd[f"{name}.{norm}.bias"] = _tensor(blk[f"{norm}_bias"])
    for i, res in enumerate(p["resamplers"]):
        _conv(sd, f"{prefix}.resamplers.{i}.conv1", res, "conv1_")
        _conv(sd, f"{prefix}.resamplers.{i}.conv2", res, "conv2_")


def moge_state_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MoGe-2 parameter tree (``convert_moge_state_dict``'s layout:
    HWIO conv kernels, (in, out) linears, stacked backbone blocks) -> ``MoGe``
    state_dict (fp32 CPU tensors). ``_config_json`` is ignored."""
    sd: Dict[str, torch.Tensor] = {}
    _dinov2(sd, "backbone", tree["backbone"])
    for i, proj in enumerate(tree["output_projections"]):
        _conv(sd, f"output_projections.{i}", proj)
    for stack in ("neck", "points_head", "mask_head", "normal_head"):
        if tree.get(stack) is not None:
            _conv_stack(sd, stack, tree[stack])
    for i, lin in enumerate(tree.get("scale_head") or []):
        _linear(sd, f"scale_head.{i}", lin["kernel"], lin["bias"])
    return sd


def build_moge(
    cfg: MoGeConfig,
    state: Dict[str, torch.Tensor],
    device: torch.device,
    trunk_dtype: torch.dtype = torch.float32,
) -> MoGe:
    """A ``MoGe`` holding ``state`` on ``device``: everything in fp32 but the
    encoder blocks, which are held in ``trunk_dtype`` (the runner keeps fp32,
    as the JAX runner computes; on the GPU they run through the hand-written
    kernels in either dtype)."""
    model = MoGe(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    model = model.to(device=device, dtype=torch.float32).eval()
    model.backbone.blocks.to(trunk_dtype)
    return model


def save_params_npz(path: str, tree: Dict[str, Any]) -> None:
    """Write a parameter tree in the JAX package's ``save_params_npz`` format
    ('/'-joined keys, '#<i>' list segments, '__none__' markers)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/#{i}")
        elif node is None:
            flat[f"{prefix}/__none__"] = np.int8(1)
        else:
            flat[prefix] = np.asarray(node)

    walk(tree, "")
    np.savez(path, **flat)


def load_params_npz(path: str) -> Dict[str, Any]:
    """Read a flattened '/'-keyed param tree (the JAX package's
    ``save_params_npz`` format: '#<i>' list segments, '__none__' markers)."""
    flat = np.load(path)
    out: Dict[str, Any] = {}
    for key in flat.files:
        parts = key.split("/")
        is_none = parts[-1] == "__none__"
        if is_none:
            parts = parts[:-1]
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = None if is_none else flat[key]

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.startswith("#") for k in node):
                items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
                return [listify(v) for _, v in items]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(out)


def load_pi3_checkpoint(path: str):
    """Load a Pi3 ``.npz`` checkpoint -> (JAX-layout param tree,
    Pi3Config | None from the embedded '_pi3_config_json')."""
    params = load_params_npz(path)
    cfg_json = params.pop("_pi3_config_json", None)
    cfg = Pi3Config.from_json(str(cfg_json)) if cfg_json is not None else None
    return params, cfg


def load_moge_checkpoint(path: str):
    """Load a MoGe-2 ``.npz`` (as ``tools/convert_checkpoint.py --model moge``
    writes it) -> (JAX-layout param tree, MoGeConfig from its '_config_json')."""
    params = load_params_npz(path)
    cfg = MoGeConfig.from_params(params)
    params.pop("_config_json")
    return params, cfg


def _trunc(rng: np.random.Generator, shape, std=0.02) -> np.ndarray:
    # uniform with the std of the JAX init (one float32 pass)
    return (rng.random(shape, dtype=np.float32) - 0.5) * (std * 3.4641016)


def _init_dinov2(seed: int, cfg: DinoV2Config) -> Dict[str, Any]:
    c = cfg.embed_dim
    hidden = c * cfg.mlp_ratio
    L = cfg.depth
    rng = np.random.default_rng(seed)
    blocks = {
        "norm1_scale": np.ones((L, c), np.float32),
        "norm1_bias": np.zeros((L, c), np.float32),
        "qkv_kernel": _trunc(rng, (L, c, 3 * c)),
        "qkv_bias": np.zeros((L, 3 * c), np.float32),
        "proj_kernel": _trunc(rng, (L, c, c)),
        "proj_bias": np.zeros((L, c), np.float32),
        "ls1": np.ones((L, c), np.float32),
        "norm2_scale": np.ones((L, c), np.float32),
        "norm2_bias": np.zeros((L, c), np.float32),
        "fc1_kernel": _trunc(rng, (L, c, hidden)),
        "fc1_bias": np.zeros((L, hidden), np.float32),
        "fc2_kernel": _trunc(rng, (L, hidden, c)),
        "fc2_bias": np.zeros((L, c), np.float32),
        "ls2": np.ones((L, c), np.float32),
    }
    return {
        "patch_embed_kernel": _trunc(rng, (3 * cfg.patch_size**2, c)),
        "patch_embed_bias": np.zeros((c,), np.float32),
        "cls_token": _trunc(rng, (1, c), std=1e-6),
        "pos_embed": _trunc(rng, (cfg.pos_embed_size**2 + 1, c)),
        "register_tokens": _trunc(rng, (cfg.num_register_tokens, c), std=1e-6),
        "blocks": blocks,
        "norm_scale": np.ones((c,), np.float32),
        "norm_bias": np.zeros((c,), np.float32),
    }


def _init_block_stack(seed, L, dim, mlp_ratio, qk_norm, layerscale_init, num_heads=16):
    hidden = dim * mlp_ratio
    rng = np.random.default_rng(seed)
    blocks = {
        "norm1_scale": np.ones((L, dim), np.float32),
        "norm1_bias": np.zeros((L, dim), np.float32),
        "qkv_kernel": _trunc(rng, (L, dim, 3 * dim)),
        "qkv_bias": np.zeros((L, 3 * dim), np.float32),
        "proj_kernel": _trunc(rng, (L, dim, dim)),
        "proj_bias": np.zeros((L, dim), np.float32),
        "norm2_scale": np.ones((L, dim), np.float32),
        "norm2_bias": np.zeros((L, dim), np.float32),
        "fc1_kernel": _trunc(rng, (L, dim, hidden)),
        "fc1_bias": np.zeros((L, hidden), np.float32),
        "fc2_kernel": _trunc(rng, (L, hidden, dim)),
        "fc2_bias": np.zeros((L, dim), np.float32),
    }
    if qk_norm:
        hd = dim // num_heads
        blocks["q_norm_scale"] = np.ones((L, hd), np.float32)
        blocks["k_norm_scale"] = np.ones((L, hd), np.float32)
        blocks["q_norm_bias"] = np.zeros((L, hd), np.float32)
        blocks["k_norm_bias"] = np.zeros((L, hd), np.float32)
    if layerscale_init is not None:
        blocks["ls1"] = np.full((L, dim), layerscale_init, np.float32)
        blocks["ls2"] = np.full((L, dim), layerscale_init, np.float32)
    return blocks


def _init_head_decoder(seed, in_dim, dim, out_dim, depth, mlp_ratio):
    rng = np.random.default_rng(seed)
    return {
        "project_kernel": _trunc(rng, (in_dim, dim)),
        "project_bias": np.zeros((dim,), np.float32),
        "blocks": _init_block_stack(seed + 1, depth, dim, mlp_ratio, False, None),
        "out_kernel": _trunc(rng, (dim, out_dim)),
        "out_bias": np.zeros((out_dim,), np.float32),
    }


def _init_camera_head(seed: int, d: int) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)

    def trunc(shape, std=0.02):
        return np.clip(rng.standard_normal(shape), -2, 2).astype(np.float32) * std

    out: Dict[str, Any] = {}
    for i in range(2):
        out[f"res_conv{i}"] = {
            "fc1_kernel": trunc((d, d)),
            "fc1_bias": np.zeros((d,), np.float32),
            "fc2_kernel": trunc((d, d)),
            "fc2_bias": np.zeros((d,), np.float32),
            "fc3_kernel": trunc((d, d)),
            "fc3_bias": np.zeros((d,), np.float32),
        }
    out.update(
        mlp1_kernel=trunc((d, d)),
        mlp1_bias=np.zeros((d,), np.float32),
        mlp2_kernel=trunc((d, d)),
        mlp2_bias=np.zeros((d,), np.float32),
        fc_t_kernel=trunc((d, 3)),
        fc_t_bias=np.zeros((3,), np.float32),
        fc_rot_kernel=trunc((d, 9)),
        fc_rot_bias=np.zeros((9,), np.float32),
    )
    return out


def init_pi3_params(seed: int, cfg: Pi3Config = Pi3Config()) -> Dict[str, Any]:
    """Random Pi3 parameter tree in the JAX layout (numpy float32 leaves),
    identical to ``pi3_slam_tpu.models.init_pi3_params(seed, cfg)``. Values
    only matter for tests and smoke runs; real use loads a checkpoint."""
    c = cfg.dec_embed_dim
    keys = [seed * 31 + i for i in range(10)]
    pairs = cfg.dec_depth // 2
    rng = np.random.default_rng(keys[3])
    psz = cfg.patch_size
    return {
        "encoder": _init_dinov2(keys[2], cfg.encoder),
        "decoder": {
            "register_token": _trunc(rng, (cfg.num_register_tokens, c), std=1e-6),
            "even_blocks": _init_block_stack(
                keys[0], pairs, c, cfg.mlp_ratio, True, 0.01, cfg.dec_num_heads
            ),
            "odd_blocks": _init_block_stack(
                keys[1], pairs, c, cfg.mlp_ratio, True, 0.01, cfg.dec_num_heads
            ),
        },
        "point_decoder": _init_head_decoder(
            keys[4], 2 * c, cfg.head_dim, cfg.head_dim, cfg.head_depth, cfg.mlp_ratio
        ),
        "conf_decoder": _init_head_decoder(
            keys[5], 2 * c, cfg.head_dim, cfg.head_dim, cfg.head_depth, cfg.mlp_ratio
        ),
        "camera_decoder": _init_head_decoder(
            keys[6], 2 * c, cfg.head_dim, cfg.camera_dim, cfg.head_depth, cfg.mlp_ratio
        ),
        "point_head": {
            "kernel": _trunc(rng, (cfg.head_dim, 3 * psz * psz)),
            "bias": np.zeros((3 * psz * psz,), np.float32),
        },
        "conf_head": {
            "kernel": _trunc(rng, (cfg.head_dim, psz * psz)),
            "bias": np.zeros((psz * psz,), np.float32),
        },
        "camera_head": _init_camera_head(keys[7], cfg.camera_dim),
    }


def moge_vits_config(num_tokens_range: Tuple[int, int] = (1200, 3600)) -> MoGeConfig:
    """MoGe-2 with the full-width ViT-S/14 backbone, for random-weight runs.

    The published ``moge-2-vits-normal`` neck and head widths are not in the
    repository, so the neck and heads take those of the JAX package's
    ``tests/test_moge_parity.py`` (encoder ``dim_out`` 64, no normal head).
    A converted checkpoint carries its own config instead."""

    def stack(dim_in, dims, dim_out):
        return ConvStackConfig(dim_in=dim_in, dim_res_blocks=dims, dim_out=dim_out,
                               resamplers=("pixel_shuffle",) * (len(dims) - 1))

    return MoGeConfig(
        backbone="dinov2_vits14", intermediate_layers=4, encoder_dim_out=64,
        neck=stack((66, 2, 2, 2, 2), (64, 64, 32, 32, 32), (None,) * 5),
        points_head=stack((64, 64, 32, 32, 32), (64, 32, 32, 32, 32), (None,) * 4 + (3,)),
        mask_head=stack((64, 64, 32, 32, 32), (32, 32, 32, 32, 32), (None,) * 4 + (1,)),
        normal_head=None, scale_head_dims=(384, 64, 1), num_tokens_range=tuple(num_tokens_range),
    )


def _init_conv_stack(rng: np.random.Generator, cfg: ConvStackConfig) -> Dict[str, Any]:
    def conv(k, c_in, c_out, prefix=""):
        return {f"{prefix}kernel": _trunc(rng, (k, k, c_in, c_out), std=(k * k * c_in) ** -0.5),
                f"{prefix}bias": np.zeros((c_out,), np.float32)}

    def res_block(c):
        hidden = cfg.dim_times_res_block_hidden * c
        blk = {**conv(3, c, hidden, "conv1_"), **conv(3, hidden, c, "conv2_")}
        for norm, kind, width in (("norm1", cfg.res_block_in_norm, c),
                                  ("norm2", cfg.res_block_hidden_norm, hidden)):
            if kind != "none":
                blk[f"{norm}_scale"] = np.ones((width,), np.float32)
                blk[f"{norm}_bias"] = np.zeros((width,), np.float32)
        return blk

    dims = cfg.dim_res_blocks
    return {
        "input_blocks": [None if c_in is None else conv(1, c_in, c) for c_in, c in zip(cfg.dim_in, dims)],
        "res_blocks": [[res_block(c) for _ in range(cfg.num_blocks_at(i))] for i, c in enumerate(dims)],
        "resamplers": [{**conv(3, a, 4 * b, "conv1_"), **conv(3, b, b, "conv2_")}
                       for a, b in zip(dims[:-1], dims[1:])],
        "output_blocks": [None if c_out is None else conv(1, c, c_out)
                          for c_out, c in zip(cfg.dim_out, dims)],
    }


def init_moge_params(seed: int, cfg: MoGeConfig) -> Dict[str, Any]:
    """Random MoGe-2 parameter tree in the JAX layout, with its
    '_config_json', from a numpy seed (no MoGe checkpoint is in the
    repository; values only matter for tests and smoke runs).
    ``save_params_npz`` of it is a checkpoint that both packages load."""
    rng = np.random.default_rng(seed)
    enc = cfg.encoder_cfg
    params: Dict[str, Any] = {
        "backbone": _init_dinov2(seed + 1, enc),
        "output_projections": [
            {"kernel": _trunc(rng, (1, 1, enc.embed_dim, cfg.encoder_dim_out), std=enc.embed_dim**-0.5),
             "bias": np.zeros((cfg.encoder_dim_out,), np.float32)}
            for _ in range(cfg.num_projections)
        ],
        "neck": _init_conv_stack(rng, cfg.neck),
        "_config_json": np.asarray(cfg.to_json()),
    }
    for head in ("points_head", "mask_head", "normal_head"):
        if getattr(cfg, head) is not None:
            params[head] = _init_conv_stack(rng, getattr(cfg, head))
    if cfg.scale_head_dims is not None:
        dims = cfg.scale_head_dims
        params["scale_head"] = [
            {"kernel": _trunc(rng, (a, b), std=a**-0.5), "bias": np.zeros((b,), np.float32)}
            for a, b in zip(dims[:-1], dims[1:])
        ]
    return params


def _norm(sd: dict, name: str, p: Dict[str, Any], leaf: str) -> None:
    sd[f"{name}.weight"] = _tensor(p[f"{leaf}_scale"])
    sd[f"{name}.bias"] = _tensor(p[f"{leaf}_bias"])


def cross_block_state_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX cross-block parameter tree (``pi3_slam_tpu.models.cross_attention``
    layout: top-level norms and LayerScales, ``self_attn``, ``cross_attn``
    and ``mlp`` sub-trees, (in, out) kernels) -> ``CrossBlock`` state_dict
    (fp32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    for norm in ("norm1", "norm2", "norm_y", "norm3"):
        _norm(sd, norm, tree, norm)
    for prefix, sub, projections in (("attn", "self_attn", ("qkv", "proj")),
                                     ("cross_attn", "cross_attn", ("q", "k", "v", "proj"))):
        p = tree[sub]
        for proj in projections:
            name = f"{prefix}.{proj}" if proj in ("qkv", "proj") else f"{prefix}.{proj}_proj"
            _linear(sd, name, p[f"{proj}_kernel"], p[f"{proj}_bias"])
        if "q_norm_scale" in p:
            _norm(sd, f"{prefix}.q_norm", p, "q_norm")
            _norm(sd, f"{prefix}.k_norm", p, "k_norm")
    for fc in ("fc1", "fc2"):
        _linear(sd, f"mlp.{fc}", tree["mlp"][f"{fc}_kernel"], tree["mlp"][f"{fc}_bias"])
    for ls in ("ls1", "ls_y", "ls2"):
        if ls in tree:
            sd[ls] = _tensor(tree[ls])
    return sd


def build_cross_block(
    state: Dict[str, torch.Tensor], num_heads: int, device: torch.device, dtype: torch.dtype
) -> CrossBlock:
    """A ``CrossBlock`` holding ``state`` on ``device`` in ``dtype``; its
    width, MLP ratio, qk-norm and LayerScale are read from the state."""
    dim = state["norm1.weight"].shape[0]
    block = CrossBlock(dim, num_heads, state["mlp.fc1.weight"].shape[0] // dim,
                       qk_norm="attn.q_norm.weight" in state, layerscale="ls1" in state,
                       device="meta")
    block.load_state_dict(state, strict=True, assign=True)
    return block.to(device=device, dtype=dtype).eval()


def init_cross_block_params(
    seed: int,
    dim: int,
    num_heads: int,
    mlp_ratio: int = 4,
    qk_norm: bool = True,
    layerscale: float | None = 0.01,
) -> Dict[str, Any]:
    """Random cross-block parameter tree in the JAX layout (numpy float32
    leaves) from a numpy seed: kernels of std 0.02, zero biases, unit
    norms, LayerScale ``layerscale`` (None: no LayerScale)."""
    rng = np.random.default_rng(seed)
    hidden = dim * mlp_ratio
    hd = dim // num_heads

    def linears(names, widths):
        out = {}
        for name, (a, b) in zip(names, widths):
            out[f"{name}_kernel"] = _trunc(rng, (a, b))
            out[f"{name}_bias"] = np.zeros((b,), np.float32)
        if qk_norm:
            for n in ("q_norm", "k_norm"):
                out[f"{n}_scale"] = np.ones((hd,), np.float32)
                out[f"{n}_bias"] = np.zeros((hd,), np.float32)
        return out

    tree: Dict[str, Any] = {
        "self_attn": linears(("qkv", "proj"), ((dim, 3 * dim), (dim, dim))),
        "cross_attn": linears(("q", "k", "v", "proj"), ((dim, dim),) * 4),
        "mlp": {
            "fc1_kernel": _trunc(rng, (dim, hidden)),
            "fc1_bias": np.zeros((hidden,), np.float32),
            "fc2_kernel": _trunc(rng, (hidden, dim)),
            "fc2_bias": np.zeros((dim,), np.float32),
        },
    }
    for norm in ("norm1", "norm2", "norm_y", "norm3"):
        tree[f"{norm}_scale"] = np.ones((dim,), np.float32)
        tree[f"{norm}_bias"] = np.zeros((dim,), np.float32)
    if layerscale is not None:
        for ls in ("ls1", "ls_y", "ls2"):
            tree[ls] = np.full((dim,), layerscale, np.float32)
    return tree
