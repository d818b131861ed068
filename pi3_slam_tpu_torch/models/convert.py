"""Parameter conversion between the JAX package's Pi3 parameter tree and
this port's ``Pi3`` module.

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
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .dinov2 import DinoV2Config
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


def pi3_state_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX Pi3 parameter tree -> ``Pi3`` state_dict (fp32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    enc = tree["encoder"]
    _linear(sd, "encoder.patch_embed", enc["patch_embed_kernel"], enc["patch_embed_bias"])
    for leaf in ("cls_token", "pos_embed", "register_tokens"):
        sd[f"encoder.{leaf}"] = _tensor(enc[leaf])
    sd["encoder.norm.weight"] = _tensor(enc["norm_scale"])
    sd["encoder.norm.bias"] = _tensor(enc["norm_bias"])
    depth = len(enc["blocks"]["qkv_kernel"])
    _blocks(sd, "encoder.blocks", enc["blocks"], range(depth))

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
