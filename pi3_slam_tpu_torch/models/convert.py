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
* :func:`convert_pi3_state_dict` and :func:`convert_moge_state_dict` turn the
  reference checkpoints' state dicts (Pi3's ``model.safetensors``, MoGe-2's
  ``model.pt``) into the JAX layout, as numpy copies of the JAX package's
  converters; :func:`check_pi3_config` holds a Pi3Config to the weights and
  :func:`save_pi3_checkpoint` writes the tree with it embedded
  (``tools/convert_checkpoint.py`` is the command line).
* :func:`convert_aliked_state_dict` turns a lightglue ALIKED state dict into
  the JAX layout and :func:`load_aliked_checkpoint` reads the ``.npz`` back
  with its variant's config (the module and its carrier are in
  ``models/aliked.py``).
* :func:`convert_moge_v1_state_dict` turns a MoGe v1 ``model.pt`` state dict
  (``moge/model/v1.py``) into the JAX package's v1 tree with its
  '_v1_config_json' leaf, :func:`moge_v1_state_from_jax` that tree into the
  port's ``MoGeV1`` state dict, :func:`build_moge_v1` the module from it and
  :func:`load_moge_v1_checkpoint` reads the ``.npz`` back with its config.
  No v1 checkpoint is in the repository and the JAX package has no v1 init:
  :func:`random_moge_v1_state_dict` draws one from a numpy seed over the
  port's module, in the reference naming, for tests and smoke runs.
* :func:`init_vggt_params` draws a VGGT-1B state dict (``models/vggt.py``,
  which has no JAX counterpart) from a numpy seed over the port's module, and
  :func:`build_vggt` makes the module from it: the trunk in the compute
  dtype, the heads in fp32. No VGGT checkpoint is in the repository.
* :func:`cross_block_state_from_jax` and :func:`init_cross_block_params` do
  the same for the cross-attention block (``models/cross_attention.py``);
  no cross-block checkpoint is in the repository, so runs use the random
  tree, and :func:`build_cross_block` makes the module from a state dict.
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .cross_attention import CrossBlock
from .dinov2 import DinoV2Config
from .moge_model import ConvStackConfig, MoGe, MoGeConfig
from .moge_v1 import MoGeV1, MoGeV1Config
from .pi3 import Pi3, Pi3Config
from .vggt import VGGT, VGGTConfig

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
    """A float32 tensor over ``a``'s memory where it can be: a transposed
    kernel stays a strided view, which the builders make contiguous where the
    module lands (:func:`_contiguous`). On the card that is an on-device copy;
    numpy's transposing copy of full-width Pi3's kernels took 11.9 s on the
    host CPU of an H100 machine. A read-only array (a JAX buffer's view) is
    copied in its own layout."""
    a = np.asarray(a, dtype=np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy(order="K"))


def _contiguous(module):
    """``module`` with every parameter and buffer contiguous, each copied on
    the device it lies on where it is not."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        if not t.is_contiguous():
            t.data = t.data.contiguous()
    return module


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
    return _contiguous(model.to(device=device, dtype=dtype)).eval()


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
    model = _contiguous(model.to(device=device, dtype=torch.float32)).eval()
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


# --- reference checkpoints -> the JAX layout (numpy copies of the JAX
# package's models/convert.py: the same trees, so a file written by either
# package's converter loads in both)


def _t(w) -> np.ndarray:
    """torch Linear weight (out, in) -> (in, out) kernel."""
    return np.ascontiguousarray(np.asarray(w).T)


def _hwio(w) -> np.ndarray:
    """torch conv weight (out, in, kh, kw) -> HWIO (kh, kw, in, out)."""
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def _stack_block_params(get, prefixes, qk_norm: bool, layerscale: bool) -> Dict[str, np.ndarray]:
    """Per-block reference params stacked along a leading layer axis."""
    leaves = [("norm1_scale", "norm1.weight", False), ("norm1_bias", "norm1.bias", False),
              ("qkv_kernel", "attn.qkv.weight", True), ("qkv_bias", "attn.qkv.bias", False),
              ("proj_kernel", "attn.proj.weight", True), ("proj_bias", "attn.proj.bias", False),
              ("norm2_scale", "norm2.weight", False), ("norm2_bias", "norm2.bias", False),
              ("fc1_kernel", "mlp.fc1.weight", True), ("fc1_bias", "mlp.fc1.bias", False),
              ("fc2_kernel", "mlp.fc2.weight", True), ("fc2_bias", "mlp.fc2.bias", False)]
    if qk_norm:
        leaves += [("q_norm_scale", "attn.q_norm.weight", False),
                   ("q_norm_bias", "attn.q_norm.bias", False),
                   ("k_norm_scale", "attn.k_norm.weight", False),
                   ("k_norm_bias", "attn.k_norm.bias", False)]
    if layerscale:
        leaves += [("ls1", "ls1.gamma", False), ("ls2", "ls2.gamma", False)]
    return {leaf: np.stack([_t(get(f"{p}.{name}")) if kernel else get(f"{p}.{name}")
                            for p in prefixes])
            for leaf, name, kernel in leaves}


def convert_dinov2(sd, prefix: str, depth: int) -> Dict[str, Any]:
    """An encoder subtree (DinoVisionTransformer with block_chunks=0)."""

    def get(name):
        return np.asarray(sd[f"{prefix}{name}"])

    conv_w = get("patch_embed.proj.weight")  # (C, 3, p, p)
    c = conv_w.shape[0]
    return {
        "patch_embed_kernel": np.ascontiguousarray(conv_w.reshape(c, -1).T),
        "patch_embed_bias": get("patch_embed.proj.bias"),
        "cls_token": get("cls_token").reshape(1, c),
        "pos_embed": get("pos_embed").reshape(-1, c),
        # plain (non-reg) DINOv2 backbones have no register tokens
        "register_tokens": (get("register_tokens").reshape(-1, c)
                            if f"{prefix}register_tokens" in sd else np.zeros((0, c), np.float32)),
        "blocks": _stack_block_params(get, [f"blocks.{i}" for i in range(depth)],
                                      qk_norm=False, layerscale=True),
        "norm_scale": get("norm.weight"),
        "norm_bias": get("norm.bias"),
    }


def _convert_head_decoder(sd, prefix: str, depth: int = 5) -> Dict[str, Any]:
    def get(name):
        return np.asarray(sd[f"{prefix}{name}"])

    return {
        "project_kernel": _t(get("projects.weight")),
        "project_bias": get("projects.bias"),
        "blocks": _stack_block_params(get, [f"blocks.{i}" for i in range(depth)],
                                      qk_norm=False, layerscale=False),
        "out_kernel": _t(get("linear_out.weight")),
        "out_bias": get("linear_out.bias"),
    }


def _convert_camera_head(sd, prefix: str) -> Dict[str, Any]:
    def get(name):
        return np.asarray(sd[f"{prefix}{name}"])

    out: Dict[str, Any] = {
        f"res_conv{i}": {f"fc{j}_{kind}": (_t(get(f"res_conv.{i}.res_conv{j}.weight"))
                                           if kind == "kernel"
                                           else get(f"res_conv.{i}.res_conv{j}.bias"))
                         for j in (1, 2, 3) for kind in ("kernel", "bias")}
        for i in range(2)}
    for leaf, name in (("mlp1", "more_mlps.0"), ("mlp2", "more_mlps.2"), ("fc_t", "fc_t"),
                       ("fc_rot", "fc_rot")):
        out[f"{leaf}_kernel"] = _t(get(f"{name}.weight"))
        out[f"{leaf}_bias"] = get(f"{name}.bias")
    return out


def convert_pi3_state_dict(sd, encoder_depth: int = 24, dec_depth: int = 36) -> Dict[str, Any]:
    """The reference Pi3 state dict (numpy or torch values; the module tree
    of the reference ``pi3/models/pi3.py``) -> the JAX-layout param tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    get = sd.__getitem__
    even = _stack_block_params(get, [f"decoder.{i}" for i in range(0, dec_depth, 2)],
                               qk_norm=True, layerscale=True)
    odd = _stack_block_params(get, [f"decoder.{i}" for i in range(1, dec_depth, 2)],
                              qk_norm=True, layerscale=True)
    c = even["qkv_kernel"].shape[1]
    return {
        "encoder": convert_dinov2(sd, "encoder.", encoder_depth),
        "decoder": {"register_token": get("register_token").reshape(-1, c),
                    "even_blocks": even, "odd_blocks": odd},
        "point_decoder": _convert_head_decoder(sd, "point_decoder."),
        "conf_decoder": _convert_head_decoder(sd, "conf_decoder."),
        "camera_decoder": _convert_head_decoder(sd, "camera_decoder."),
        "point_head": {"kernel": _t(get("point_head.proj.weight")),
                       "bias": get("point_head.proj.bias")},
        "conf_head": {"kernel": _t(get("conf_head.proj.weight")),
                      "bias": get("conf_head.proj.bias")},
        "camera_head": _convert_camera_head(sd, "camera_head."),
    }


def check_pi3_config(params: Dict[str, Any], config: Pi3Config) -> None:
    """Raise ValueError naming the first shape-derivable Pi3Config field that
    the converted tree contradicts (the CLIs size the model from the config
    embedded in the checkpoint, so it must describe these weights). Head
    counts are not derivable from weight shapes and are not checked."""
    enc, dec, pd = params["encoder"], params["decoder"], params["point_decoder"]
    even, odd = dec["even_blocks"], dec["odd_blocks"]

    def ratio(blocks):
        return int(blocks["fc1_kernel"].shape[-1] // blocks["fc1_kernel"].shape[-2])

    derived = {
        "encoder.patch_size": (int(round((enc["patch_embed_kernel"].shape[0] // 3) ** 0.5)),
                               config.encoder.patch_size),
        "encoder.embed_dim": (int(enc["patch_embed_kernel"].shape[1]), config.encoder.embed_dim),
        "encoder.depth": (int(enc["blocks"]["qkv_kernel"].shape[0]), config.encoder.depth),
        "encoder.mlp_ratio": (ratio(enc["blocks"]), config.encoder.mlp_ratio),
        "encoder.num_register_tokens": (int(enc["register_tokens"].shape[0]),
                                        config.encoder.num_register_tokens),
        "dec_embed_dim": (int(even["qkv_kernel"].shape[1]), config.dec_embed_dim),
        "dec_depth": (int(even["qkv_kernel"].shape[0] + odd["qkv_kernel"].shape[0]),
                      config.dec_depth),
        "mlp_ratio": (ratio(even), config.mlp_ratio),
        "num_register_tokens": (int(dec["register_token"].shape[0]), config.num_register_tokens),
        "head_dim": (int(pd["project_kernel"].shape[-1]), config.head_dim),
        "head_depth": (int(pd["blocks"]["qkv_kernel"].shape[0]), config.head_depth),
        "camera_dim": (int(params["camera_head"]["res_conv0"]["fc1_kernel"].shape[0]),
                       config.camera_dim),
    }
    for field, (got, want) in derived.items():
        if got != want:
            raise ValueError(
                f"Pi3 checkpoint/config mismatch: weights imply {field}={got} but the config "
                f"says {want}. Pass the variant's config (Pi3Config json) instead of the default.")


def save_pi3_checkpoint(path: str, params: Dict[str, Any], config: Pi3Config) -> None:
    """Save Pi3 params with the config embedded as '_pi3_config_json' (what
    ``load_pi3_checkpoint`` of either package reads)."""
    save_params_npz(path, {**params, "_pi3_config_json": np.asarray(config.to_json())})


def moge_config_from_model_config(model_config: Dict[str, Any]) -> MoGeConfig:
    """A MoGe-2 checkpoint's 'model_config' dict (the reference's
    ``moge/model/v2.py``) -> MoGeConfig."""

    def cs(d):
        if d is None:
            return None
        dim_out = d["dim_out"]
        resamplers = d.get("resamplers", "pixel_shuffle")
        return ConvStackConfig(
            dim_in=tuple(d["dim_in"]),
            dim_res_blocks=tuple(d["dim_res_blocks"]),
            dim_out=(tuple(dim_out) if isinstance(dim_out, (list, tuple))
                     else (dim_out,) * len(d["dim_res_blocks"])),
            resamplers=tuple(resamplers) if isinstance(resamplers, (list, tuple)) else resamplers,
            dim_times_res_block_hidden=d.get("dim_times_res_block_hidden", 1),
            num_res_blocks=d.get("num_res_blocks", 1),
            res_block_in_norm=d.get("res_block_in_norm", "layer_norm"),
            res_block_hidden_norm=d.get("res_block_hidden_norm", "group_norm"),
        )

    enc = model_config["encoder"]
    scale_head = model_config.get("scale_head")
    return MoGeConfig(
        backbone=enc["backbone"],
        intermediate_layers=enc["intermediate_layers"],
        encoder_dim_out=enc["dim_out"],
        neck=cs(model_config["neck"]),
        points_head=cs(model_config.get("points_head")),
        mask_head=cs(model_config.get("mask_head")),
        normal_head=cs(model_config.get("normal_head")),
        scale_head_dims=tuple(scale_head["dims"]) if scale_head else None,
        remap_output=model_config.get("remap_output", "linear"),
        num_tokens_range=tuple(model_config.get("num_tokens_range", (1200, 3600))),
    )


def _convert_conv_stack(sd, prefix: str, cfg: ConvStackConfig) -> Dict[str, Any]:
    """A reference ConvStack (``moge/model/modules.py``) -> input_blocks /
    res_blocks / resamplers / output_blocks lists (None where a level has no
    input or output conv)."""
    n = len(cfg.dim_res_blocks)

    def conv(base, leaf=""):
        return {f"{leaf}kernel": _hwio(sd[f"{base}weight"]), f"{leaf}bias": np.asarray(sd[f"{base}bias"])}

    def maybe_conv(name):
        return conv(f"{prefix}{name}.") if f"{prefix}{name}.weight" in sd else None

    def res_block(base):
        blk = {**conv(f"{base}layers.2.", "conv1_"), **conv(f"{base}layers.5.", "conv2_")}
        for norm, layer in (("norm1", 0), ("norm2", 3)):  # absent for a 'none' norm
            if f"{base}layers.{layer}.weight" in sd:
                blk[f"{norm}_scale"] = np.asarray(sd[f"{base}layers.{layer}.weight"])
                blk[f"{norm}_bias"] = np.asarray(sd[f"{base}layers.{layer}.bias"])
        if f"{base}skip_connection.weight" in sd:
            blk.update(conv(f"{base}skip_connection.", "skip_"))
        return blk

    return {
        "input_blocks": [maybe_conv(f"input_blocks.{i}") for i in range(n)],
        "res_blocks": [[res_block(f"{prefix}res_blocks.{i}.{j}.")
                        for j in range(cfg.num_blocks_at(i))] for i in range(n)],
        "resamplers": [{**conv(f"{prefix}resamplers.{i}.0.", "conv1_"),
                        **conv(f"{prefix}resamplers.{i}.2.", "conv2_")} for i in range(n - 1)],
        "output_blocks": [maybe_conv(f"output_blocks.{i}") for i in range(n)],
    }


def convert_moge_state_dict(sd, model_config: Dict[str, Any]) -> Dict[str, Any]:
    """A MoGe-2 reference checkpoint ('model' state dict and 'model_config')
    -> the JAX-layout param tree with the config embedded as '_config_json'."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    cfg = moge_config_from_model_config(model_config)
    params: Dict[str, Any] = {
        "backbone": convert_dinov2(sd, "encoder.backbone.", cfg.encoder_cfg.depth),
        "output_projections": [
            {"kernel": _hwio(sd[f"encoder.output_projections.{i}.weight"]),
             "bias": np.asarray(sd[f"encoder.output_projections.{i}.bias"])}
            for i in range(cfg.num_projections)],
        "neck": _convert_conv_stack(sd, "neck.", cfg.neck),
        "_config_json": np.asarray(cfg.to_json()),
    }
    for head in ("points_head", "mask_head", "normal_head"):
        if getattr(cfg, head) is not None:
            params[head] = _convert_conv_stack(sd, f"{head}.", getattr(cfg, head))
    if cfg.scale_head_dims is not None:
        layers, i = [], 0
        while f"scale_head.{i}.weight" in sd:
            layers.append({"kernel": _t(sd[f"scale_head.{i}.weight"]),
                           "bias": np.asarray(sd[f"scale_head.{i}.bias"])})
            i += 2  # the Linear layers sit at the even indices, a ReLU between them
        params["scale_head"] = layers
    return params


def convert_moge_v1_state_dict(sd, model_config: Dict[str, Any]) -> Dict[str, Any]:
    """A MoGe v1 reference checkpoint ('model' state dict and 'model_config',
    ``moge/model/v1.py``) -> the JAX package's v1 tree: ``ConvTranspose2d``
    weights (in, out, 2, 2) as 1x1 kernels to out * 4 channels ordered (out,
    dy, dx), the config as a '_v1_config_json' string leaf."""
    import json

    cfg = MoGeV1Config.from_model_config(model_config)
    sd = {k: np.asarray(v) for k, v in sd.items()}

    def conv(prefix, leaf=""):
        return {f"{leaf}kernel": _hwio(sd[f"{prefix}.weight"]), f"{leaf}bias": sd[f"{prefix}.bias"]}

    def deconv2x2(prefix):
        w = sd[f"{prefix}.weight"]
        return {"kernel": np.ascontiguousarray(w.reshape(w.shape[0], w.shape[1] * 4))[None, None],
                "bias": sd[f"{prefix}.bias"]}

    def res_block(prefix):
        out = {"norm1_scale": sd[f"{prefix}.layers.0.weight"],
               "norm1_bias": sd[f"{prefix}.layers.0.bias"],
               **conv(f"{prefix}.layers.2", "conv1_"),
               "norm2_scale": sd[f"{prefix}.layers.3.weight"],
               "norm2_bias": sd[f"{prefix}.layers.3.bias"],
               **conv(f"{prefix}.layers.5", "conv2_")}
        if f"{prefix}.skip_connection.weight" in sd:
            out.update(conv(f"{prefix}.skip_connection", "skip_"))
        return out

    lrb = cfg.last_res_blocks
    head = {
        "projects": [conv(f"head.projects.{i}") for i in range(len(cfg.layer_indices))],
        "upsample_blocks": [
            {"deconv": deconv2x2(f"head.upsample_blocks.{i}.0.0"),
             **conv(f"head.upsample_blocks.{i}.0.1", "conv_"),
             "res_blocks": [res_block(f"head.upsample_blocks.{i}.{1 + j}")
                            for j in range(cfg.num_res_blocks)]}
            for i in range(len(cfg.dim_upsample))],
        "output_blocks": [
            {**conv(f"head.output_block.{k}.0", "conv_in_"),
             "res_blocks": [res_block(f"head.output_block.{k}.{1 + j}") for j in range(lrb)],
             **conv(f"head.output_block.{k}.{lrb + 2}", "conv_out_")}
            for k in range(2)],  # points (3 channels), mask (1)
    }
    return {
        "backbone": convert_dinov2(sd, "backbone.", cfg.encoder_cfg.depth),
        "head": head,
        "_v1_config_json": json.dumps({k: getattr(cfg, k) for k in MoGeV1Config.__dataclass_fields__}),
    }


def _v1_res_block(sd: dict, name: str, p: Dict[str, Any]) -> None:
    _norm(sd, f"{name}.layers.0", p, "norm1")
    _conv(sd, f"{name}.layers.2", p, "conv1_")
    if "norm2_scale" in p:
        _norm(sd, f"{name}.layers.3", p, "norm2")
    _conv(sd, f"{name}.layers.5", p, "conv2_")


def moge_v1_state_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX MoGe v1 tree (``convert_moge_v1_state_dict``'s layout) -> ``MoGeV1``
    state_dict (fp32 CPU tensors): the backbone in the port's DINOv2 naming,
    the head in the reference's. '_v1_config_json' is ignored."""
    sd: Dict[str, torch.Tensor] = {}
    _dinov2(sd, "backbone", tree["backbone"])
    head = tree["head"]
    for i, proj in enumerate(head["projects"]):
        _conv(sd, f"head.projects.{i}", proj)
    for i, blk in enumerate(head["upsample_blocks"]):
        name = f"head.upsample_blocks.{i}"
        k = np.asarray(blk["deconv"]["kernel"], dtype=np.float32)[0, 0]  # (in, out * 4)
        sd[f"{name}.0.0.weight"] = _tensor(k.reshape(k.shape[0], -1, 2, 2))
        sd[f"{name}.0.0.bias"] = _tensor(blk["deconv"]["bias"])
        _conv(sd, f"{name}.0.1", blk, "conv_")
        for j, rb in enumerate(blk.get("res_blocks") or []):
            _v1_res_block(sd, f"{name}.{1 + j}", rb)
    for k, ob in enumerate(head["output_blocks"]):
        name = f"head.output_block.{k}"
        _conv(sd, f"{name}.0", ob, "conv_in_")
        res = ob.get("res_blocks") or []
        for j, rb in enumerate(res):
            _v1_res_block(sd, f"{name}.{1 + j}", rb)
        _conv(sd, f"{name}.{len(res) + 2}", ob, "conv_out_")
    return sd


def build_moge_v1(cfg: MoGeV1Config, state: Dict[str, torch.Tensor], device: torch.device,
                  trunk_dtype: torch.dtype = torch.float32) -> MoGeV1:
    """A ``MoGeV1`` holding ``state`` on ``device``, in fp32 but for the
    encoder blocks, which are held in ``trunk_dtype`` (fp32 computes as the
    JAX package does; bf16 is a control)."""
    model = MoGeV1(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    model = _contiguous(model.to(device=device, dtype=torch.float32)).eval()
    model.backbone.blocks.to(trunk_dtype)
    return model


def load_moge_v1_checkpoint(path: str):
    """Load a MoGe v1 ``.npz`` (``tools/convert_checkpoint.py --model moge`` on
    a v1 checkpoint) -> (JAX-layout tree, MoGeV1Config from its
    '_v1_config_json')."""
    import json

    params = load_params_npz(path)
    cfg = MoGeV1Config.from_model_config(json.loads(str(params.pop("_v1_config_json"))))
    return params, cfg


_DECONV = re.compile(r"head\.upsample_blocks\.\d+\.0\.0\.weight")
# the port's DINOv2 names -> the reference's (``dinov2/layers``)
_REFERENCE_BLOCK_NAMES = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
                          "fc2": "mlp.fc2", "ls1": "ls1.gamma", "ls2": "ls2.gamma"}


def random_moge_v1_state_dict(cfg: MoGeV1Config, seed: int = 0) -> Dict[str, np.ndarray]:
    """A random MoGe v1 state dict in the reference naming (``backbone.*`` as
    DINOv2's, ``head.*`` as ``moge/model/v1.py``'s), float32 numpy, drawn
    from ``np.random.default_rng(seed)`` over the port's ``MoGeV1``
    parameters in their order: weights N(0, 1/fan_in), norm scales 1 +
    N(0, 0.1^2), LayerScales 0.1 + N(0, 0.02^2), biases, class token and
    position embedding N(0, 0.02^2). What ``convert_moge_v1_state_dict`` (of
    either package) reads; values only matter for tests and smoke runs.

    The points output block then passes the view-plane UV through: four of
    its first convolution's channels carry +u, -u, +v, -v, its last one sums
    them into x and y (ReLU(u) - ReLU(-u) = u), the random rest scaled to 1%.
    With the 'exp' remap (the released v1 checkpoints') z is 0.3 u before
    it, so the points lie near (u, v, 1) e^(0.3 u): a tilted surface seen
    at focal 1 and shift 0, on which the focal / shift solve of
    ``moge_v1_infer`` is well posed, where fully random points leave it to
    rounding; other remaps get z = 1, a fronto-parallel plane, on which
    focal and shift trade against each other. The mask stays random."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, p in MoGeV1(cfg, device="meta").state_dict().items():
        shape = tuple(p.shape)
        n = rng.standard_normal(shape, dtype=np.float32)
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ls1", "ls2"):
            a = 0.1 + 0.02 * n
        elif len(shape) >= 2 and leaf == "weight":
            # a ConvTranspose2d weight is (in, out, 2, 2): one tap per input channel
            fan_in = shape[0] if _DECONV.fullmatch(name) else int(np.prod(shape[1:]))
            a = n * np.float32(fan_in**-0.5)
        elif leaf == "weight":  # LayerNorm / GroupNorm scales
            a = 1 + 0.1 * n
        else:
            a = 0.02 * n
        if not name.startswith("backbone."):
            out[name] = a
            continue
        key = name[len("backbone."):]
        if key == "register_tokens":
            continue  # the plain DINOv2 backbones have none
        if key.startswith("patch_embed."):
            c = cfg.encoder_cfg.embed_dim
            key = "patch_embed.proj." + key.split(".")[-1]
            a = a.reshape(c, 3, 14, 14) if a.ndim == 2 else a
        elif key in ("cls_token", "pos_embed"):
            a = a[None]
        elif key.startswith("blocks."):
            _, i, mod, *rest = key.split(".")
            key = ".".join(["blocks", i, _REFERENCE_BLOCK_NAMES.get(mod, mod), *rest])
        out["backbone." + key] = a
    w_in = out["head.output_block.0.0.weight"]  # (last_conv_channels, C + 2, 3, 3)
    w_in[:4] = 0.0
    out["head.output_block.0.0.bias"][:4] = 0.0
    for ch, (uv, sign) in enumerate(((-2, 1.0), (-2, -1.0), (-1, 1.0), (-1, -1.0))):
        w_in[ch, uv, 1, 1] = sign
    last = f"head.output_block.0.{cfg.last_res_blocks + 2}"
    w_out, mid = out[f"{last}.weight"], cfg.last_conv_size // 2  # (3, last_conv_channels, k, k)
    w_out *= 0.01
    for axis, ch, sign in ((0, 0, 1.0), (0, 1, -1.0), (1, 2, 1.0), (1, 3, -1.0)):
        w_out[axis, ch, mid, mid] += sign
    out[f"{last}.bias"][:] = 0.0
    if cfg.remap_output == "exp":
        w_out[2, 0, mid, mid] += 0.3
        w_out[2, 1, mid, mid] -= 0.3
    elif cfg.remap_output != "sinh_exp":
        out[f"{last}.bias"][2] = 1.0
    return out


def convert_aliked_state_dict(sd, model_name: str = "aliked-n16") -> Dict[str, Any]:
    """A lightglue ALIKED state dict -> the JAX layout of
    ``models/aliked.init_aliked_params`` (HWIO kernels) with a ``_model_name``
    leaf. A bias the state dict lacks stays out of the tree; any key left
    unread (``num_batches_tracked`` aside) raises, so a layout the converter
    does not know fails here rather than loading wrong weights."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    used = set()

    def get(name):
        used.add(name)
        return sd[name]

    def bn(prefix):
        return {leaf: get(f"{prefix}.{leaf}")
                for leaf in ("weight", "bias", "running_mean", "running_var")}

    def conv_block(prefix):
        return {"conv1_kernel": _hwio(get(f"{prefix}.conv1.weight")), "conv1_bn": bn(f"{prefix}.bn1"),
                "conv2_kernel": _hwio(get(f"{prefix}.conv2.weight")), "conv2_bn": bn(f"{prefix}.bn2")}

    def res_block(prefix):
        out = conv_block(prefix)
        out["downsample_kernel"] = _hwio(get(f"{prefix}.downsample.weight"))
        if f"{prefix}.downsample.bias" in sd:
            out["downsample_bias"] = get(f"{prefix}.downsample.bias")
        return out

    params = {
        "block1": conv_block("block1"),
        "block2": res_block("block2"),
        "block3": res_block("block3"),
        "block4": res_block("block4"),
        **{f"conv{i}_kernel": _hwio(get(f"conv{i}.weight")) for i in range(1, 5)},
        "score_head": {f"conv{i}_kernel": _hwio(get(f"score_head.{2 * (i - 1)}.weight"))
                       for i in range(1, 5)},
        "offset_conv1_kernel": _hwio(get("desc_head.offset_conv.0.weight")),
        "offset_conv1_bias": get("desc_head.offset_conv.0.bias"),
        "offset_conv2_kernel": _hwio(get("desc_head.offset_conv.2.weight")),
        "offset_conv2_bias": get("desc_head.offset_conv.2.bias"),
        "sf_conv_kernel": _hwio(get("desc_head.sf_conv.weight")),
        "agg_weights": get("desc_head.agg_weights"),
    }
    for i in range(1, 5):
        if f"score_head.{2 * (i - 1)}.bias" in sd:
            params["score_head"][f"conv{i}_bias"] = get(f"score_head.{2 * (i - 1)}.bias")
    unmatched = sorted(k for k in sd if k not in used and "num_batches_tracked" not in k)
    if unmatched:
        raise ValueError(
            f"ALIKED state_dict has {len(unmatched)} unmatched keys (layout "
            f"drift?): {unmatched[:10]}{'...' if len(unmatched) > 10 else ''}")
    params["_model_name"] = model_name
    return params


def load_aliked_checkpoint(path: str):
    """An ALIKED ``.npz`` (``tools/convert_checkpoint.py --model aliked``) ->
    (JAX-layout tree, ALIKEDConfig of its ``_model_name``; aliked-n16 when the
    file names none or an unknown variant, as the JAX extractor reads it)."""
    from .aliked import CONFIGS

    params = load_params_npz(path)
    name = str(params.pop("_model_name", "aliked-n16"))
    return params, CONFIGS.get(name, CONFIGS["aliked-n16"])


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
    return _contiguous(block.to(device=device, dtype=dtype)).eval()


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


# VGGT's ConvTranspose2d leaves: stride = kernel, so each output pixel sees
# the input channels once (fan-in = in channels)
_VGGT_TRANSPOSED = re.compile(r"_head\.resize_layers\.[01]\.weight$")


def _vggt_leaf_rule(name: str, shape: Tuple[int, ...]) -> Tuple[str, float]:
    """(kind, value) of a VGGT leaf: ('const', v), ('uniform', std) or
    ('normal', std). Biases 0, norm scales 1, LayerScale 0.01 in the
    aggregator and the camera trunk (VGGT's init_values) and 1 in DINOv2
    (VGGT builds it with init_values 1.0), the aggregator's camera and
    register tokens normal at std 1e-6 (VGGT's init), DINOv2's tokens uniform
    at 1e-6, the empty pose encoding 0, convolutions uniform with the fan-in's
    std, everything else uniform at std 0.02 (the port's Pi3 init)."""
    parts = name.split(".")
    last, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if last == "bias" or last == "empty_pose_tokens":
        return "const", 0.0
    if last == "weight" and "norm" in parent:
        return "const", 1.0
    if last in ("ls1", "ls2"):
        return "const", 1.0 if name.startswith("encoder.") else 0.01
    if last in ("camera_token", "register_token"):
        return "normal", 1e-6
    if last in ("cls_token", "register_tokens"):
        return "uniform", 1e-6
    if len(shape) == 4:
        fan_in = shape[0] if _VGGT_TRANSPOSED.search(name) else shape[1] * shape[2] * shape[3]
        return "uniform", fan_in ** -0.5
    return "uniform", 0.02


def init_vggt_params(seed: int, cfg: VGGTConfig = VGGTConfig()) -> Dict[str, np.ndarray]:
    """A random VGGT state dict (float32 numpy, the port's names), drawn
    from ``np.random.default_rng(seed)`` leaf by leaf in the module's order
    by :func:`_vggt_leaf_rule`. Values only matter for tests and smoke runs."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in VGGT(cfg, device="meta").named_parameters():
        kind, value = _vggt_leaf_rule(name, tuple(p.shape))
        if kind == "const":
            out[name] = np.full(p.shape, value, np.float32)
        elif kind == "normal":
            out[name] = rng.standard_normal(p.shape, dtype=np.float32) * np.float32(value)
        else:
            out[name] = _trunc(rng, tuple(p.shape), std=value)
    return out


def build_vggt(cfg: VGGTConfig, state: Dict[str, Any], device: torch.device,
               dtype: torch.dtype) -> VGGT:
    """A ``VGGT`` holding ``state`` (tensors or numpy arrays) on ``device``:
    the encoder and the aggregator's blocks in ``dtype`` (the trunk), the
    heads and the special tokens in fp32."""
    model = VGGT(cfg, device="meta")
    state = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
             for k, v in state.items()}
    model.load_state_dict(state, strict=True, assign=True)
    model = _contiguous(model.to(device=device, dtype=torch.float32)).eval()
    for trunk in (model.encoder, model.frame_blocks, model.global_blocks):
        trunk.to(dtype)
    return model
