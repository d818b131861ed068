"""Convert a reference checkpoint to the ``.npz`` parameter file that
``--model-path`` / ``--moge-path`` of the port's CLIs (and of the JAX
package's) load.

    python -m pi3_slam_tpu_torch.tools.convert_checkpoint --model pi3 \\
        --input model.safetensors --output pi3.npz
    python -m pi3_slam_tpu_torch.tools.convert_checkpoint --model moge \\
        --input model.pt --output moge.npz
    python -m pi3_slam_tpu_torch.tools.convert_checkpoint --model aliked \\
        --aliked-name aliked-n16 --input aliked-n16.pth --output aliked.npz

The options of the JAX package's ``tools/convert_checkpoint.py``. Local files
only: ``.safetensors`` through ``io/safetensors.py`` (no ``safetensors``
package needed), ``.pt`` / ``.pth`` through ``torch.load(weights_only=True)``.
Host numpy work: no GPU is touched. A MoGe ``model.pt`` whose 'model_config'
names its encoder by a flat string is a v1 checkpoint (``moge/model/v1.py``):
the tool says "detected MoGe v1 checkpoint layout" and writes the JAX
package's v1 tree (``models/moge_v1.py`` runs it).
"""

from __future__ import annotations

import argparse
import os
import resource
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", choices=["pi3", "moge", "aliked"], required=True)
    parser.add_argument("--aliked-name", default="aliked-n16",
                        help="ALIKED variant (aliked-t16/n16/n16rot/n32)")
    parser.add_argument("--input", required=True, help="Local checkpoint file")
    parser.add_argument("--output", required=True, help="Output .npz path")
    parser.add_argument(
        "--pi3-config", default=None, metavar="JSON_PATH",
        help="Pi3Config JSON file describing a non-default Pi3 variant "
             "(Pi3Config.to_json format); the embedded self-description is "
             "validated against the converted weights either way")
    return parser


def load_torch_file(path: str):
    """-> (state dict of numpy arrays, the checkpoint's 'model_config' or
    None). Floating tensors of a ``.pt`` file come out as float32."""
    if path.endswith(".safetensors"):
        from ..io.safetensors import read_safetensors

        return read_safetensors(path), None
    import torch

    data = torch.load(path, map_location="cpu", weights_only=True)
    model_config = None
    if isinstance(data, dict) and "model" in data and "model_config" in data:
        data, model_config = data["model"], data["model_config"]
    elif isinstance(data, dict):
        data = data.get("state_dict", data)
    sd = {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in data.items()}
    return sd, model_config


def _count(node) -> int:
    if isinstance(node, dict):
        return sum(_count(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_count(v) for v in node)
    if node is None or isinstance(node, str):
        return 0
    arr = np.asarray(node)
    return int(arr.size) if arr.dtype.kind in "fiu" else 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not os.path.isfile(args.input):
        parser.error(f"--input {args.input}: no such file (the port reads local checkpoint "
                     "files only; it resolves no hub id)")

    from ..models.convert import (
        check_pi3_config,
        convert_aliked_state_dict,
        convert_moge_state_dict,
        convert_moge_v1_state_dict,
        convert_pi3_state_dict,
        save_params_npz,
        save_pi3_checkpoint,
    )
    from ..models.pi3 import Pi3Config

    sd, model_config = load_torch_file(args.input)
    print(f"loaded {len(sd)} tensors from {args.input}")
    if args.model == "pi3":
        params = convert_pi3_state_dict(sd)
        del sd  # the tree is the only copy the save needs
        if args.pi3_config is not None:
            with open(args.pi3_config) as f:
                config = Pi3Config.from_json(f.read())
        else:
            config = Pi3Config()
        check_pi3_config(params, config)
        save_pi3_checkpoint(args.output, params, config)
    elif args.model == "aliked":
        params = convert_aliked_state_dict(sd, model_name=args.aliked_name)
        del sd
        save_params_npz(args.output, params)
    else:
        if model_config is None:
            raise SystemExit("MoGe checkpoint must carry model_config (expected model.pt format)")
        if isinstance(model_config.get("encoder"), str):
            # v1 checkpoints carry a flat encoder name; v2 an encoder dict
            params = convert_moge_v1_state_dict(sd, model_config)
            print("detected MoGe v1 checkpoint layout")
        else:
            params = convert_moge_state_dict(sd, model_config)
        del sd
        save_params_npz(args.output, params)
    peak_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"wrote {args.output} ({_count(params) / 1e6:.1f}M params; peak resident "
          f"memory {peak_gib:.2f} GiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
