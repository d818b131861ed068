"""Import reference-created chunk directories (.pt) into the port's layout.

The reference persists chunks as torch pickles (chunk_XXXXXX.pt, written by
slam/offline_chunk_creator.py:296-368) plus chunks_manifest.json and
chunk_metadata.json. This tool converts a whole chunk directory to the .npz
layout the port's reconstructor consumes, so an existing Pi3_SLAM user can
bring their already-computed chunks and reconstruct without rerunning
inference. It works on the host only; the reconstructor it names runs on the
GPU by default.

Usage:
  python -m pi3_slam_tpu_torch.tools.import_reference_chunks <reference_output_dir> <out_dir>

Expects <reference_output_dir>/chunks/chunk_*.pt (or chunk_*.pt directly in
the given directory).
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np


def convert_chunk(data: dict) -> dict:
    """Reference chunk dict (torch tensors) -> the npz field dict."""
    import torch

    def arr(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    out = {}
    for key in ("points", "local_points", "conf", "masks", "keypoints",
                "colors", "descriptors", "scores"):
        if key in data and data[key] is not None:
            out[key] = arr(data[key])
    poses = arr(data["camera_poses"]).astype(np.float64)
    out["camera_poses"] = poses.astype(np.float32)
    # cam-to-world -> world-to-cam companion (the chunks store both)
    inv = np.linalg.inv(poses)
    out["camera_poses_cw"] = inv.astype(np.float32)

    intr = data.get("intrinsics")
    if intr is None and isinstance(data.get("camera_params"), dict):
        intr = data["camera_params"].get("intrinsics")
    if intr is not None:
        out["intrinsics"] = arr(intr).astype(np.float32)

    if "image_paths" in data:
        out["image_paths"] = np.asarray([str(p) for p in data["image_paths"]])
    for key in ("original_width", "original_height", "chunk_index",
                "start_idx", "end_idx", "metric_scale"):
        if key in data and data[key] is not None:
            out[key] = np.asarray(data[key])
    return out


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    src_dir, out_dir = argv
    import torch

    chunk_dir = os.path.join(src_dir, "chunks")
    if not os.path.isdir(chunk_dir):
        chunk_dir = src_dir
    pt_files = sorted(glob.glob(os.path.join(chunk_dir, "chunk_*.pt")))
    if not pt_files:
        print(f"no chunk_*.pt files under {src_dir}", file=sys.stderr)
        return 1

    out_chunks = os.path.join(out_dir, "chunks")
    os.makedirs(out_chunks, exist_ok=True)
    for pt in pt_files:
        data = torch.load(pt, map_location="cpu", weights_only=False)
        fields = convert_chunk(data)
        name = os.path.splitext(os.path.basename(pt))[0] + ".npz"
        np.savez_compressed(os.path.join(out_chunks, name), **fields)
        print(f"converted {os.path.basename(pt)} -> chunks/{name}")

    for meta in ("chunks_manifest.json", "chunk_metadata.json"):
        src_meta = os.path.join(src_dir, meta)
        if os.path.exists(src_meta):
            with open(src_meta) as f:
                payload = json.load(f)
            if meta == "chunks_manifest.json" and isinstance(payload, list):
                for entry in payload:
                    if isinstance(entry.get("file"), str):
                        entry["file"] = entry["file"].replace(".pt", ".npz")
            with open(os.path.join(out_dir, meta), "w") as f:
                json.dump(payload, f, indent=2)
            print(f"copied {meta}")
    print(f"done -> {out_dir} (reconstruct with: python -m pi3_slam_tpu_torch.reconstruct_offline "
          f"--chunks {out_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
