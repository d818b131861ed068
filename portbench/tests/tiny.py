"""A tiny configuration and traffic mix for running the whole harness on the
CPU: the Pi3 family at a few hundred thousand parameters (head dim 64, so the
port takes its packed route), MoGe-2's ViT-S trunk at a hundred tokens,
chunks of four small frames."""

import copy
import json
import os

from portbench import manifest

HERE = os.path.dirname(os.path.abspath(__file__))


def config(name: str = "pi3-moge2", compute_dtype: str = "float32") -> dict:
    with open(os.path.join(HERE, "..", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    m = cfg["model"]
    m["encoder"].update(embed_dim=128, depth=2, num_heads=2)
    m.update(dec_embed_dim=128, dec_num_heads=2, dec_depth=4, head_dim=128, head_depth=1,
             head_num_heads=2, camera_dim=64)
    if cfg.get("metric_depth") is not None:
        cfg["metric_depth"]["num_tokens_range"] = [60, 96]
    cfg["compute_dtype"] = compute_dtype
    return cfg


def traffic() -> dict:
    with open(os.path.join(HERE, "..", "traffic", "offline-7scenes.json")) as f:
        tr = json.load(f)
    tr.update(frame_height=96, frame_width=128, distinct_frames=12, sequence_chunks=400,
              chunk_length=4, overlap=1, pixel_limit=84 * 112, max_keypoints=16,
              loader_workers=1, warmup_chunks=1, trace_chunks=1, check_chunks=1)
    return copy.deepcopy(tr)


def bench() -> dict:
    """The manifest with the kv-merge cell that waits for a later benchmark
    PR (its configuration, limits, metric and kernel files are in place)."""
    b = manifest.load_benchmark()
    b["workloads"].append({"name": "pi3kv2-offline-7scenes", "config": "pi3-kvmerge2",
                           "traffic": "offline-7scenes", "chips": 1, "why": "kv-merge 2"})
    b["per_layer"].append({"name": "partial_attn_roofline", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "kernels", "moves": "offline_fps",
                           "workloads": ["pi3kv2-offline-7scenes"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and m["name"] != "partial_attn_roofline":
            m["workloads"] = m["workloads"] + ["pi3kv2-offline-7scenes"]
    return b
