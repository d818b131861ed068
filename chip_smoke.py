#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pi3_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. Print the card's name and power limit, build the hand-written kernels
   from the sources in this checkout and print the build time.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, in bf16: max error against the stated tolerance, and the
   kernel's and the plain version's time (CUDA events).
3. The full-width Pi3 forward (random weights, seed 0) on a 4-frame chunk at
   308x406: the kernel path (bf16 on the card) against the plain path (fp32
   on the host CPU).
4. The main path through the port's CLI: 130 synthetic 640x480 frames,
   chunks of 100 with overlap 20, 400 grid keypoints, no metric depth (the
   7-Scenes evaluation protocol without MoGe): two chunk files and a
   manifest with the JAX creator's keys and finite values, and the kernel
   launch counts of the run.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# per-kernel: route, source, the TPU kernel it replaces
KERNELS = {
    "qkv_rope_producer": (
        "triton", "pi3_slam_tpu_torch/ops/qkv_producer.py", "pi3_slam_tpu/ops/pallas_producer.py:169"),
    "attention_single_pass_packed": (
        "cuda", "pi3_slam_tpu_torch/csrc/packed_attention.cu", "pi3_slam_tpu/ops/pallas_attention.py:636"),
    "flash_attention_packed": (
        "cuda", "pi3_slam_tpu_torch/csrc/packed_attention.cu", "pi3_slam_tpu/ops/pallas_attention.py:504"),
    "block_mlp": (
        "cuda", "pi3_slam_tpu_torch/csrc/block_mlp.cu", "pi3_slam_tpu/ops/pallas_mlp.py:343"),
}
# launches per 100-frame chunk: 36 decoder + 15 head producer passes;
# 24 encoder + 18 frame + 15 head single-pass; 18 global; 75 block MLPs
LAUNCHES_PER_CHUNK = {
    "qkv_rope_producer": 51,
    "attention_single_pass_packed": 57,
    "flash_attention_packed": 18,
    "block_mlp": 75,
}
FRAME_T = 643  # 638 patches (22 x 29 at 308x406) + 5 register tokens
N_FRAMES = 100


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (CUDA events, one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, shape: str, got, ref, why: str, **bounds):
    """Kernel output against the plain one; bounds scale with the reference
    (pi3_slam_tpu_torch/ops/compare.py) and must reject an all-zero and a
    10%-off output."""
    import torch

    from pi3_slam_tpu_torch.ops.compare import compare

    torch.cuda.synchronize()
    c = compare(got, ref, **bounds)
    log(f"  {name:32s} {shape:28s} {c} ({why}) {'ok' if c.ok else 'FAIL'}")
    if not c.rejects_wrong:
        raise RuntimeError(f"{name} {shape}: the bounds would pass a zero or 10%-off output")
    if not c.ok:
        raise RuntimeError(f"{name} {shape}: kernel disagrees with its plain version ({c})")
    return c


def phase_build() -> None:
    from pi3_slam_tpu_torch.ops._build import build

    for name in ("packed_attention", "block_mlp"):
        so, seconds = build(name)
        log(f"  built {name}.cu in {seconds:.1f}s -> {os.path.relpath(so, REPO)}")
        report = so.with_suffix(".so.log").read_text() if seconds else ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")


def rope_for(b: int, frames_per_row: int):
    """cos/sin tables of the decoder at 22 x 29 patches + 5 register tokens."""
    from pi3_slam_tpu_torch.ops.rope import make_patch_positions, rope_tables

    pos = make_patch_positions(b * frames_per_row, 22, 29, num_special=5, offset=1, device="cuda")
    cos, sin = rope_tables(pos, 64)
    return cos.reshape(b, frames_per_row * FRAME_T, 64), sin.reshape(b, frames_per_row * FRAME_T, 64)


def phase_kernels() -> dict:
    """Each kernel vs its plain version at the main path's shapes (bf16)."""
    import torch

    from pi3_slam_tpu_torch.ops.block_mlp import block_mlp, block_mlp_plain
    from pi3_slam_tpu_torch.ops.compare import ATTENTION, PRODUCER, block_mlp_bounds
    from pi3_slam_tpu_torch.ops.packed_attention import (
        attention_single_pass_packed, flash_attention_packed, packed_attention_plain)
    from pi3_slam_tpu_torch.ops.qkv_producer import qkv_rope_producer, qkv_rope_producer_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    H, C = 16, 1024
    results = {}

    def record(name, shape, checks, ms, plain_ms):
        r = results.setdefault(name, {"max_abs_err": 0.0, "rel_l2": 0.0})
        for c in checks:
            r["max_abs_err"] = max(r["max_abs_err"], c.max_abs_err)
            r["rel_l2"] = max(r["rel_l2"], c.rel_l2)
        if "ms" not in r:  # the first shape listed is the one reported
            r.update(shape=shape, ms=ms, plain_ms=plain_ms)
        log(f"  {name:30s} {shape:28s} kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms")

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(bf16)

    norm = dict(
        q_norm_scale=1 + 0.1 * torch.randn(64, generator=g, device="cuda"),
        q_norm_bias=0.1 * torch.randn(64, generator=g, device="cuda"),
        k_norm_scale=1 + 0.1 * torch.randn(64, generator=g, device="cuda"),
        k_norm_bias=0.1 * torch.randn(64, generator=g, device="cuda"),
    )
    # bounds and their reasons: pi3_slam_tpu_torch/ops/compare.py
    produced = {}
    for shape_name, (b, fpr) in (("(100, 643, 3072) norm", (N_FRAMES, 1)),
                                 ("(100, 643, 3072) no norm", (N_FRAMES, 1)),
                                 ("(1, 64300, 3072) norm", (1, N_FRAMES))):
        t = fpr * FRAME_T
        qkv = randn(b, t, 3 * C)
        cos, sin = rope_for(b, fpr)
        kw = {} if "no norm" in shape_name else norm
        want_kn = b == 1
        run = lambda: qkv_rope_producer(qkv, cos, sin, H, t, return_k_norms=want_kn, **kw)
        plain = lambda: qkv_rope_producer_plain(qkv, cos, sin, H, t, return_k_norms=want_kn, **kw)
        got, ref = run(), plain()
        if want_kn:
            (got, kn), (ref, kn_ref) = got, ref
            check("qkv_rope_producer kn", shape_name, kn, kn_ref, "fp32 sums in another order",
                  max_rel=1e-5, l2_rel=1e-5)
        checks = [check(f"qkv_rope_producer {part}", shape_name, got[..., i * C:(i + 1) * C],
                        ref[..., i * C:(i + 1) * C], "<= 1 bf16 ulp", **PRODUCER)
                  for i, part in enumerate("qkv")]
        record("qkv_rope_producer", shape_name, checks, time_ms(run, 10), time_ms(plain, 3))
        produced[shape_name] = ref

    attn = dict(why="bf16 P, bf16 output", **ATTENTION)

    raw = randn(N_FRAMES, FRAME_T, 3 * C)
    scale = 64**-0.5 * 1.4426950408889634
    for shape_name, qkv, q_scale in (("(100, 643, 3072) producer", produced["(100, 643, 3072) norm"], 1.0),
                                     ("(100, 643, 3072) q_scale", raw, scale)):
        run = lambda: attention_single_pass_packed(qkv, H, q_scale=q_scale)
        plain = lambda: packed_attention_plain(qkv, H, q_scale=q_scale)
        c = check("attention_single_pass_packed", shape_name, run(), plain(), **attn)
        record("attention_single_pass_packed", shape_name, [c], time_ms(run, 10), time_ms(plain, 3))
    # padded keys (the producer's zero rows) are masked by length
    padded = torch.nn.functional.pad(produced["(100, 643, 3072) norm"], (0, 0, 0, 61))
    check("attention_single_pass_packed", "(100, 704, 3072) true_t=643",
          attention_single_pass_packed(padded, H, true_t=FRAME_T),
          packed_attention_plain(padded, H, true_t=FRAME_T), **attn)

    qkv = produced["(1, 64300, 3072) norm"]
    run = lambda: flash_attention_packed(qkv, H)
    plain = lambda: packed_attention_plain(qkv, H)
    c = check("flash_attention_packed", "(1, 64300, 3072)", run(), plain(), **attn)
    record("flash_attention_packed", "(1, 64300, 3072)", [c], time_ms(run, 3), time_ms(plain, 1))

    w1 = randn(4 * C, C, scale=0.02)
    w2 = randn(C, 4 * C, scale=0.02)
    mlp_params = (
        1 + 0.1 * torch.randn(C, generator=g, device="cuda"),
        0.1 * torch.randn(C, generator=g, device="cuda"),
        w1, randn(4 * C, scale=0.1), w2, randn(C, scale=0.1),
        1 + 0.1 * torch.randn(C, generator=g, device="cuda"),
    )
    for shape_name, shape in (("(1, 64300, 1024)", (1, N_FRAMES * FRAME_T, C)),
                              ("(100, 643, 1024)", (N_FRAMES, FRAME_T, C))):
        x = randn(*shape)
        run = lambda: block_mlp(x, *mlp_params[:6], ls=mlp_params[6])
        plain = lambda: block_mlp_plain(x, *mlp_params[:6], ls=mlp_params[6])
        ref = plain()
        c = check("block_mlp branch", shape_name, run(), ref, "bf16 fc outputs, bf16 out",
                  **block_mlp_bounds(x, ref))
        record("block_mlp", shape_name, [c], time_ms(run, 5), time_ms(plain, 5))
    return results


def phase_model() -> None:
    """Full-width Pi3 forward: kernel path (bf16, card) vs plain path (fp32, CPU)."""
    import numpy as np
    import torch

    from pi3_slam_tpu_torch.models.convert import build_pi3, init_pi3_params, pi3_state_from_jax
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts

    cfg = Pi3Config()
    t0 = time.perf_counter()
    state = pi3_state_from_jax(init_pi3_params(0, cfg))
    log(f"  random full-width weights (seed 0) in {time.perf_counter() - t0:.1f}s")
    imgs = np.random.default_rng(0).random((1, 4, 3, 308, 406), dtype=np.float32)
    gpu = build_pi3(cfg, state, torch.device("cuda"), torch.bfloat16)
    reset_launch_counts()
    with torch.no_grad():
        out_gpu = {k: v.cpu() for k, v in gpu(torch.from_numpy(imgs).cuda()).items()}
    counts = launch_counts()
    del gpu
    torch.cuda.empty_cache()
    if counts != LAUNCHES_PER_CHUNK:
        raise RuntimeError(f"model forward launch counts {counts} != {LAUNCHES_PER_CHUNK}")
    cpu = build_pi3(cfg, state, torch.device("cpu"), torch.float32)
    t0 = time.perf_counter()
    with torch.no_grad():
        out_cpu = cpu(torch.from_numpy(imgs))
    log(f"  plain fp32 forward on the CPU in {time.perf_counter() - t0:.1f}s")
    # a bf16 trunk of 75 blocks against an fp32 one: relative L2 error 5e-2
    for key in ("points", "local_points", "conf", "camera_poses"):
        a, b = out_gpu[key].double(), out_cpu[key].double()
        if not torch.isfinite(a).all():
            raise RuntimeError(f"model {key}: not finite")
        rel = ((a - b).norm() / b.norm()).item()
        ok = rel <= 5e-2
        log(f"  pi3 {key:14s} {tuple(a.shape)} rel L2 (bf16 kernels vs fp32 plain) = {rel:.3e}  "
            f"max abs {(a - b).abs().max().item():.3e}  tol 5e-2 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"model {key}: relative error {rel} exceeds 5e-2")


def write_frames(folder: str, n: int = 130) -> None:
    """Seeded synthetic 640x480 frames: a drifting smooth pattern plus noise."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    for i in range(n):
        base = np.stack([np.sin((xx + 3 * i) / 37.0), np.cos((yy - 2 * i) / 29.0),
                         np.sin((xx + yy + i) / 53.0)], axis=-1)
        img = (base * 90 + 128 + rng.normal(0, 8, base.shape)).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(folder, f"frame_{i:04d}.png"))


def phase_cli() -> dict:
    """Drive the CLI python -m pi3_slam_tpu_torch.create_offline_chunks."""
    import numpy as np

    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.utils.keypoints import grid_keypoints

    with tempfile.TemporaryDirectory() as tmp:
        frames = os.path.join(tmp, "frames")
        out = os.path.join(tmp, "out")
        os.makedirs(frames)
        write_frames(frames)
        argv = ["--images", frames, "--output", out, "--chunk-length", "100", "--overlap", "20",
                "--max-kp", "400", "--no-metric-depth"]
        log("  python -m pi3_slam_tpu_torch.create_offline_chunks " + " ".join(argv))
        reset_launch_counts()
        t0 = time.perf_counter()
        records = create_chunks(argv)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        fps = [r["fps"] for r in records]
        per_chunk = [r["launches"] for r in records]
        with open(os.path.join(out, "chunks_manifest.json")) as f:
            manifest = json.load(f)
        if [m["num_frames"] for m in manifest] != [100, 50]:
            raise RuntimeError(f"unexpected chunks {manifest}")
        k = len(grid_keypoints(308, 406, 400))
        keys = {"points", "local_points", "conf", "masks", "keypoints", "colors", "camera_poses",
                "camera_poses_cw", "image_paths", "original_height", "original_width",
                "intrinsics", "chunk_index", "start_idx", "end_idx"}
        for entry in manifest:
            with np.load(os.path.join(out, "chunks", entry["file"])) as z:
                if set(z.files) != keys:
                    raise RuntimeError(f"{entry['file']} keys {sorted(z.files)} != {sorted(keys)}")
                n = entry["num_frames"]
                if z["points"].shape != (n, k, 3) or z["camera_poses"].shape != (n, 4, 4):
                    raise RuntimeError(f"{entry['file']}: shapes {z['points'].shape}")
                for key in ("points", "local_points", "conf", "camera_poses", "camera_poses_cw",
                            "intrinsics"):
                    if not np.isfinite(z[key].astype(np.float64)).all():
                        raise RuntimeError(f"{entry['file']}: {key} not finite")
                if (int(z["original_height"]), int(z["original_width"])) != (308, 406):
                    raise RuntimeError("unexpected target size")
        want = {name: per * len(manifest) for name, per in LAUNCHES_PER_CHUNK.items()}
        log(f"  chunks: {[m['file'] for m in manifest]}, frames/s per chunk {fps}, "
            f"CLI wall {wall:.1f}s")
        log(f"  launch counts {counts} (expected {want}); per chunk {per_chunk}")
        if counts != want or per_chunk != [LAUNCHES_PER_CHUNK] * len(manifest):
            raise RuntimeError(f"launch counts {counts}, per chunk {per_chunk}: expected "
                               f"{LAUNCHES_PER_CHUNK} per chunk")
        return counts


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "pi3_slam_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 1
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pi3_slam_tpu_torch.device import select_device

    select_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    t0 = time.perf_counter()
    log("[1] build")
    phase_build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f}s")
    log("[2] kernels vs plain, bf16, main-path shapes")
    results = phase_kernels()
    log("[3] full-width Pi3 forward, 4 frames at 308x406")
    phase_model()
    log("[4] main path: port CLI over 130 frames")
    counts = phase_cli()
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": r["max_abs_err"],
                        "rel_l2": r["rel_l2"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
