"""Full-stack offline-pipeline smoke run of the port on the GPU.

    python -m pi3_slam_tpu_torch.tools.smoke_e2e [--workdir DIR] [--keypoints aliked|grid]
        [--frames 21] [--chunk-length 8] [--overlap 3] [--pixel-limit 21000] [--device cuda]

The CPU tests drive the pipeline on the host; this tool runs the real CLIs,
the entry points a user runs (reference workflow:
slam/offline_chunk_creator.py + the reconstruct scripts), end to end in
processes of their own on ``--device`` (the card unless ``--device cpu``), so
defects that only the card shows (the hand-written kernels, streams, TF32
settings) surface before a release:

  python -m pi3_slam_tpu_torch.create_offline_chunks
      (ALIKED random weights or grid keypoints, --refine-observations,
       --save-dense)
    -> python -m pi3_slam_tpu_torch.reconstruct_offline
      (prior BA, --loop-closure, --save-colmap, --export-mesh --save-volume
       --render-previews)
    -> artifact checks (chunks + manifest, TUM, PLY, COLMAP text model, mesh
       PLY, TSDF npz, preview PNGs)

Weights are random (``models.convert.init_pi3_params`` /
``models.aliked.init_aliked_params``; no checkpoint is in the repository), so
the geometry is noise; what this validates is that every stage executes and
produces well-formed artifacts on the device. Exits non-zero on the first
failing stage; without a GPU ``--device cuda`` raises before any stage.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_frames(d: str, n: int, height: int = 240, width: int = 320) -> None:
    """Textured frames with a sliding crop so overlap frames correlate."""
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (height, width * 2, 3)).astype(np.uint8)
    for i in range(n):
        off = (5 * i) % width
        Image.fromarray(base[:, off : off + width]).save(
            os.path.join(d, f"frame_{i:05d}.png")
        )


def save_random_weights(work: str, keypoints: str) -> tuple:
    """Random full-width Pi3 (and aliked-n16) weights from seed 0 as npz files;
    returns (pi3 path, ALIKED path or None)."""
    from ..models.convert import init_pi3_params, save_params_npz
    from ..models.pi3 import Pi3Config

    pi3_path = os.path.join(work, "pi3_random.npz")
    save_params_npz(pi3_path, init_pi3_params(0, Pi3Config()))
    aliked_path = None
    if keypoints == "aliked":
        from ..models.aliked import init_aliked_params

        aliked_path = os.path.join(work, "aliked_random.npz")
        save_params_npz(aliked_path, init_aliked_params(0))
    return pi3_path, aliked_path


def run_stage(name: str, cmd: list, timeout: float | None = None) -> float:
    t0 = time.time()
    print(f"[smoke] {name}: {' '.join(cmd)}", flush=True)
    try:
        r = subprocess.run(cmd, cwd=ROOT, timeout=timeout)
    except subprocess.TimeoutExpired:
        # a CUDA call that hangs must fail the smoke run, not block it
        print(f"[smoke] FAIL {name} (timeout after {timeout:.0f}s)", flush=True)
        sys.exit(1)
    dt = time.time() - t0
    if r.returncode != 0:
        print(f"[smoke] FAIL {name} (rc={r.returncode}, {dt:.1f}s)", flush=True)
        sys.exit(1)
    print(f"[smoke] OK {name} ({dt:.1f}s)", flush=True)
    return dt


def check(path: str, what: str, min_bytes: int = 1) -> None:
    ok = os.path.exists(path) and os.path.getsize(path) >= min_bytes
    if not ok:
        print(f"[smoke] FAIL artifact missing/empty: {what} ({path})")
        sys.exit(1)
    print(f"[smoke] OK artifact {what}: {os.path.getsize(path)} B")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keypoints", default="aliked", choices=["aliked", "grid"])
    ap.add_argument("--frames", type=int, default=21)
    ap.add_argument("--chunk-length", type=int, default=8)
    ap.add_argument("--overlap", type=int, default=3)
    ap.add_argument("--pixel-limit", type=int, default=21000)
    ap.add_argument("--skip-refine", action="store_true",
                    help="skip --refine-observations")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', passed to both CLIs")
    ap.add_argument("--stage-timeout", type=float, default=300.0,
                    help="per-stage wall-clock limit in seconds: a CUDA call that hangs "
                         "fails the stage instead of blocking the run (at the defaults "
                         "on an NVIDIA H100 80GB HBM3 at 700 W the creator stage took "
                         "24.7 s and the reconstructor 14.9 s)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the auto-created workdir on success (an "
                         "explicit --workdir is always kept)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..device import select_device

    select_device(args.device)  # no CUDA device: raises before any stage
    print(f"[smoke] CLI device: {args.device}")

    auto_workdir = args.workdir is None
    work = args.workdir or tempfile.mkdtemp(prefix="pi3_smoke_")
    os.makedirs(work, exist_ok=True)
    frames_dir = os.path.join(work, "frames")
    chunks_dir = os.path.join(work, "chunks")
    recon_dir = os.path.join(work, "recon")
    make_frames(frames_dir, args.frames)
    pi3_path, aliked_path = save_random_weights(work, args.keypoints)

    py = sys.executable
    create_cmd = [
        py, "-m", "pi3_slam_tpu_torch.create_offline_chunks",
        "--images", frames_dir,
        "--model-path", pi3_path,
        "--output", chunks_dir,
        "--chunk-length", str(args.chunk_length),
        "--overlap", str(args.overlap),
        "--pixel-limit", str(args.pixel_limit),
        "--no-metric-depth",
        "--device", args.device,
        "--keypoints", args.keypoints,
        "--max-kp", "64",
        "--save-dense", "--dense-stride", "2",
    ]
    if not args.skip_refine:
        create_cmd += ["--refine-observations", "--refine-max-observations", "4"]
    if aliked_path:
        create_cmd += ["--aliked-path", aliked_path, "--kp-threshold", "-1.0"]
    run_stage("create_offline_chunks", create_cmd, timeout=args.stage_timeout)

    manifest_path = os.path.join(chunks_dir, "chunks_manifest.json")
    check(manifest_path, "chunk manifest")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        n_chunks = len(manifest["chunks"]) if isinstance(manifest, dict) else len(manifest)
    except (json.JSONDecodeError, KeyError, TypeError) as e:
        print(f"[smoke] FAIL bad manifest ({manifest_path}: {e})")
        sys.exit(1)
    print(f"[smoke] {n_chunks} chunks created")

    recon_cmd = [
        py, "-m", "pi3_slam_tpu_torch.reconstruct_offline",
        "--chunks", chunks_dir,
        "--output", recon_dir,
        "--device", args.device,
        "--max-observations-per-track", "4",
        "--ba-iterations", "4",
        "--loop-closure", "--loop-min-inliers", "8",
        "--save-colmap",
        "--export-mesh", "--mesh-voxel-size", "0.08",
        "--mesh-conf-threshold", "0.0",
        "--save-volume", "--render-previews", "2",
    ]
    run_stage("reconstruct_offline", recon_cmd, timeout=args.stage_timeout)

    check(os.path.join(recon_dir, "trajectory_tum.txt"), "TUM trajectory")
    check(os.path.join(recon_dir, "final_points.ply"), "point cloud PLY")
    check(os.path.join(recon_dir, "final_camera_poses.ply"), "camera PLY")
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        check(os.path.join(recon_dir, "colmap", f), f"colmap/{f}")
    check(os.path.join(recon_dir, "fused_mesh.ply"), "fused mesh PLY")
    check(os.path.join(recon_dir, "fused_volume.npz"), "TSDF volume")
    pdir = os.path.join(recon_dir, "mesh_previews")
    previews = (
        [f for f in os.listdir(pdir) if f.endswith(".png")]
        if os.path.isdir(pdir)
        else []
    )
    if not previews:
        print("[smoke] FAIL no raycast preview images found")
        sys.exit(1)
    print(f"[smoke] OK {len(previews)} raycast previews")
    if auto_workdir and not args.keep:
        # frames, chunks, dense maps and the TSDF volume add up; repeated runs
        # must not pile up temporary folders (kept on failure above, since
        # every FAIL path exits before reaching this)
        import shutil

        shutil.rmtree(work, ignore_errors=True)
        work += " (removed; rerun with --keep to retain)"
    print(f"[smoke] ALL STAGES PASSED (workdir {work})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
