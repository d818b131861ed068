"""End-to-end steady-state chunk-creation throughput on the GPU.

    python -m pi3_slam_tpu_torch.tools.perf_pipeline [--frames 420] [--workdir DIR]
        [--moge-checkpoint X.npz] [--forward-fps 98.3] [--online] [--device cuda]

Measures what a forward-only number does not: the whole
``OfflineChunkCreator.process_and_save`` path (threaded uint8 decode and
prefetch, the host-to-device upload, the chunk step: forward, masks and
keypoint interpolation, MoGe-2's metric scale when ``--moge-checkpoint`` is
given, the npz write) at the 7-Scenes evaluation settings (chunks of 100,
overlap 20, a pixel budget of 127,500, 400 grid keypoints). The reference's
analogous metric is the steady-state median chunk FPS it prints per run
(``slam/offline_chunk_creator.py:333-345``).

Prints one JSON line: the steady-state chunk FPS, the per-chunk FPS list and
its ratio to the forward-only rate (``--forward-fps``; its default is the
port's own ``perf_lab forward`` reading).

The rate of a chunk is its frames over the time since the previous chunk
finished (stamped after ``OfflineChunkCreator._finish_chunk``), so the
interval holds everything the pipeline does between two chunks. The first
chunk has no interval: its time carries the process's set-up on the card
(loading the kernels, the CUDA context, the libraries' first calls). The
port's creator dispatches and finishes each chunk in turn, with no second
chunk in flight, so no interval at the end is a drain burst and none is
dropped.

``--online`` instead measures the online SLAM loop
(``Pi3SLAMOnline.process_image_paths``: the pipelined forward, each chunk's
reconstruction and BA, the Sim3 alignment chain), the analog of the
reference's online average FPS (``slam/online_reconstructor.py:753-758``),
as the overall average and the steady-state median of per-chunk completion
rates, stamped after ``Pi3SLAMOnline._consume_finish`` (on the consumer
thread in the pipelined mode), the first chunk again without an interval.

Frames are random-noise 640x480 PNGs (decoding them is part of the
measurement); frames that exist are kept, so ``--online`` and a second run
reuse one ``--workdir``. ``run_offline`` / ``run_online`` return the printed
dict and take an optional ``pi3_config`` (random weights from seed 0 at that
configuration; default the full-width ``Pi3Config()``). Runs on the GPU
unless ``--device cpu``; without a GPU ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

import numpy as np

# The port's forward-only rate: perf_lab forward, the full-width bf16 Pi3 on a
# 100-frame chunk at 308x406, 1016.7-1017.8 ms on an NVIDIA H100 80GB HBM3 at
# 700 W
FORWARD_FPS = 98.3


def make_frames(d: str, n: int, height=480, width=640) -> list:
    """Synthetic moving-texture PNGs (decode cost matters: real loader work).
    Frames that exist are kept; the missing ones are encoded on a few threads
    (PIL releases the GIL while it compresses)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (height, width * 2, 3)).astype(np.uint8)
    paths = [os.path.join(d, f"frame_{i:05d}.png") for i in range(n)]

    def write(i):
        off = (3 * i) % width
        Image.fromarray(base[:, off : off + width]).save(paths[i])

    missing = [i for i, p in enumerate(paths) if not os.path.exists(p)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(write, missing))
    return paths


def interval_rates(stamps: list) -> list:
    """Frames over the interval since the previous stamp, for every stamp but
    the first; ``stamps`` holds (time, frames)."""
    return [round(stamps[i][1] / max(stamps[i][0] - stamps[i - 1][0], 1e-9), 2)
            for i in range(1, len(stamps))]


def _median(rates: list) -> float:
    return sorted(rates)[len(rates) // 2] if rates else 0.0


def _ratio(steady: float, forward_fps: float):
    return round(steady / forward_fps, 3) if forward_fps else None


def run_online(args, work: str, paths: list, pi3_config=None) -> dict:
    """Online-loop steady-state throughput (forward + recon + alignment)."""
    from ..slam.config import OnlineConfig
    from ..slam.online import Pi3SLAMOnline

    cfg = OnlineConfig(
        chunk_length=args.chunk_length,
        overlap=args.overlap,
        pixel_limit=args.pixel_limit,
        device=args.device,
        use_metric_depth=args.moge_checkpoint is not None,
        moge_checkpoint_path=args.moge_checkpoint,
        max_keypoints=400,
        output_dir=os.path.join(work, "online_out"),
        num_loader_workers=2,
        visualize=False,
    )
    slam = Pi3SLAMOnline(cfg, pi3_config=pi3_config)
    stamps = []  # (time, frames) at each chunk-consume completion
    lock = threading.Lock()  # the consumer thread stamps in the pipelined mode
    finish_orig = slam._consume_finish  # the last stage in every drive mode

    def finish_and_stamp(ctx):
        r = finish_orig(ctx)
        with lock:
            stamps.append((time.perf_counter(), ctx["pending"]["batch"]["images"].shape[0]))
        return r

    slam._consume_finish = finish_and_stamp
    res = slam.process_image_paths(paths)

    rates = interval_rates(stamps)
    steady = _median(rates)
    return {
        "metric": "steady_state_online_fps",
        "value": steady,
        "per_chunk_fps": rates,
        "overall_fps": round(res["fps"], 2),
        "num_chunks": res["num_chunks"],
        "forward_only_fps": args.forward_fps,
        "pipeline_vs_forward": _ratio(steady, args.forward_fps),
    }


def run_offline(args, work: str, paths: list, pi3_config=None) -> dict:
    """Offline chunk-creation steady-state throughput."""
    from ..slam.chunk_creator import OfflineChunkCreator
    from ..slam.config import OfflineCreatorConfig

    cfg = OfflineCreatorConfig(
        output_dir=os.path.join(work, "chunks_out"),
        chunk_length=args.chunk_length,
        overlap=args.overlap,
        pixel_limit=args.pixel_limit,
        device=args.device,
        use_metric_depth=args.moge_checkpoint is not None,
        moge_checkpoint_path=args.moge_checkpoint,
        max_keypoints=400,
        keypoint_type=args.keypoints,
        compute_dtype="bfloat16",
        num_loader_workers=2,
        chunk_compression=args.chunk_compression,
    )
    creator = OfflineChunkCreator(cfg, pi3_config=pi3_config)
    stamps = []  # (time, frames) at each chunk-finish completion
    finish_orig = creator._finish_chunk

    def finish_and_stamp(pending):
        r = finish_orig(pending)
        stamps.append((time.perf_counter(), r["_metrics"]["num_frames"]))
        return r

    creator._finish_chunk = finish_and_stamp
    creator.process_and_save(paths)

    per_chunk = interval_rates(stamps)
    steady = _median(per_chunk)
    return {
        "metric": "steady_state_chunk_creation_fps",
        "value": steady,
        "chunk_compression": args.chunk_compression,
        "per_chunk_fps": per_chunk,
        "forward_only_fps": args.forward_fps,
        "pipeline_vs_forward": _ratio(steady, args.forward_fps),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=420)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--moge-checkpoint", default=None)
    ap.add_argument("--forward-fps", type=float, default=FORWARD_FPS)
    ap.add_argument("--chunk-length", type=int, default=100)
    ap.add_argument("--overlap", type=int, default=20)
    ap.add_argument("--online", action="store_true",
                    help="measure Pi3SLAMOnline (forward + recon/align) "
                         "instead of the offline creator")
    ap.add_argument("--pixel-limit", type=int, default=127500)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--chunk-compression", default="default",
                    choices=("default", "fast", "none"),
                    help="npz codec for chunk files (offline creator only)")
    ap.add_argument("--keypoints", default="grid", choices=("grid", "none"),
                    help="'none' measures dense mode (full-map chunk files, "
                         "where the npz codec dominates the host budget)")
    return ap


def run(argv=None, pi3_config=None) -> dict:
    """Parse ``argv``, measure, print the JSON line and return it as a dict."""
    args = build_parser().parse_args(argv)

    from ..device import select_device

    select_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="pi3_perf_pipeline_")
    print(f"workdir: {work}")
    paths = make_frames(os.path.join(work, "frames"), args.frames)
    fn = run_online if args.online else run_offline
    result = fn(args, work, paths, pi3_config)
    print(json.dumps(result))
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
