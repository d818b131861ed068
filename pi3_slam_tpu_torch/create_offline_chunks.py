"""CLI: create offline chunks with the PyTorch port (Pi3 inference + grid or
ALIKED keypoints + intrinsics + MoGe-2 metric scale + optional ZNCC
observation refinement), on the GPU by default.

    python -m pi3_slam_tpu_torch.create_offline_chunks --images <dir> \\
        --output <out> --chunk-length 100 --overlap 20 --max-kp 400 --moge-path moge.npz

Same flags as the JAX package's ``create_offline_chunks.py``. ``--device
cuda`` (the default) needs a CUDA device; ``--device cpu`` is the explicit CPU
mode. The device mesh of ``--data-parallel-chunks``, ``--tensor-parallel``
and ``--sequence-parallel`` is laid over the devices there are: every visible
card on ``cuda``, the one host device on ``cpu``; a request beyond them is
clamped as the JAX CLI clamps it, so on one card dp 4 runs the single-device
path.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def collect_image_paths(images_arg: str, skip_start: int = 0, skip_end: int = 0):
    """Folder, glob pattern, or text file listing image paths."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".tiff", ".webp")
    if os.path.isdir(images_arg):
        paths = sorted(
            p for p in glob.glob(os.path.join(images_arg, "*")) if p.lower().endswith(exts)
        )
    elif os.path.isfile(images_arg) and images_arg.endswith(".txt"):
        with open(images_arg) as f:
            paths = [line.strip() for line in f if line.strip()]
    else:
        paths = sorted(glob.glob(images_arg))
    if skip_end:
        paths = paths[skip_start : len(paths) - skip_end]
    elif skip_start:
        paths = paths[skip_start:]
    return paths


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--images", required=True,
                        help="Folder with images, a glob pattern, or a text file listing image paths")
    parser.add_argument("--model-path", default=None,
                        help="Pi3 weights (.npz, the JAX package's checkpoint format); omit for random init")
    parser.add_argument("--output", default="output_chunks", help="Output directory")
    parser.add_argument("--chunk-length", type=int, default=50)
    parser.add_argument("--overlap", type=int, default=5)
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    parser.add_argument("--cam-dist-path", type=str, default=None,
                        help="Camera calibration JSON for undistortion")
    parser.add_argument("--metric-depth", action="store_true", default=True,
                        help="MoGe-2 metric scaling (without --moge-path: a message, no scaling)")
    parser.add_argument("--no-metric-depth", dest="metric_depth", action="store_false")
    parser.add_argument("--moge-path", default=None,
                        help="Converted MoGe-2 weights (.npz, the JAX package's format)")
    parser.add_argument("--keypoints", default="grid", choices=["aliked", "grid", "none"])
    parser.add_argument("--aliked-path", default=None, help="Converted ALIKED weights (.npz, tools/convert_checkpoint.py --model "
                             "aliked), for --keypoints aliked")
    parser.add_argument("--max-kp", type=int, default=200)
    parser.add_argument("--kp-threshold", type=float, default=0.005,
                        help="ALIKED detection threshold, for --keypoints aliked")
    parser.add_argument("--estimate-intrinsics", action="store_true", default=True)
    parser.add_argument("--num-workers", type=int, default=2, help="Prefetch decode threads")
    parser.add_argument("--data-parallel-chunks", type=int, default=1,
                        help="Chunks per step, one on each dp replica of the device mesh "
                             "(1 = single device; clamped to the devices there are)")
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="Tensor parallelism over heads / MLP hidden (the Megatron split; "
                             "dp x tp devices a step)")
    parser.add_argument("--sequence-parallel", type=int, default=1,
                        help="Ring attention over the sp mesh axis for the global attention "
                             "(dp x tp x sp devices a step)")
    parser.add_argument("--skip-start", type=int, default=0)
    parser.add_argument("--skip-end", type=int, default=0)
    parser.add_argument("--pixel-limit", type=int, default=255000 // 2)
    parser.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                        help="Model dtype; float32 runs the kernels' fp32 entries on the GPU")
    parser.add_argument("--resume", action="store_true", help="Skip chunks already on disk")
    parser.add_argument("--save-dense", action="store_true",
                        help="Store strided dense per-pixel maps alongside the sparse tracks")
    parser.add_argument("--dense-stride", type=int, default=None,
                        help="Spatial subsampling of the dense maps. Default: 2 with "
                             "--save-dense, 1 with --keypoints none")
    parser.add_argument("--refine-observations", action="store_true",
                        help="ZNCC refinement of the track observation fan inside the chunk "
                             "step; the reconstructor then uses the stored observations")
    parser.add_argument("--refine-max-observations", type=int, default=10,
                        help="Observation-fan width, for --refine-observations")
    parser.add_argument("--global-kv-merge", type=int, default=1,
                        help="Average global-attention keys/values over this many consecutive "
                             "frames (1 = exact; chunks whose frame count it does not divide "
                             "run exact)")
    parser.add_argument("--no-pad-tail", dest="pad_tail_chunks", action="store_false",
                        help="Run the short tail chunk unpadded instead of padding it to "
                             "--chunk-length by repeating its last frame")
    parser.add_argument("--chunk-compression", choices=("default", "fast", "none"),
                        default="default",
                        help="npz deflate level: 'default' zlib-6, 'fast' zlib-1, 'none' STORED")
    parser.add_argument("--profile-dir", default=None,
                        help="Write a torch.profiler trace (Chrome JSON) of chunk 1, the "
                             "first after warm-up, with its npz write and the program's stage "
                             "spans, and a per-kernel summary, into this directory")
    return parser


def create_chunks(argv=None, devices: list | None = None) -> list[dict]:
    """Parse ``argv``, write the chunks and return the per-chunk records of
    ``OfflineChunkCreator.process_and_save``. ``devices``: the list the
    device mesh is laid over (None: the devices ``--device`` sees). Exits
    with code 2 when no image is found."""
    parser = build_parser()
    args = parser.parse_args(argv)

    paths = collect_image_paths(args.images, args.skip_start, args.skip_end)
    if not paths:
        parser.error(f"no images found for {args.images}")
    print(f"{len(paths)} images")

    from .slam.chunk_creator import OfflineChunkCreator
    from .slam.config import OfflineCreatorConfig

    config = OfflineCreatorConfig(
        output_dir=args.output,
        chunk_length=args.chunk_length,
        overlap=args.overlap,
        pixel_limit=args.pixel_limit,
        device=args.device,
        checkpoint_path=args.model_path,
        compute_dtype=args.compute_dtype,
        global_kv_merge=args.global_kv_merge,
        pad_tail_chunks=args.pad_tail_chunks,
        use_metric_depth=args.metric_depth,
        moge_checkpoint_path=args.moge_path,
        keypoint_type=args.keypoints,
        aliked_checkpoint_path=args.aliked_path,
        max_keypoints=args.max_kp,
        keypoint_threshold=args.kp_threshold,
        estimate_camera_params=args.estimate_intrinsics,
        cam_dist_path=args.cam_dist_path,
        num_loader_workers=args.num_workers,
        resume=args.resume,
        data_parallel_chunks=args.data_parallel_chunks,
        tensor_parallel=args.tensor_parallel,
        sequence_parallel=args.sequence_parallel,
        save_dense=args.save_dense,
        dense_stride=args.dense_stride or (2 if args.save_dense else 1),
        chunk_compression=args.chunk_compression,
        profile_dir=args.profile_dir,
        refine_observations=args.refine_observations,
        refine_max_observations=args.refine_max_observations,
    )
    return OfflineChunkCreator(config, devices=devices).process_and_save(paths)


def main(argv=None) -> int:
    create_chunks(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
