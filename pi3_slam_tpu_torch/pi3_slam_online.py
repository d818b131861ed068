"""CLI: online streaming SLAM with the PyTorch port (chunked Pi3 inference,
grid or ALIKED keypoints, MoGe-2 metric scale, optional ZNCC observation
refinement, per-chunk BA, incremental Sim3 alignment, optional loop
closure and telemetry after processing, the TSDF mesh, the online viewer and
the reprojection-debug GIFs), on the GPU by default.

    python -m pi3_slam_tpu_torch.pi3_slam_online --images <dir> --output <out> \\
        --chunk-length 100 --overlap 20 --max-kp 400 --moge-path moge.npz --save-tum
    ... --export-mesh --save-volume --live-mesh-every 1   # fused_mesh.ply, fused_volume.npz
    ... --visualize --save-debug-projections   # the viewer; debug_projections/chunk_*.gif

Same flags as the JAX package's ``pi3_slam_online.py`` (image folder, glob or
list, or ``--video``; the reference's underscore spellings as aliases).
Flags that name parts not ported yet exit 2 with a message naming their
ROADMAP.md entry. ``--device cuda`` (the default) needs a CUDA device;
``--device cpu`` is the explicit CPU mode. Writes ``final_points.ply`` and
``trajectory_tum.txt`` (and ``trajectory.tum`` with ``--save-tum``, and
``fused_mesh.ply`` with ``--export-mesh``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    g_in = parser.add_argument_group("input")
    g_in.add_argument("--images", "--image_dir", default=None,
                      help="Image folder / glob / list file")
    g_in.add_argument("--video", "--video_path", default=None, help="Video file")
    g_in.add_argument("--start-frame", "--start_frame", type=int, default=0,
                      help="Starting frame for video (reference --start_frame)")
    g_in.add_argument("--end-frame", "--end_frame", type=int, default=None,
                      help="Ending frame for video (reference --end_frame)")
    g_in.add_argument("--skip-start", "--skip_start", type=int, default=0)
    g_in.add_argument("--skip-end", "--skip_end", type=int, default=0)
    g_in.add_argument("--stride", type=int, default=1, help="Video frame stride")

    g_model = parser.add_argument_group("model")
    g_model.add_argument("--model-path", "--model_path", default=None,
                         help="Pi3 weights (.npz, the JAX package's checkpoint format); "
                              "omit for random init")
    g_model.add_argument("--moge-path", default=None,
                         help="Converted MoGe-2 weights (.npz, the JAX package's format)")
    g_model.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                         help="Model dtype; float32 runs the kernels' fp32 entries on the GPU")
    g_model.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")

    g_proc = parser.add_argument_group("processing")
    g_proc.add_argument("--chunk-length", "--chunk_length", type=int, default=30)
    g_proc.add_argument("--overlap", type=int, default=5)
    g_proc.add_argument("--cam-scale", "--cam_scale", type=float, default=1.0,
                        help="Accepted for reference CLI compatibility; the reference "
                             "stores this but never applies it "
                             "(slam/online_reconstructor.py:272)")
    g_proc.add_argument("--pixel-limit", type=int, default=255000 // 2)
    g_proc.add_argument("--num-workers", type=int, default=2)
    g_proc.add_argument("--data-parallel-chunks", type=int, default=1,
                        help="Chunks per step over several devices (only 1 is ported)")
    g_proc.add_argument("--tensor-parallel", type=int, default=1,
                        help="Tensor parallelism over heads / hidden (only 1 is ported)")
    g_proc.add_argument("--sequence-parallel", type=int, default=1,
                        help="Ring attention over several devices (only 1 is ported)")
    g_proc.add_argument("--no-overlap", dest="overlap_device_host", action="store_false",
                        help="Disable the infer/reconstruction overlap (strictly serial)")
    g_proc.add_argument("--no-pad-tail", dest="pad_tail_chunks", action="store_false",
                        help="Run the short tail chunk unpadded instead of padding it to "
                             "--chunk-length by repeating its last frame")
    g_proc.add_argument("--chunk-compression", choices=("default", "fast", "none"),
                        default="default",
                        help="npz deflate level for dense stashes: 'default' zlib-6, "
                             "'fast' zlib-1, 'none' STORED")
    g_proc.add_argument("--refine-observations", action="store_true",
                        help="ZNCC refinement of the track observation fan inside the chunk "
                             "step (as create_offline_chunks --refine-observations)")
    g_proc.add_argument("--global-kv-merge", type=int, default=1,
                        help="EXPERIMENTAL: merge this many consecutive frames' k/v "
                             "tokens in global attention (FastVGGT-style); "
                             "approximate — validate accuracy on your data first")
    g_proc.add_argument("--metric-depth", "--do_metric_depth", action="store_true",
                        default=True)
    g_proc.add_argument("--no-metric-depth", dest="metric_depth", action="store_false")

    g_cam = parser.add_argument_group("camera")
    g_cam.add_argument("--cam-dist-path", "--cam_dist_path", default=None)
    g_cam.add_argument("--estimate-intrinsics", "--estimate_camera_params",
                       action="store_true", default=True)

    g_kp = parser.add_argument_group("keypoints")
    g_kp.add_argument("--keypoints", "--keypoint_type", default="grid",
                      choices=["grid", "aliked"])
    g_kp.add_argument("--aliked-path", default=None,
                      help="Converted ALIKED weights (.npz), for --keypoints aliked")
    g_kp.add_argument("--max-kp", "--max_num_keypoints", type=int, default=1000)
    g_kp.add_argument("--kp-threshold", "--keypoint_detection_threshold",
                      type=float, default=0.005,
                      help="ALIKED detection threshold (reference --kp-threshold)")
    parser.add_argument("--telemetry", default=None,
                        help="Telemetry with gravity / GPS streams (generic JSON or GoPro "
                             "MP4): GPS georeference, gravity and GPS priors in the BA")
    parser.add_argument("--gps-sigma", type=float, default=2.0)
    parser.add_argument("--gravity-sigma", type=float, default=0.05)

    g_rec = parser.add_argument_group("reconstruction")
    g_rec.add_argument("--max-observations-per-track", "--max_observations_per_track",
                       type=int, default=10)
    g_rec.add_argument("--use-inverse-depth", "--use_inverse_depth",
                       action="store_true",
                       help="Inverse-depth track parametrization in the per-chunk BA "
                            "(reference --use_inverse_depth)")
    g_rec.add_argument("--conf-threshold", "--conf_threshold", type=float, default=0.1,
                       help="sigmoid(conf) cutoff for dense points in the chunk "
                            "step (reference --conf_threshold)")
    g_rec.add_argument("--ba-iterations", "--ba_iterations", type=int, default=10,
                       help="Per-chunk BA Gauss-Newton iterations (same knob as "
                            "reconstruct_offline.py --ba-iterations)")
    g_rec.add_argument("--align-refine-iterations", "--align_refine_iterations",
                       type=int, default=50,
                       help="Prior-BA iterations of the Sim3 alignment refine")

    g_viz = parser.add_argument_group("visualization")
    g_viz.add_argument("--visualize", action="store_true",
                       help="The online viewer: a viser server on --viz-port, or one "
                            "'[viz]' line a chunk when viser is not installed")
    g_viz.add_argument("--no-visualization", "--no_visualization", action="store_true",
                       help="Disable visualization (reference spelling; visualization "
                            "is already off unless --visualize is given, and this "
                            "flag wins over --visualize)")
    g_viz.add_argument("--viz-port", "--viz_port", type=int, default=8080)
    g_viz.add_argument("--keep-viz-open", "--keep_viz_open", action="store_true",
                       help="Keep the visualization server alive after "
                            "processing until Ctrl-C")

    g_out = parser.add_argument_group("output")
    g_out.add_argument("--output", "--output_path", default="online_output")
    g_out.add_argument("--max-points", "--max_points", type=int, default=1000000,
                       help="Cap on points written to final_points.ply")
    g_out.add_argument("--save-tum", "--save_tum", action="store_true",
                       help="Accepted for reference CLI compatibility; the TUM "
                            "trajectory is always written")
    g_out.add_argument("--save-debug-recons", "--save_chunk_reconstructions",
                       "--save_transformed_reconstructions",
                       "--save_debug_reconstructions", action="store_true",
                       help="Save each chunk's aligned reconstruction as "
                            "debug_recons/recon_XXXXXX.npz (covers the reference's "
                            "--save_chunk/transformed/debug_reconstructions trio)")
    g_out.add_argument("--save-debug-projections", "--save_debug_projections",
                       action="store_true",
                       help="Per-chunk reprojection-debug GIFs (observed vs "
                            "reprojected keypoints) under <output>/debug_projections")
    g_out.add_argument("--debug-overlap", action="store_true",
                       help="Print per-alignment overlap diagnostics (overlap frame "
                            "ids, common-track counts, conf stats) and append them "
                            "to <output>/overlap_debug.jsonl")
    g_out.add_argument("--loop-closure", action="store_true",
                       help="Loop closure over the chunks after processing (needs "
                            "--keypoints aliked)")
    g_out.add_argument("--save-dense", action="store_true",
                       help="Stash strided dense per-pixel maps per chunk under "
                            "<output>/dense/")
    g_out.add_argument("--export-mesh", action="store_true",
                       help="TSDF-fuse the dense maps under the final poses "
                            "(after loop closure / telemetry) and export "
                            "fused_mesh.ply (implies --save-dense)")
    g_out.add_argument("--dense-stride", type=int, default=2,
                       help="Spatial subsampling of the stashed dense maps "
                            "(applied on-device; stride^2 smaller stashes)")
    g_out.add_argument("--save-volume", action="store_true",
                       help="With --export-mesh: also persist the fused TSDF "
                            "volume (fused_volume.npz)")
    g_out.add_argument("--live-mesh-every", type=int, default=0,
                       help="Re-fuse the stashed dense maps every K chunks on a "
                            "background host-CPU thread under the current poses "
                            "and print the live surface's size (0 = off)")
    g_out.add_argument("--mesh-voxel-size", type=float, default=0.0,
                       help="TSDF voxel size in scene units; 0 = auto "
                            "(~192 voxels across the scene)")
    g_out.add_argument("--mesh-conf-threshold", type=float, default=0.25,
                       help="Minimum sigmoid confidence for a depth sample to "
                            "be integrated")
    g_out.add_argument("--tum-integer-timestamps", "--tum_integer_timestamp",
                       action="store_true",
                       help="Write integer frame-index timestamps in the TUM export "
                            "(the reference's --tum_integer_timestamp; matches the "
                            "offline export and the 7-Scenes eval protocol)")
    return parser


def _frames(args, parser) -> list:
    """Image paths, or (video_path, frame_idx) tuples in the reference's
    frame window: start_frame + skip_start up to end_frame - skip_end."""
    if (args.images is None) == (args.video is None):
        parser.error("give exactly one of --images / --video")
    if args.video:
        from .data.image_io import list_video_frames

        paths = list_video_frames(args.video, args.start_frame + args.skip_start, args.skip_end,
                                  args.stride)
        if args.end_frame is not None:
            stop = args.end_frame - args.skip_end
            paths = [p for p in paths if p[1] < stop]
    else:
        from .create_offline_chunks import collect_image_paths

        paths = collect_image_paths(args.images, args.skip_start, args.skip_end)
    if not paths:
        parser.error("no input frames")
    return paths


def run_online(argv=None) -> dict:
    """Parse ``argv``, run online SLAM and write its outputs. Returns
    ``Pi3SLAMOnline.process_image_paths``'s result with ``queue_status``,
    ``chunk_launches`` (kernel launches of each chunk's step and MoGe-2),
    ``loop_closure`` (``apply_loop_closure``'s statistics, None without
    ``--loop-closure``), ``telemetry`` (``apply_telemetry``'s statistics, None
    without ``--telemetry``) and ``artifacts`` (output paths). Exits with code
    2 on an unported flag or when no frame is found."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.no_visualization:
        args.visualize = False

    from .slam.config import OnlineConfig
    from .slam.online import Pi3SLAMOnline, unported

    config = OnlineConfig(
        chunk_length=args.chunk_length,
        overlap=args.overlap,
        pixel_limit=args.pixel_limit,
        device=args.device,
        checkpoint_path=args.model_path,
        compute_dtype=args.compute_dtype,
        use_metric_depth=args.metric_depth,
        moge_checkpoint_path=args.moge_path,
        keypoint_type=args.keypoints,
        aliked_checkpoint_path=args.aliked_path,
        max_keypoints=args.max_kp,
        keypoint_threshold=args.kp_threshold,
        telemetry_path=args.telemetry,
        gps_sigma=args.gps_sigma,
        gravity_sigma=args.gravity_sigma,
        estimate_camera_params=args.estimate_intrinsics,
        cam_dist_path=args.cam_dist_path,
        max_observations_per_track=args.max_observations_per_track,
        use_inverse_depth=args.use_inverse_depth,
        conf_threshold=args.conf_threshold,
        ba_iterations=args.ba_iterations,
        align_refine_iterations=args.align_refine_iterations,
        save_debug_recons=args.save_debug_recons,
        num_loader_workers=args.num_workers,
        data_parallel_chunks=args.data_parallel_chunks,
        tensor_parallel=args.tensor_parallel,
        sequence_parallel=args.sequence_parallel,
        overlap_device_host=args.overlap_device_host,
        pad_tail_chunks=args.pad_tail_chunks,
        chunk_compression=args.chunk_compression,
        global_kv_merge=args.global_kv_merge,
        visualize=args.visualize,
        viz_port=args.viz_port,
        output_dir=args.output,
        save_debug_projections=args.save_debug_projections,
        debug_overlap=args.debug_overlap,
        loop_closure=args.loop_closure,
        refine_observations=args.refine_observations,
        save_dense=args.save_dense or args.export_mesh,
        export_mesh=args.export_mesh,
        dense_stride=args.dense_stride,
        mesh_voxel_size=args.mesh_voxel_size,
        mesh_conf_threshold=args.mesh_conf_threshold,
        save_volume=args.save_volume,
        live_mesh_every=args.live_mesh_every,
    )
    msg = unported(config)
    if msg:
        parser.error(msg)
    paths = _frames(args, parser)
    print(f"{len(paths)} frames")

    slam = Pi3SLAMOnline(config)
    result = slam.process_image_paths(paths)
    loop_stats = slam.apply_loop_closure()
    telemetry_stats = slam.apply_telemetry()
    # after loop closure and telemetry: the mesh bakes in the final poses
    mesh_path = slam.export_mesh() if args.export_mesh else None
    os.makedirs(args.output, exist_ok=True)
    ply_path = os.path.join(args.output, "final_points.ply")
    slam.save_final_result(ply_path, max_points=args.max_points)
    tum_path = os.path.join(args.output, "trajectory_tum.txt")
    if args.tum_integer_timestamps:
        slam.save_trajectory_tum(tum_path)
    else:
        from .utils.timestamps import extract_timestamps_from_paths

        name_to_ts = {}
        for pth, t in zip(paths, extract_timestamps_from_paths(paths)):
            nm = f"{pth[0]}#{pth[1]}" if isinstance(pth, tuple) else str(pth)
            name_to_ts[nm.split("/")[-1]] = t / 1e9
        slam.save_trajectory_tum(tum_path, name_to_timestamp=name_to_ts)
    artifacts = {"points": ply_path, "trajectory": tum_path}
    if args.save_tum:
        # the reference names the online trajectory <output>/trajectory.tum
        artifacts["trajectory_tum"] = os.path.join(args.output, "trajectory.tum")
        shutil.copyfile(tum_path, artifacts["trajectory_tum"])
    if mesh_path:
        artifacts["mesh"] = mesh_path
    if slam.visualizer is not None:
        slam.visualizer.flush()  # the queued chunks and meshes shown before the CLI returns
        if args.keep_viz_open:
            print(f"visualization server on port {args.viz_port}; Ctrl-C to exit")
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
    return {**result, "queue_status": slam.queue_status(),
            "chunk_launches": slam.chunk_launches, "loop_closure": loop_stats,
            "telemetry": telemetry_stats, "artifacts": artifacts}


def main(argv=None) -> int:
    run_online(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
