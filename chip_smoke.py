#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pi3_slam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. Print the card's name and power limit, build the hand-written kernels
   from the sources in this checkout (one nvcc per source, all at once) and
   print the build time.
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes (Pi3, MoGe-2, the cross-attention block), in bf16: max
   error against the stated tolerance; the kernel's and the plain version's
   time (CUDA events), the bound (the least time the card could take: bytes
   over 3.35 TB/s or operations over 989 TFLOP/s bf16, whichever is larger),
   for the packed attention kernel also its exp2 over 3.9e12/s, and, for the
   attention kernels, the time of
   torch.nn.functional.scaled_dot_product_attention on the same q, k and v
   (a yardstick only: the port never calls it). The padded frame shape runs
   with zero and with NaN rows past true_t; flash_attention and
   flash_attention_partial with NaN keys past Tk, attention_single_pass with
   NaN rows past Tq, block_mlp and mlp with NaN rows past M, each
   bit-identical to the output of finite rows (and the MLP entries to a
   second call). Head dims 256 and 192 at (1, 8192, 4, D) and (100, 643,
   4, D) hold the loop's 80-key tiles (at D 256 keys past Tk 4100 NaN,
   bit-identical, and a second call bit-identical to the first). Beside
   block_mlp and mlp, the two bare bf16 cuBLAS products of the same shapes
   (F.linear without bias) as a products yardstick. Head
   dims 320, 384 and 512 at (1, 4100, 2, D) and (100, 643, 2, D), and 1152
   at (1, 4100, 2, D), hold the wide variant of the (B, T, H, D) loop that
   flash_attention and attention_single_pass run above head dim 256 (keys
   past Tk NaN at the first shape, bit-identical); the kernels line reports
   them under the entry's "routes". The producer's record also gives its effective TB/s
   (its bytes over its time). Then the dots-only probe kernel (the
   products-only mode of the (B, T, H, D) loop) at (1, 65536, 3072), and the
   fp32 entries of every other kernel at the main paths' shapes, against
   their fp32 plain versions (TF32 off) with the bounds of ops/compare.FP32,
   each also shown to reject the bf16 entry's output on the same inputs;
   their bound is the products over 3xTF32's 165 TFLOP/s (or the bytes), the
   library yardstick fp32 SDPA or the two fp32 cuBLAS products. Every fp32
   attention entry (the TMA + wgmma loop of csrc/bthd_attention_f32.cuh at
   every head dim) repeats its output bit for bit on a second call. The
   fp32 (B, T, H, D) attention runs at head dim 64 (the global and frame
   shapes, route "d64") and on the loop's sliced variant (route "sliced")
   at 128 (views) and 256 at (1, 8192, H, D), 192 and 320 at (100, 643, H,
   D) and 320, 384 and 512 at (1, 4100, 2, D), keys past Tk NaN at D 256
   and 512 leaving the output bit-identical; each is reported under
   "routes" too. Last the focal / shift solve (csrc/focal_shift.cu) at
   (100, 4096) and (1, 4096) against the eager solve on the card (rtol 1e-5
   on the focal, atol 1e-5 on the shift; a second call bit for bit), with
   the eager solve's device time (its kernels summed over a profiler trace)
   and host time (the enqueue of its launches) beside the kernel's.
3. Full-width forwards with random weights (seed 0): Pi3 on a 4-frame chunk
   at 308x406, exact and with global_kv_merge=2, in bf16 and in fp32, MoGe-2
   (ViT-S backbone, fp32 trunk as MoGeRunner builds it) on one 308x406
   frame, the cross-attention block at Pi3's decoder widths over one frame's
   and four frames' tokens (bf16 and fp32), and two Blocks off the packed
   kernels' widths (8 heads of 128, bf16 and fp32: the fp32 one reaches the
   sliced fp32 attention through sdpa; C 320); the kernel path on the card
   against the plain path (fp32 on the host CPU): bf16 within 5e-2, fp32
   within 1e-3, with each run's launch counts (counts set to 0 just before
   it).
4. The main paths through the port's CLI over 130 synthetic 640x480 frames,
   chunks of 100 with overlap 20, 400 grid keypoints: with MoGe-2 metric
   scale from a random-weight MoGe npz (the 7-Scenes evaluation protocol),
   with --global-kv-merge 2 --no-metric-depth, and with --compute-dtype
   float32 (MoGe-2 as in the first). Each: two chunk files (100 frames, and
   a 50-frame tail padded to 100 by repeating its last frame, its outputs
   sliced back) and a manifest with the JAX creator's keys and finite
   values, the seconds and frames/s of each chunk, and the kernel launch
   counts of the run (counts set to 0 just before it).
5. sol: the speed-of-light probe through its entry point
   (pi3_slam_tpu_torch.tools.perf_lab sol): a square 8192^3 bf16 matmul,
   dots_attention, flash_attention_packed, flash_attention over the same
   q / k / v views (the loop dots_attention runs, with its softmax) and
   block_mlp at (1, 65536, ...),
   with the run's launch counts and each kernel's TFLOP/s as a share of the
   matmul's; then SDPA's time and the packed kernel's two bounds at the
   probe's attention shape.
6. reconstruct: (a) the port's reconstructor CLI on phase 4's metric-depth
   chunks, images to trajectory (130 finite poses, both PLY files); (b)
   eval-scale synthetic chunks (420 frames: five chunks of 100 and a 20-frame
   tail, 400 keypoints, overlap 20, confidence outliers; the scene of
   tests/test_system_ape.py from pi3_slam_tpu_torch/tools/synthetic.py)
   reconstructed on the card at the evaluation settings (10 BA and at most 50
   refine iterations): APE RMSE < 0.07 m, 5 alignments with > 2000 common
   tracks each, 10 BA iterations per chunk, per-chunk reconstruction, BA and
   alignment seconds; then chunk 0's BA from one start on the card and on the
   host CPU, where the damping still fixes the solution (one step: rotations
   within 1e-5; four steps: centers within 5e-5 after one similarity, costs
   within 1e-4 relative), each bound shown to reject the host's result with
   1% of the tracks removed; and the first two chunks end to end on both,
   every pose within 2e-2 m after one similarity, a second card run
   bit-identical to the first (the BA sums in a fixed order), and a run
   without BA printed beside them.
7. online: (a) the port's online CLI in process (python -m
   pi3_slam_tpu_torch.pi3_slam_online) over phase 4's 130 frames at the
   7-Scenes online settings (chunks of 100, overlap 20, 400 keypoints,
   MoGe-2 from phase 4's npz, --tum-integer-timestamps --save-tum): 2 chunks
   (the 50-frame tail padded to 100), both TUM files with 130 finite poses
   stamped 0-129, final_points.ply, the queue status (2 consumed, none in
   flight, 1 alignment) and each chunk's launch counts (counts set to 0 just
   before the run); (b) the drive modes over 260 frames (3 chunks of 100 and
   a 20-frame tail): sync, then async (BA and the Sim3 fits on the card, on
   the consumer threads' own streams), each run's FPS line, stage times and
   queue status, the async merged trajectory within 1e-5 m of the sync one,
   and the async wall time against the sync one and against the sync run's
   forward + pull and SfM stages; (c) async with the SfM on the host CPU
   (sfm_backend 'cpu') and sync without BA, the same numbers beside them, and
   the host's and the run without BA's distances from the card's trajectory
   after one similarity (not held: random weights leave that trajectory to
   fp32 rounding); (d) chunk 0's BA beside loads; (e) the online SfM chain
   fed phase 6's eval-scale synthetic chunks in place of the chunk step, on
   the card, on the host and on the card without BA: the card within 3e-3 m
   of the host after one similarity, the run without BA outside it.
8. eval: (a) the converter CLI (python -m
   pi3_slam_tpu_torch.tools.convert_checkpoint) on a reference-named Pi3
   model.safetensors made from init_pi3_params(0) (full width) and a MoGe-2
   model.pt from init_moge_params(0, moge_vits_config()): every converted
   leaf equal to the random tree, the embedded config Pi3Config(), each
   conversion's seconds; (b)-(d) the eval tool (python -m
   pi3_slam_tpu_torch.tools.eval) on those checkpoints: 7-Scenes offline and
   online on one fabricated scene (phase 4's 130 frames, pose files), EuRoC
   MH_03 (530 frames at 752x480, the first 400 skipped, a radial-tangential
   calibration): per run the seconds, frames/s into chunks or through the
   online CLI, reconstruction seconds per chunk, a finite APE over 130 poses
   against the ground truth the tool makes, and two chunks that each
   launch the metric-depth path's kernels; the runs' launch counts are the
   kernels line's "eval" path.
9. appearance: (a) the converter CLI with --model aliked on a lightglue-named
   aliked-n16 state dict from init_aliked_params(0), every leaf equal to the
   tree; (b) the eval tool's 7-Scenes offline and online runs on phase 8's
   scene and checkpoints with --keypoints aliked --aliked-npz --refine
   --loop: chunks with keypoint_valid, float16 descriptors and the refined
   fan, all finite, per chunk the refined share and the seconds of ALIKED, of
   the refinement (device) and of the chunk, the metric-depth path's launches
   a chunk (the kernels line's "appearance" path), the APE printed (random
   weights); then phase 4's 130 frames through the creator CLI with MoGe-2
   and phase 8's converted Pi3, --keypoints aliked --refine-observations:
   its second chunk's seconds beside phase 4's grid-keypoint run's; (c) ALIKED-n16's dense maps on the
   card against the host CPU, then detection and SDDH on both from the card's
   maps, and its time for a 100-frame chunk; (d) ZNCC on the card: planted
   sub-pixel shifts recovered, card against host on 100 frames at 308x406
   with a keypoint at the last frame's bottom-right corner, the time at 300
   keypoints with fan 7 and 400 with fan 10; (e) the reconstructor CLI on
   tests/test_loop_system.py's circle (copied): the first-last loop edge
   found on the card, the loop-closed APE below the open one, the card's
   loop-closed trajectory within LOOP_TOL of the host's after a similarity
   and the open one outside.
10. localization and telemetry: (a) a second camera: the creator CLI with
   --keypoints aliked on phase 8's scene frames from the 16th on (two chunks,
   each launching the metric-depth path's kernels: the kernels line's
   "localization" path), then python -m pi3_slam_tpu_torch.localize_camera
   --query-chunks against phase 9's offline ALIKED map on the card: exit code
   0 or 1 and one stats entry per chunk (random weights match nothing:
   printed, not held); (b) planted registration at eval scale: a map of 4
   chunks x 100 frames x 400 tracks with 128-d unit descriptors, 2 query
   chunks under a known Sim3 (scale 1.3) with 20% of the points displaced,
   register_reconstruction on the card and the host: the Sim3 against the
   truth and card against host; (c) planted PnP: 100 query images with 1000
   matches each against the pooled map, 0.5 px noise, 30% outliers,
   localize_by_descriptors on the card (and on the host for every fifth
   image, the same samples): poses against the truth, card against host, the
   same inlier counts, the per-image seconds of matching, RANSAC and
   refinement; then triangulate_points of a planted cloud from the localized
   views: the reprojection RMS under the CLI's 3 px gate and the points
   against the truth, card against host; (d) the reconstructor CLI with
   --telemetry --gps-sigma 0.5 --save-colmap on 260 frames of phase 6's
   chunks (with a sideways sway, frames named by timestamps) and
   generic-JSON telemetry (GPS about the true ENU track with 0.5 m noise,
   camera-frame gravity with noise), on the card and on the host: the
   georeferenced trajectory against the true ENU track and card against host
   with no similarity, the gravity residual, the COLMAP model's counts, and
   the telemetry refine's seconds a chunk.
11. mapping: (a) the creator CLI with --save-dense on phase 4's 130 frames
   (MoGe-2, phase 8's converted random Pi3; two chunks, each launching the
   metric-depth path's kernels: the kernels line's "mapping" path), then the
   reconstructor CLI with --export-mesh --save-volume --render-previews 2:
   fused_mesh.ply reads back with finite vertices and faces in range,
   fused_volume.npz loads, four preview PNGs; the fusion, meshing and raycast
   seconds (random weights decide the geometry: printed, not held); (b) a
   planted scene at eval
   scale: 100 analytic depth views at 154x203 of the unit sphere of
   tests/test_mapping.py (copied), coloured, fused on the card into 189^3
   voxels: the surface-nets mesh within 1.5 voxels of the sphere at the
   median and 3 at the 95th percentile, the median colour within 0.05; a
   second card fusion bit-identical (the voxel -> pixel gather has no
   atomics); the first 20 frames on the card and on the host CPU: at most
   1e-4 of the voxels differ by more than 1e-5 (the pixel index rounds; where
   u lands within rounding of .5 another summation order picks the next
   pixel); 4 raycasts on the card within one voxel of the analytic depth on
   99% of the interior rays that hit (the analytic silhouette less its
   1-pixel rim), card and host hit masks compared; the fusion's seconds per
   chunk beside the bytes bound of a frame-at-a-time pass (40 B a voxel and
   frame over 3.35 TB/s) and the raycast's ms per view; (c) the online CLI in
   process with --export-mesh --save-volume --live-mesh-every 1 over phase
   4's 130 frames: fused_mesh.ply, fused_volume.npz, at least one "live
   mesh:" line and no "live mesh refresh failed" line (the live refresh runs
   on the host CPU), the wall time beside phase 7 (a)'s; (d) the tsdf probe
   (python -m pi3_slam_tpu_torch.tools.perf_lab tsdf).
12. the last single-device modules: (c) a random full-width MoGe v1 state
   dict (ViT-L, the 'exp' remap, the dataclass defaults otherwise, seed 0,
   the reference naming)
   written as a model.pt with torch.save, through the converter tool ("detected
   MoGe v1 checkpoint layout"); (a) moge_v1_infer from the converted file on
   a 308x406 frame at 2500 tokens (2,452 tokens a block, 24 fp32 blocks: the
   kernels line's "moge_v1" path) on the card against the host's fp32 path:
   points and depth inside both masks, the mask score and the four backbone
   layers the head reads within relative L2 1e-3, the masks agreeing on 99.9%
   of the pixels, and the bf16 trunk outside that bound; rows 2 and 4 fp32 at those shapes against their
   plain versions, NaN rows past T bit-identical, beside their bounds and
   library calls (the kernels line's "moge_v1" sub-rows); (b) the online CLI
   with --visualize --save-debug-projections over 45 frames: one [viz] line a
   chunk and a GIF a chunk, or without matplotlib its failure line a chunk;
   the debug projections' numbers on phase 6's first chunk, card against
   host; (d) perf_lab all, mlp-sweep, refine and kv-accuracy in one process
   (the "probes" path; each kernel shape a probe times is first held against
   its plain version, uncounted), then trace_summary on a --profile-dir
   creator run.
13. the repo-root tools (pi3_slam_tpu_torch/tools), in process, each printing
   its JSON line: (a) perf_pipeline at its defaults (420 frames of 640x480
   noise, chunks of 100 with overlap 20: five and a 20-frame tail padded to
   100; 400 grid keypoints) with phase 4's MoGe-2 npz, (b) the same with
   --online on its workdir: per run six chunks of the metric-depth path's
   launches, five intervals, finite chunk files; (c) perf_online_floor on the
   card and with --device cpu: the BA iteration counts of its six chunks
   (five and a 20-frame tail), steady seconds beside each other; (d)
   import_reference_chunks on a reference .pt directory
   (tools/synthetic.py: tests/test_import_reference_chunks.py's fixture's
   files), then the reconstructor
   CLI on the card: 6 finite poses; (e) smoke_e2e at its defaults (ALIKED,
   refinement, dense maps, loop closure, COLMAP, the mesh; its CLIs in
   processes of their own, uncounted) on phase 8's Pi3 and phase 9's ALIKED
   files; (f)
   kv_merge_drift --full --seeds 0 (fp32): eight rows, each merged run apart
   from the exact one (trans_rel > 1e-8), the fp32 exact and merged forwards'
   launches, and the floor of an exact run against a second one; (g)
   ablate_observation_fan at eval scale with seed 0 (six chunks): both fans
   5/5 alignments and a finite APE. The phase's launches are the kernels
   line's "tools" path.
14. multi-device (pi3_slam_tpu_torch/parallel), full width (Pi3Config(),
   bf16, random seed 0), on meshes whose devices repeat the one card: (a)
   make_sharded_chunk_step on a dp 2 mesh over phase 4's two chunk windows
   (frames 0-99, and 80-129 with the tail padded), each chunk's outputs bit
   for bit the single-device step's; (b) the forward over frames 0-99 on dp 1
   x tp 2 and on dp 1 x tp 1 x sp 2 (ring attention in the 18 global blocks),
   pointmaps, confidence and poses against the single-device step within
   relative L2 SHARD_TOL, the single-device unpacked route as a control, a
   10%-off output rejected; the ring's own share in fp32 over frames 0-19:
   sp 2 against the control and tp 2 x sp 2 against tp 2 within RING_TOL, a
   faulty ring (one key shard met at every step) rejected; (c) ring attention
   alone at (1, 64300, 16, 64), sp 2 and sp 4, against row 6's flash kernel
   on the same q, k, v, and again with its last tenth zero-padded keys taken
   out by their count (the same ring leaving them in is rejected), each ring
   step's row-5 launch timed beside its bound, and rows 6 and 7 at the tp 2
   shards' shapes against their plain versions beside their bounds and SDPA
   (the kernels line's "multidevice_shapes"); (d) the creator API with
   --data-parallel-chunks 2 and MoGe-2 over phase 4's 130 frames on
   [cuda:0] * 2 (one group: two chunks, the second a padded tail), its chunk
   files bit for bit phase 4's single-device chunks; (e) the online API with
   dp 2 over the same frames, SfM on the card: two chunks consumed, 130
   finite poses, the queue reading dp 2; (f) phase 11's planted sphere fused
   with fuse_tsdf(mesh=) over dp 4, bit for bit the single-device fusion.
   Each run's launch counts (set to 0 just before it) are the kernels line's
   "multidevice" path; any seconds printed are of replicas that share one
   card, not a speed figure. (b) also runs dp 1 x tp 2 x sp 2.

multi_card_check.py runs phase 14 over four distinct cards.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
try:  # the card's peaks, the bounds and the checks: perf_lab's too
    from pi3_slam_tpu_torch.ops.roofline import (
        PEAK_3XTF32, PEAK_BF16, PEAK_BYTES, PEAK_FP32, attention_flops, bound, exp2_ms,
        focal_shift_work, mlp_work)
    # a kernel's output against its plain version's, or raise
    from pi3_slam_tpu_torch.ops.compare import hold as check
    # the eval-scale synthetic scene of the system APE gates
    from pi3_slam_tpu_torch.tools.synthetic import (
        EVAL_SCALE, make_synthetic_sequence, write_synthetic_chunks)
except ImportError:  # not a checkout, or no PyTorch: main() says which
    pass

# per-kernel: route, source, the TPU kernel it replaces
KERNELS = {
    "qkv_rope_producer": (
        "cuda", "pi3_slam_tpu_torch/csrc/qkv_producer.cu", "pi3_slam_tpu/ops/pallas_producer.py:169"),
    "attention_single_pass_packed": (
        "cuda", "pi3_slam_tpu_torch/csrc/packed_attention.cu", "pi3_slam_tpu/ops/pallas_attention.py:636"),
    "flash_attention_packed": (
        "cuda", "pi3_slam_tpu_torch/csrc/packed_attention.cu", "pi3_slam_tpu/ops/pallas_attention.py:504"),
    "flash_attention_partial": (
        "cuda", "pi3_slam_tpu_torch/csrc/partial_attention.cu", "pi3_slam_tpu/ops/pallas_attention.py:235"),
    "block_mlp": (
        "cuda", "pi3_slam_tpu_torch/csrc/block_mlp.cu", "pi3_slam_tpu/ops/pallas_mlp.py:343"),
    "flash_attention": (
        "cuda", "pi3_slam_tpu_torch/csrc/attention.cu", "pi3_slam_tpu/ops/pallas_attention.py:302"),
    "attention_single_pass": (
        "cuda", "pi3_slam_tpu_torch/csrc/attention.cu", "pi3_slam_tpu/ops/pallas_attention.py:797"),
    "mlp": (
        "cuda", "pi3_slam_tpu_torch/csrc/block_mlp.cu", "pi3_slam_tpu/ops/pallas_mlp.py:285"),
    "dots_attention": (
        "cuda", "pi3_slam_tpu_torch/csrc/dots_attention.cu", "tools/perf_lab.py:107"),
    "focal_shift": (
        "cuda", "pi3_slam_tpu_torch/csrc/focal_shift.cu",
        "none: XLA's loop of pi3_slam_tpu/geometry/focal.py:66"),
}
# the loop a kernel runs, where its source does not say it alone
LOOPS = {"dots_attention": "pi3_slam_tpu_torch/csrc/bthd_attention.cuh (products-only mode)",
         **{f"{name}_fp32": "pi3_slam_tpu_torch/csrc/bthd_attention_f32.cuh: "
                            "attention_f32_tma_kernel at head dim 64, its sliced variant "
                            "attention_f32_wide_tma_kernel above (routes)"
            for name in ("flash_attention", "attention_single_pass")}}
# the fp32 entries (an fp32 model's activations: --compute-dtype float32,
# MoGe-2's encoder), each its own kernel beside the bf16 one of its wrapper;
# every fp32 attention launch runs the TMA + wgmma loop of
# bthd_attention_f32.cuh (the (B, T, H, D) ones above head dim 64 its sliced
# variant)
F32_LOOP = "pi3_slam_tpu_torch/csrc/bthd_attention_f32.cuh"
F32_SOURCES = {
    "qkv_rope_producer": "pi3_slam_tpu_torch/csrc/qkv_producer.cu",
    "block_mlp": "pi3_slam_tpu_torch/csrc/gemm_f32.cuh",
    "mlp": "pi3_slam_tpu_torch/csrc/gemm_f32.cuh",
    "attention_single_pass_packed": F32_LOOP,
    "flash_attention_packed": F32_LOOP,
    "flash_attention_partial": F32_LOOP,
    "flash_attention": F32_LOOP,
    "attention_single_pass": F32_LOOP,
}
KERNELS.update({
    f"{name}_fp32": ("cuda", F32_SOURCES[name], replaces)
    for name, (_, _, replaces) in list(KERNELS.items())
    if name not in ("dots_attention", "focal_shift")})
# launches of one Pi3 forward over a chunk: 36 decoder + 15 head producer
# passes; 24 encoder + 18 frame + 15 head single-pass; 18 global; 75 block MLPs
# (the nonzero counts of a run; an fp32 model runs the same counts on the
# <name>_fp32 entries)
PI3_LAUNCHES = {
    "qkv_rope_producer": 51,
    "attention_single_pass_packed": 57,
    "flash_attention_packed": 18,
    "block_mlp": 75,
}
# with global_kv_merge > 1 the 18 global blocks do qk-norm and RoPE in plain
# torch (no producer pass) and run the partial kernel
PI3_KV_MERGE_LAUNCHES = {"qkv_rope_producer": 33, "attention_single_pass_packed": 57,
                         "flash_attention_partial": 18, "block_mlp": 75}
# MoGe-2's 12 ViT-S encoder blocks on the chunk's first frame, in fp32 as the
# JAX runner computes them
MOGE_LAUNCHES = {"attention_single_pass_packed_fp32": 12, "block_mlp_fp32": 12}
# the focal / shift solve: one launch for the chunk step's intrinsics (all its
# frames), one for MoGe-2's depth shift on the chunk's first frame
FOCAL_LAUNCHES = {"focal_shift": 1}


def fp32(counts: dict) -> dict:
    """The same launches on the fp32 entries."""
    return {f"{name}_fp32": n for name, n in counts.items()}


def add(*counts: dict) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


PATH_LAUNCHES = {  # launches per chunk of each main path through the CLI
    "metric_depth": add(PI3_LAUNCHES, MOGE_LAUNCHES, FOCAL_LAUNCHES, FOCAL_LAUNCHES),
    "kv_merge": add(PI3_KV_MERGE_LAUNCHES, FOCAL_LAUNCHES),
    "float32": add(fp32(PI3_LAUNCHES), MOGE_LAUNCHES, FOCAL_LAUNCHES, FOCAL_LAUNCHES),
}
# launches of one forward of each phase-3 block (nonzero counts): the cross
# block's self-attention takes the producer and a packed entry (single-pass
# at T <= 1280, flash above), its cross-attention sdpa's (B, T, H, D) entry of
# the same length, its MLP the mlp kernel; a Block at head dim 128 takes the
# unpacked route; a Block at C 320 the packed route and the plain MLP half
BLOCK_LAUNCHES = {
    "cross_block_frame": {"qkv_rope_producer": 1, "attention_single_pass_packed": 1,
                          "attention_single_pass": 1, "mlp": 1},
    "cross_block_global": {"qkv_rope_producer": 1, "flash_attention_packed": 1,
                           "flash_attention": 1, "mlp": 1},
    "block_d128": {"attention_single_pass": 1, "block_mlp": 1},
    "block_c320": {"qkv_rope_producer": 1, "attention_single_pass_packed": 1},
}
BLOCK_LAUNCHES.update({f"{path}_fp32": fp32(c) for path, c in list(BLOCK_LAUNCHES.items())
                       if path.startswith("cross") or path == "block_d128"})
FRAME_T = 643  # 638 patches (22 x 29 at 308x406) + 5 register tokens
N_FRAMES = 100
MOGE_T = 3537  # 52 x 68 patches of a 308x406 frame at 3600 tokens + cls


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


def sdpa_ms(q, k, v, scale: float, iters: int) -> float:
    """The time of one torch.nn.functional.scaled_dot_product_attention call
    on (B, T, H, D) q / k / v passed as (B, H, T, D) views (any copy it makes
    included): the library yardstick of the attention kernels."""
    import torch

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: sdpa(qt, kt, vt, scale=scale), iters)


def nan_rows(x, t: int) -> None:
    """Rows t.. of x (B, T, ...) set to NaN in place."""
    x[:, t:] = float("nan")


def same_bits(name: str, shape: str, got, want, what: str = "finite rows") -> None:
    """A kernel's output on inputs cut from NaN-tailed buffers against its
    output on finite ones: equal bit for bit, or the kernel read a row past
    the length (what = "a second call": the same call twice, which a kernel
    without atomics repeats to the bit)."""
    import torch

    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  {name:32s} {shape}: bit-identical to {what} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} {shape}: not bit-identical to {what}")


def gemm_bits(name: str, shape: str, x, fn) -> None:
    """fn (an MLP entry) on x cut from a buffer with NaN rows behind it
    against fn on x itself, and fn twice on the same x."""
    import torch

    buf = torch.full((1, x.shape[1] + 128, x.shape[2]), float("nan"), device="cuda",
                     dtype=x.dtype)
    buf[:, :x.shape[1]] = x
    got = fn(buf[:, :x.shape[1]])
    del buf
    want = fn(x)
    same_bits(name, f"{shape}, NaN rows past M", got, want)
    same_bits(name, shape, fn(x), want, "a second call")


def products_ms(shape: str, x, w1, w2, iters: int) -> float:
    """The two bare cuBLAS products of an MLP at x's shape and dtype
    (F.linear(x, w1), F.linear(h, w2) with no bias; fp32 with TF32 off): a
    yardstick for the fused GEMMs that computes less than they do (not
    library_ms: no single call computes the fused function)."""
    import torch
    import torch.nn.functional as F

    h = torch.empty(*x.shape[:-1], w1.shape[0], device="cuda", dtype=x.dtype).normal_()
    ms = time_ms(lambda: (F.linear(x, w1), F.linear(h, w2)), iters)
    dt = str(x.dtype).replace("torch.", "")
    log(f"  {'products yardstick':30s} {shape:28s} 2 x F.linear ({dt}, no bias) {ms:9.3f} ms")
    return ms


def check_fp32(name: str, shape: str, got, ref, bf16_got, why: str, **bounds):
    """An fp32 entry's output against its fp32 plain version (check), and the
    same bounds against the bf16 entry's output on the same inputs, which
    they must reject: the path is really fp32."""
    import torch

    from pi3_slam_tpu_torch.ops.compare import compare

    if got.dtype != torch.float32:
        raise RuntimeError(f"{name} {shape}: the fp32 entry returned {got.dtype}")
    c = check(name, shape, got, ref, why, **bounds)
    b = compare(bf16_got.float(), ref, **bounds)
    log(f"  {name:32s} {shape:28s} the bf16 entry: {b} {'rejected, ok' if not b.ok else 'PASSES, FAIL'}")
    if b.ok:
        raise RuntimeError(f"{name} {shape}: the fp32 bounds pass the bf16 entry's output ({b})")
    return c


def focal_shift_inputs(g, n: int, h: int = 308, w: int = 406):
    """points (n, 4096, 3), uv (4096, 2) and weight (n, 4096) as
    recover_focal_shift hands them to the solve: n noisy pinhole maps (focal
    1.3, shift 0.4, z in [2, 3)) at h x w, 70% of pixels masked in, resized
    to 64 x 64."""
    import torch

    from pi3_slam_tpu_torch.geometry.maps import nearest_resize, normalized_view_plane_uv

    uv = normalized_view_plane_uv(w, h, device="cuda")
    z = 2 + torch.rand(n, h, w, generator=g, device="cuda")
    pts = torch.cat([uv[None] * (z[..., None] + 0.4) / 1.3, z[..., None]], dim=-1)
    pts = pts + 0.01 * torch.randn(pts.shape, generator=g, device="cuda")
    mask = (torch.rand(n, h, w, generator=g, device="cuda") > 0.3).float()
    return (nearest_resize(pts, (64, 64)).reshape(n, -1, 3),
            nearest_resize(uv, (64, 64)).reshape(-1, 2),
            nearest_resize(mask[..., None], (64, 64)).reshape(n, -1))


def device_ms(fn) -> float:
    """The device time of one call of fn: its kernels' times summed over a
    profiler trace (CUDA events around a call that the host enqueues more
    slowly than the card runs it would time the enqueue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from pi3_slam_tpu_torch.ops._build import build

    names = ("qkv_producer", "packed_attention", "partial_attention", "block_mlp", "attention",
             "dots_attention", "attention_f32", "focal_shift")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    for name, (so, seconds) in zip(names, built):
        log(f"  built {name}.cu in {seconds:.1f}s -> {os.path.relpath(so, REPO)}")
        report = so.with_suffix(".so.log").read_text() if seconds else ""
        for line in report.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    from pi3_slam_tpu_torch.ops._build import load_library

    lib = load_library("block_mlp")
    log(f"    block_mlp.cu GEMMs: {lib.pi3_gemm_smem_bytes()} (bf16), "
        f"{lib.pi3_gemm_f32_smem_bytes()} (fp32) bytes of dynamic shared memory a block")


def rope_for(b: int, frames_per_row: int):
    """cos/sin tables of the decoder at 22 x 29 patches + 5 register tokens."""
    from pi3_slam_tpu_torch.ops.rope import make_patch_positions, rope_tables

    pos = make_patch_positions(b * frames_per_row, 22, 29, num_special=5, offset=1, device="cuda")
    cos, sin = rope_tables(pos, 64)
    return cos.reshape(b, frames_per_row * FRAME_T, 64), sin.reshape(b, frames_per_row * FRAME_T, 64)


def phase_kernels() -> dict:
    """Each kernel vs its plain version at the main paths' shapes (bf16)."""
    import torch

    from pi3_slam_tpu_torch.ops.block_mlp import block_mlp, block_mlp_plain
    from pi3_slam_tpu_torch.ops.compare import (
        ATTENTION, DOTS, FP32, MLP, PARTIAL_L, PRODUCER, block_mlp_bounds)
    from pi3_slam_tpu_torch.ops.dots_attention import dots_attention, dots_attention_plain
    from pi3_slam_tpu_torch.ops.flash_attention import (
        attention_single_pass, blockwise_attention, flash_attention)
    from pi3_slam_tpu_torch.ops.focal_shift import solve_shift, solve_shift_plain
    from pi3_slam_tpu_torch.ops.mlp import mlp, mlp_plain
    from pi3_slam_tpu_torch.ops.packed_attention import (
        attention_single_pass_packed, flash_attention_packed, packed_attention_plain)
    from pi3_slam_tpu_torch.ops.partial_attention import (
        flash_attention_partial, partial_attention_plain)
    from pi3_slam_tpu_torch.ops.qkv_producer import qkv_rope_producer, qkv_rope_producer_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    H, C = 16, 1024
    results = {}

    def record(name, shape, checks, ms, plain_ms, work, library_ms=None, exp2=None,
               route=None):
        """work = (flops, bytes[, peak]) of one call at this shape; exp2 = the
        call's count of exp2 (one per logit), printed as its own bound beside
        the products' (bound() leaves it out); route = a name under which this
        shape is also reported, for a second loop of the same kernel."""
        r = results.setdefault(name, {"max_abs_err": 0.0, "rel_l2": 0.0, "routes": {}})
        for c in checks:
            r["max_abs_err"] = max(r["max_abs_err"], c.max_abs_err)
            r["rel_l2"] = max(r["rel_l2"], c.rel_l2)
        bound_ms, bound_by = bound(*work)
        exp2_bound = None if exp2 is None else exp2_ms(exp2)
        if "ms" not in r:  # the first shape listed is the one reported
            r.update(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms)
        if route is not None:
            r["routes"].setdefault(route, {})[shape] = dict(
                max_abs_err=max(c.max_abs_err for c in checks), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        lib = "" if library_ms is None else f"   library {library_ms:9.3f} ms"
        ex = "" if exp2_bound is None else f"   exp2 bound {exp2_bound:8.3f} ms"
        log(f"  {name:30s} {shape:28s} kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms   "
            f"bound {bound_ms:8.3f} ms ({bound_by}){ex}{lib}")

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
        # q and k: LayerNorm statistics (4 fp32 ops per element), normalise
        # and affine (3), RoPE (3), the scale on q (1)
        work = (2 * b * t * C * 11, 2 * qkv.numel() * 2 + 2 * cos.numel() * 4, PEAK_FP32)
        ms = time_ms(run, 10)
        record("qkv_rope_producer", shape_name, checks, ms, time_ms(plain, 3), work)
        tbps = work[1] / ms / 1e9
        results["qkv_rope_producer"].setdefault("tb_per_s", {})[shape_name] = tbps
        log(f"  {'qkv_rope_producer':30s} {shape_name:28s} {tbps:.3f} TB/s effective "
            f"({work[1] / 1e6:.0f} MB in and out)")
        produced[shape_name] = ref

    attn = dict(why="bf16 P, bf16 output", **ATTENTION)
    ln2 = math.log(2.0)  # softmax_2(x) = softmax(x ln 2)

    def packed_work(qkv):
        b, t, c3 = qkv.shape
        return attention_flops(b, c3 // 192, t, t, 64), qkv.numel() * 2 + qkv.numel() // 3 * 2

    def packed_exp2(qkv):
        b, t, c3 = qkv.shape
        return b * (c3 // 192) * t * t

    def packed_sdpa_ms(qkv, q_scale, iters):
        b, t, c3 = qkv.shape
        q, k, v = qkv.view(b, t, 3, c3 // 192, 64).unbind(2)
        return sdpa_ms(q, k, v, q_scale * ln2, iters)

    raw = randn(N_FRAMES, FRAME_T, 3 * C)
    scale = 64**-0.5 * 1.4426950408889634
    for shape_name, qkv, q_scale in (("(100, 643, 3072) producer", produced["(100, 643, 3072) norm"], 1.0),
                                     ("(100, 643, 3072) q_scale", raw, scale)):
        run = lambda: attention_single_pass_packed(qkv, H, q_scale=q_scale)
        plain = lambda: packed_attention_plain(qkv, H, q_scale=q_scale)
        c = check("attention_single_pass_packed", shape_name, run(), plain(), **attn)
        record("attention_single_pass_packed", shape_name, [c], time_ms(run, 10), time_ms(plain, 3),
               packed_work(qkv), packed_sdpa_ms(qkv, q_scale, 10), packed_exp2(qkv))
    # padded keys (the producer's zero rows) are masked by length; rows past
    # true_t full of NaN must not reach the output either (the kernel reads
    # none of them), which the unpadded input's output shows bit for bit
    unpadded = produced["(100, 643, 3072) norm"]
    padded = torch.nn.functional.pad(unpadded, (0, 0, 0, 61))
    check("attention_single_pass_packed", "(100, 704, 3072) true_t=643",
          attention_single_pass_packed(padded, H, true_t=FRAME_T),
          packed_attention_plain(padded, H, true_t=FRAME_T), **attn)
    padded[:, FRAME_T:] = float("nan")
    got = attention_single_pass_packed(padded, H, true_t=FRAME_T)
    check("attention_single_pass_packed", "(100, 704, 3072) true_t=643 NaN", got,
          packed_attention_plain(padded, H, true_t=FRAME_T), **attn)
    if not torch.equal(got, attention_single_pass_packed(unpadded, H)):
        raise RuntimeError("attention_single_pass_packed: NaN padding rows changed the output")
    del padded, got

    qkv = produced["(1, 64300, 3072) norm"]
    run = lambda: flash_attention_packed(qkv, H)
    plain = lambda: packed_attention_plain(qkv, H)
    c = check("flash_attention_packed", "(1, 64300, 3072)", run(), plain(), **attn)
    record("flash_attention_packed", "(1, 64300, 3072)", [c], time_ms(run, 3), time_ms(plain, 1),
           packed_work(qkv), packed_sdpa_ms(qkv, 1.0, 3), packed_exp2(qkv))

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
        record("block_mlp", shape_name, [c], time_ms(run, 5), time_ms(plain, 5),
               mlp_work(x, w1))
        results["block_mlp"].setdefault("products_ms", {})[shape_name] = products_ms(
            shape_name, x, w1, w2, 5)
        if shape[0] == 1:
            gemm_bits("block_mlp", shape_name, x,
                      lambda a: block_mlp(a, *mlp_params[:6], ls=mlp_params[6]))

    # kv-merge global blocks: 64,300 queries against the 32,150 keys of 50
    # merged frame pairs (q after qk-norm and RoPE, unit-variance entries)
    tq, tk = N_FRAMES * FRAME_T, N_FRAMES // 2 * FRAME_T
    q, k, v = randn(1, tq, H, 64), randn(1, tk, H, 64), randn(1, tk, H, 64)
    kn = k.float().square().sum(-1).amax(1).sqrt()
    shape_name = f"(1, {tq}, 16, 64) x (1, {tk}, 16, 64)"
    run = lambda: flash_attention_partial(q, k, v, kn)
    plain = lambda: partial_attention_plain(q, k, v, kn)
    (acc, l), (acc_ref, l_ref) = run(), plain()
    checks = [check("flash_attention_partial acc", shape_name, acc, acc_ref, "bf16 P", **ATTENTION),
              check("flash_attention_partial l", shape_name, l, l_ref, "fp32 sums", **PARTIAL_L),
              check("flash_attention_partial acc/l", shape_name, acc / l[..., None],
                    acc_ref / l_ref[..., None], "bf16 P", **ATTENTION)]
    half = tk // 2  # two key shards with the shared global kn sum to the whole
    (a0, l0), (a1, l1) = (flash_attention_partial(q, k[:, s], v[:, s], kn)
                          for s in (slice(0, half), slice(half, tk)))
    checks += [check("flash_attention_partial 2 shards acc", shape_name, a0 + a1, acc_ref,
                     "bf16 P", **ATTENTION),
               check("flash_attention_partial 2 shards l", shape_name, l0 + l1, l_ref,
                     "fp32 sums", **PARTIAL_L)]
    del acc, l, acc_ref, l_ref, a0, a1, l0, l1
    # keys cut from the full-length buffers, NaN behind the 32,150th row: the
    # kernel reads no row past Tk, so acc and l match those of finite rows
    k_full, v_full = randn(1, tq, H, 64), randn(1, tq, H, 64)
    k_full[:, :tk] = k
    v_full[:, :tk] = v
    clean = flash_attention_partial(q, k_full[:, :tk], v_full[:, :tk], kn)
    nan_rows(k_full, tk)
    nan_rows(v_full, tk)
    got = flash_attention_partial(q, k_full[:, :tk], v_full[:, :tk], kn)
    same_bits("flash_attention_partial", f"{shape_name}, NaN keys past Tk", got, clean)
    del k_full, v_full, clean, got
    work = (attention_flops(1, H, tq, tk, 64),
            (q.numel() + k.numel() + v.numel()) * 2 + q.numel() * 4 + tq * H * 4)
    record("flash_attention_partial", shape_name, checks, time_ms(run, 3), time_ms(plain, 1), work)

    # MoGe-2's ViT-S encoder at 3,537 tokens: raw qkv (6 heads of 64) with the
    # softmax scale on the logits, and the 384 / 1536 block MLP
    c_s = 384
    qkv = randn(1, MOGE_T, 3 * c_s)
    shape_name = f"(1, {MOGE_T}, {3 * c_s}) q_scale"
    run = lambda: attention_single_pass_packed(qkv, 6, q_scale=scale)
    plain = lambda: packed_attention_plain(qkv, 6, q_scale=scale)
    c = check("attention_single_pass_packed", shape_name, run(), plain(), **attn)
    record("attention_single_pass_packed", shape_name, [c], time_ms(run, 10), time_ms(plain, 3),
           packed_work(qkv), packed_sdpa_ms(qkv, scale, 10), packed_exp2(qkv))
    for q_scale in (0.0, -0.3):  # any scale, as the JAX function takes: q zeroed or negated
        check("attention_single_pass_packed", f"(1, {MOGE_T}, {3 * c_s}) q_scale={q_scale}",
              attention_single_pass_packed(qkv, 6, q_scale=q_scale),
              packed_attention_plain(qkv, 6, q_scale=q_scale), **attn)
    x = randn(1, MOGE_T, c_s)
    mlp_params = (
        1 + 0.1 * torch.randn(c_s, generator=g, device="cuda"),
        0.1 * torch.randn(c_s, generator=g, device="cuda"),
        randn(4 * c_s, c_s, scale=0.05), randn(4 * c_s, scale=0.1),
        randn(c_s, 4 * c_s, scale=0.05), randn(c_s, scale=0.1),
        1 + 0.1 * torch.randn(c_s, generator=g, device="cuda"),
    )
    shape_name = f"(1, {MOGE_T}, {c_s})"
    run = lambda: block_mlp(x, *mlp_params[:6], ls=mlp_params[6])
    plain = lambda: block_mlp_plain(x, *mlp_params[:6], ls=mlp_params[6])
    ref = plain()
    c = check("block_mlp branch", shape_name, run(), ref, "bf16 fc outputs, bf16 out",
              **block_mlp_bounds(x, ref))
    record("block_mlp", shape_name, [c], time_ms(run, 10), time_ms(plain, 10),
           mlp_work(x, mlp_params[2]))
    results["block_mlp"]["products_ms"][shape_name] = products_ms(
        shape_name, x, mlp_params[2], mlp_params[4], 10)

    # the (B, T, H, D) route of sdpa: the cross-attention block's cross
    # attention (q and k after qk-norm and RoPE: contiguous, unit-variance
    # entries) at four frames' tokens x 25 (the global blocks' length; Tk =
    # Tq and the kv-merge-2 key count) and at one frame's tokens x 100
    # frames, and the unpacked self-attention of a block at head dim 128
    # (strided q / k / v views of the qkv projection)
    def bthd(name, shape_name, q, k, v, iters, plain_iters, route=None):
        fn = flash_attention if name == "flash_attention" else attention_single_pass
        run = lambda: fn(q, k, v)
        plain = lambda: blockwise_attention(q, k, v)
        c = check(name, shape_name, run(), plain(), **attn)
        b, tq, h, d = q.shape
        work = (attention_flops(b, h, tq, k.shape[1], d),
                (2 * q.numel() + k.numel() + v.numel()) * 2)
        record(name, shape_name, [c], time_ms(run, iters), time_ms(plain, plain_iters), work,
               sdpa_ms(q, k, v, d**-0.5, iters), route=route)

    tq = N_FRAMES * FRAME_T
    q, k, v = randn(1, tq, H, 64), randn(1, tq, H, 64), randn(1, tq, H, 64)
    bthd("flash_attention", f"(1, {tq}, 16, 64)", q, k, v, 3, 1)
    tk = tq // 2
    bthd("flash_attention", f"(1, {tq}, 16, 64) x (1, {tk}, 16, 64)", q, k[:, :tk].contiguous(),
         v[:, :tk].contiguous(), 3, 1)
    # the same keys as views of the full-length buffers, NaN behind row Tk
    clean = flash_attention(q, k[:, :tk], v[:, :tk])
    nan_rows(k, tk)
    nan_rows(v, tk)
    same_bits("flash_attention", f"(1, {tq}, 16, 64) x {tk}, NaN keys past Tk",
              flash_attention(q, k[:, :tk], v[:, :tk]), clean)
    del q, k, v, clean
    q, k, v = randn(1, 8192, 3, 8, 128).unbind(2)
    bthd("flash_attention", "(1, 8192, 8, 128) views", q, k, v, 10, 3)
    q, k, v = randn(N_FRAMES, FRAME_T, H, 64), randn(N_FRAMES, FRAME_T, H, 64), randn(
        N_FRAMES, FRAME_T, H, 64)
    bthd("attention_single_pass", f"({N_FRAMES}, {FRAME_T}, 16, 64)", q, k, v, 10, 3)
    # q, k and v cut from (100, 704) buffers with NaN behind row 643
    bufs = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 61)) for x in (q, k, v)]
    for buf in bufs:
        nan_rows(buf, FRAME_T)
    same_bits("attention_single_pass", f"({N_FRAMES}, {FRAME_T}, 16, 64), NaN rows past Tq",
              attention_single_pass(*(buf[:, :FRAME_T] for buf in bufs)),
              attention_single_pass(q, k, v))
    del bufs
    q, k, v = randn(N_FRAMES, FRAME_T, 3, 8, 128).unbind(2)
    bthd("attention_single_pass", f"({N_FRAMES}, {FRAME_T}, 8, 128) views", q, k, v, 10, 3)
    # head dims 256 and 192: the TMA + wgmma loop at its 80-key tiles, K and V
    # on mbarriers of their own; 8192 = 102 * 80 + 32 and 643 = 8 * 80 + 3
    # end in a partial tile. At D 256 a second call repeats the output bit for
    # bit, and keys past Tk 4100 (51 tiles and 20 keys) NaN leave it
    # bit-identical
    for d in (256, 192):
        q, k, v = randn(1, 8192, 4, d), randn(1, 8192, 4, d), randn(1, 8192, 4, d)
        bthd("flash_attention", f"(1, 8192, 4, {d})", q, k, v, 10, 3)
        if d == 256:
            same_bits("flash_attention", "(1, 8192, 4, 256)", flash_attention(q, k, v),
                      flash_attention(q, k, v), "a second call")
            tk = 4100
            clean = flash_attention(q, k[:, :tk].clone(), v[:, :tk].clone())
            nan_rows(k, tk)
            nan_rows(v, tk)
            same_bits("flash_attention", f"(1, 8192, 4, 256) x {tk}, NaN keys past Tk",
                      flash_attention(q, k[:, :tk], v[:, :tk]), clean)
        q, k, v = randn(N_FRAMES, FRAME_T, 4, d), randn(N_FRAMES, FRAME_T, 4, d), randn(
            N_FRAMES, FRAME_T, 4, d)
        bthd("attention_single_pass", f"({N_FRAMES}, {FRAME_T}, 4, {d})", q, k, v, 10, 3)
    # head dims above 256: the loop's wide variant (no configuration uses
    # one; the wrappers take every multiple of 64), one slice of O at D 320,
    # two at 384 and 512, all of Q in shared memory; keys past Tk NaN leave
    # the output bit-identical. Then D 1152, whose Q streams through the ring
    for d in (320, 384, 512):
        q, k, v = randn(1, 4100, 2, d), randn(1, 4100, 2, d), randn(1, 4100, 2, d)
        bthd("flash_attention", f"(1, 4100, 2, {d})", q, k, v, 10, 3, route="d_over_256")
        tk = 2050
        clean = flash_attention(q, k[:, :tk].clone(), v[:, :tk].clone())
        nan_rows(k, tk)
        nan_rows(v, tk)
        same_bits("flash_attention", f"(1, 4100, 2, {d}) x {tk}, NaN keys past Tk",
                  flash_attention(q, k[:, :tk], v[:, :tk]), clean)
        q, k, v = randn(N_FRAMES, FRAME_T, 2, d), randn(N_FRAMES, FRAME_T, 2, d), randn(
            N_FRAMES, FRAME_T, 2, d)
        bthd("attention_single_pass", f"({N_FRAMES}, {FRAME_T}, 2, {d})", q, k, v, 10, 3,
             route="d_over_256")
    q, k, v = randn(1, 4100, 2, 1152), randn(1, 4100, 2, 1152), randn(1, 4100, 2, 1152)
    bthd("flash_attention", "(1, 4100, 2, 1152)", q, k, v, 10, 3, route="d_over_256")
    del q, k, v, clean

    # the speed-of-light probe's dots-only twin of the packed flash kernel at
    # its shape, N(0, 0.05^2) entries as the probe draws them; the plain
    # version is two cuBLAS matmuls per 1024-query block, so its time is also
    # the library's time for the same products
    t_sol = 65536
    qkv = randn(1, t_sol, 3 * C, scale=0.05)
    shape_name = f"(1, {t_sol}, {3 * C})"
    run = lambda: dots_attention(qkv, H)
    plain = lambda: dots_attention_plain(qkv, H)
    c = check("dots_attention", shape_name, run(), plain(),
              "bf16 logits and output, T-deep cuBLAS reduction", **DOTS)
    plain_ms = time_ms(plain, 1)
    record("dots_attention", shape_name, [c], time_ms(run, 3), plain_ms,
           (attention_flops(1, H, t_sol, t_sol, 64), qkv.numel() * 2 + qkv.numel() // 3 * 2),
           library_ms=plain_ms)
    del qkv

    # the cross block's MLP (1024 / 4096) over four frames' tokens x 25 and
    # one frame's x 100
    w1, b1 = randn(4 * C, C, scale=0.02), randn(4 * C, scale=0.1)
    w2, b2 = randn(C, 4 * C, scale=0.02), randn(C, scale=0.1)
    for shape_name, shape in (("(1, 64300, 1024)", (1, N_FRAMES * FRAME_T, C)),
                              ("(100, 643, 1024)", (N_FRAMES, FRAME_T, C))):
        x = randn(*shape)
        run = lambda: mlp(x, w1, b1, w2, b2)
        plain = lambda: mlp_plain(x, w1, b1, w2, b2)
        c = check("mlp", shape_name, run(), plain(), "bf16 fc1 output and fc2 bias in plain",
                  **MLP)
        record("mlp", shape_name, [c], time_ms(run, 5), time_ms(plain, 5), mlp_work(x, w1))
        results["mlp"].setdefault("products_ms", {})[shape_name] = products_ms(
            shape_name, x, w1, w2, 5)
        if shape[0] == 1:
            gemm_bits("mlp", shape_name, x, lambda a: mlp(a, w1, b1, w2, b2))
    del x, w1, w2

    # --- the fp32 entries at the main paths' shapes (--compute-dtype float32;
    # MoGe-2's encoder on every metric-depth chunk): against the fp32 plain
    # versions (TF32 off), each bound also shown to reject the bf16 entry's
    # output on the same inputs. Bound: the products over 3xTF32's 165
    # TFLOP/s; library: the same call in fp32 (SDPA, two cuBLAS products).
    def randn32(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    why32 = "3xTF32 products, fp32 sums in another order"
    produced32 = {}
    for shape_name, (b, fpr) in (("(100, 643, 3072) fp32 norm", (N_FRAMES, 1)),
                                 ("(1, 64300, 3072) fp32 norm", (1, N_FRAMES))):
        t = fpr * FRAME_T
        qkv = randn32(b, t, 3 * C)
        cos, sin = rope_for(b, fpr)
        want_kn = b == 1
        run = lambda: qkv_rope_producer(qkv, cos, sin, H, t, return_k_norms=want_kn, **norm)
        plain = lambda: qkv_rope_producer_plain(qkv, cos, sin, H, t, return_k_norms=want_kn,
                                                **norm)
        got, ref = run(), plain()
        bf = qkv_rope_producer(qkv.to(bf16), cos, sin, H, t, return_k_norms=want_kn, **norm)
        if want_kn:
            (got, kn), (ref, kn_ref), (bf, _) = got, ref, bf
            check("qkv_rope_producer_fp32 kn", shape_name, kn, kn_ref,
                  "fp32 sums in another order", max_rel=1e-5, l2_rel=1e-5)
        checks = [check_fp32(f"qkv_rope_producer_fp32 {part}", shape_name,
                             got[..., i * C:(i + 1) * C], ref[..., i * C:(i + 1) * C],
                             bf[..., i * C:(i + 1) * C], "fp32 in another order", **FP32)
                  for i, part in enumerate("qk")]
        same_bits("qkv_rope_producer_fp32 v", shape_name, got[..., 2 * C:], qkv[..., 2 * C:],
                  "the input (copied)")
        work = (2 * b * t * C * 11, 2 * qkv.numel() * 4 + 2 * cos.numel() * 4, PEAK_FP32)
        record("qkv_rope_producer_fp32", shape_name, checks, time_ms(run, 10), time_ms(plain, 3),
               work)
        produced32[shape_name] = ref
        del got, bf, qkv

    def packed_work32(qkv):
        b, t, c3 = qkv.shape
        return (attention_flops(b, c3 // 192, t, t, 64), qkv.numel() * 4 + qkv.numel() // 3 * 4,
                PEAK_3XTF32)

    for shape_name, qkv, q_scale in (
            ("(100, 643, 3072) fp32 producer", produced32["(100, 643, 3072) fp32 norm"], 1.0),
            (f"(1, {MOGE_T}, 1152) fp32 q_scale", randn32(1, MOGE_T, 3 * 384), scale)):
        h = qkv.shape[-1] // 192
        run = lambda: attention_single_pass_packed(qkv, h, q_scale=q_scale)
        plain = lambda: packed_attention_plain(qkv, h, q_scale=q_scale)
        got = run()
        c = check_fp32("attention_single_pass_packed_fp32", shape_name, got, plain(),
                       attention_single_pass_packed(qkv.to(bf16), h, q_scale=q_scale), why32,
                       **FP32)
        same_bits("attention_single_pass_packed_fp32", shape_name, run(), got, "a second call")
        record("attention_single_pass_packed_fp32", shape_name, [c], time_ms(run, 10),
               time_ms(plain, 3), packed_work32(qkv), packed_sdpa_ms(qkv, q_scale, 10))
    for q_scale in (0.0, -0.3):  # any scale, taken as it is by the fp32 kernel
        shape_name = f"(1, {MOGE_T}, 1152) q_scale={q_scale}"
        got = attention_single_pass_packed(qkv, 6, q_scale=q_scale)
        check("attention_single_pass_packed_fp32", shape_name, got,
              packed_attention_plain(qkv, 6, q_scale=q_scale), why32, **FP32)
        same_bits("attention_single_pass_packed_fp32", shape_name,
                  attention_single_pass_packed(qkv, 6, q_scale=q_scale), got, "a second call")
    unpadded = produced32["(100, 643, 3072) fp32 norm"]
    padded = torch.nn.functional.pad(unpadded, (0, 0, 0, 61))
    padded[:, FRAME_T:] = float("nan")
    same_bits("attention_single_pass_packed_fp32", "(100, 704, 3072) true_t=643, NaN rows",
              attention_single_pass_packed(padded, H, true_t=FRAME_T),
              attention_single_pass_packed(unpadded, H))
    del padded, unpadded
    qkv = produced32["(1, 64300, 3072) fp32 norm"]
    shape_name = "(1, 64300, 3072) fp32"
    run = lambda: flash_attention_packed(qkv, H)
    plain = lambda: packed_attention_plain(qkv, H)
    got = run()
    c = check_fp32("flash_attention_packed_fp32", shape_name, got, plain(),
                   flash_attention_packed(qkv.to(bf16), H), why32, **FP32)
    same_bits("flash_attention_packed_fp32", shape_name, run(), got, "a second call")
    del got
    record("flash_attention_packed_fp32", shape_name, [c], time_ms(run, 2), time_ms(plain, 1),
           packed_work32(qkv), packed_sdpa_ms(qkv, 1.0, 2))
    del qkv, produced32

    tq, tk = N_FRAMES * FRAME_T, N_FRAMES // 2 * FRAME_T
    q, k_full, v_full = randn32(1, tq, H, 64), randn32(1, tq, H, 64), randn32(1, tq, H, 64)
    k, v = k_full[:, :tk].contiguous(), v_full[:, :tk].contiguous()
    kn = k.square().sum(-1).amax(1).sqrt()
    shape_name = f"(1, {tq}, 16, 64) x (1, {tk}, 16, 64) fp32"
    run = lambda: flash_attention_partial(q, k, v, kn)
    plain = lambda: partial_attention_plain(q, k, v, kn)
    (acc, l), (acc_ref, l_ref) = run(), plain()
    acc_bf, l_bf = flash_attention_partial(q.to(bf16), k.to(bf16), v.to(bf16), kn)
    checks = [check_fp32("flash_attention_partial_fp32 acc", shape_name, acc, acc_ref, acc_bf,
                         why32, **FP32),
              check("flash_attention_partial_fp32 l", shape_name, l, l_ref, why32, **FP32),
              check_fp32("flash_attention_partial_fp32 acc/l", shape_name, acc / l[..., None],
                         acc_ref / l_ref[..., None], acc_bf / l_bf[..., None], why32, **FP32)]
    del acc_bf, l_bf, acc_ref, l_ref
    nan_rows(k_full, tk)
    nan_rows(v_full, tk)
    same_bits("flash_attention_partial_fp32", f"{shape_name}, NaN keys past Tk",
              flash_attention_partial(q, k_full[:, :tk], v_full[:, :tk], kn), (acc, l))
    same_bits("flash_attention_partial_fp32", shape_name, run(), (acc, l), "a second call")
    del k_full, v_full, acc, l
    work = (attention_flops(1, H, tq, tk, 64),
            (q.numel() + k.numel() + v.numel()) * 4 + q.numel() * 4 + tq * H * 4, PEAK_3XTF32)
    record("flash_attention_partial_fp32", shape_name, checks, time_ms(run, 2), time_ms(plain, 1),
           work)
    del q, k, v

    def bthd32(name, shape_name, q, k, v, iters, plain_iters, route=None):
        fn = flash_attention if name == "flash_attention_fp32" else attention_single_pass
        run = lambda: fn(q, k, v)
        plain = lambda: blockwise_attention(q, k, v)
        got = run()
        c = check_fp32(name, shape_name, got, plain(),
                       fn(q.to(bf16), k.to(bf16), v.to(bf16)), why32, **FP32)
        same_bits(name, shape_name, run(), got, "a second call")  # no split-K, no atomics
        del got
        b, tq, h, d = q.shape
        work = (attention_flops(b, h, tq, k.shape[1], d),
                (2 * q.numel() + k.numel() + v.numel()) * 4, PEAK_3XTF32)
        record(name, shape_name, [c], time_ms(run, iters), time_ms(plain, plain_iters), work,
               sdpa_ms(q, k, v, d**-0.5, iters), route=route)

    q, k, v = (randn32(1, N_FRAMES * FRAME_T, H, 64) for _ in range(3))
    bthd32("flash_attention_fp32", f"(1, {N_FRAMES * FRAME_T}, 16, 64) fp32", q, k, v, 2, 1,
           route="d64")
    del q, k, v
    # above head dim 64: the loop's sliced variant (O in slices of 128
    # columns, 96-key tiles)
    q, k, v = randn32(1, 8192, 3, 8, 128).unbind(2)
    bthd32("flash_attention_fp32", "(1, 8192, 8, 128) fp32 views", q, k, v, 5, 2,
           route="sliced")
    q, k, v = (randn32(1, 8192, 4, 256) for _ in range(3))
    bthd32("flash_attention_fp32", "(1, 8192, 4, 256) fp32", q, k, v, 5, 2, route="sliced")
    tk = 4100
    clean = flash_attention(q, k[:, :tk].clone(), v[:, :tk].clone())
    nan_rows(k, tk)
    nan_rows(v, tk)
    same_bits("flash_attention_fp32", f"(1, 8192, 4, 256) x {tk} fp32, NaN keys past Tk",
              flash_attention(q, k[:, :tk], v[:, :tk]), clean)
    del q, k, v, clean
    q, k, v = (randn32(N_FRAMES, FRAME_T, H, 64) for _ in range(3))
    bthd32("attention_single_pass_fp32", f"({N_FRAMES}, {FRAME_T}, 16, 64) fp32", q, k, v, 5, 2,
           route="d64")
    bufs = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 61)) for x in (q, k, v)]
    for buf in bufs:
        nan_rows(buf, FRAME_T)
    same_bits("attention_single_pass_fp32", f"({N_FRAMES}, {FRAME_T}, 16, 64) fp32, NaN rows past Tq",
              attention_single_pass(*(buf[:, :FRAME_T] for buf in bufs)),
              attention_single_pass(q, k, v))
    del bufs
    q, k, v = (randn32(N_FRAMES, FRAME_T, 4, 192) for _ in range(3))
    bthd32("attention_single_pass_fp32", f"({N_FRAMES}, {FRAME_T}, 4, 192) fp32", q, k, v, 5, 2,
           route="sliced")
    # head dims above 256: two to four slices of O; keys past Tk NaN leave
    # the output bit-identical
    for d in (320, 384, 512):
        q, k, v = (randn32(1, 4100, 2, d) for _ in range(3))
        bthd32("flash_attention_fp32", f"(1, 4100, 2, {d}) fp32", q, k, v, 5, 2,
               route="sliced")
    tk = 2050
    clean = flash_attention(q, k[:, :tk].clone(), v[:, :tk].clone())
    nan_rows(k, tk)
    nan_rows(v, tk)
    same_bits("flash_attention_fp32", f"(1, 4100, 2, 512) x {tk} fp32, NaN keys past Tk",
              flash_attention(q, k[:, :tk], v[:, :tk]), clean)
    q, k, v = (randn32(N_FRAMES, FRAME_T, 2, 320) for _ in range(3))
    bthd32("attention_single_pass_fp32", f"({N_FRAMES}, {FRAME_T}, 2, 320) fp32", q, k, v, 5, 2,
           route="sliced")
    del q, k, v, clean

    w1, b1 = randn32(4 * C, C, scale=0.02), randn32(4 * C, scale=0.1)
    w2, b2 = randn32(C, 4 * C, scale=0.02), randn32(C, scale=0.1)
    norm_ls = (1 + 0.1 * randn32(C), 0.1 * randn32(C), 1 + 0.1 * randn32(C))
    c_s = 384
    moge_w = (randn32(4 * c_s, c_s, scale=0.05), randn32(4 * c_s, scale=0.1),
              randn32(c_s, 4 * c_s, scale=0.05), randn32(c_s, scale=0.1))
    moge_norm_ls = (1 + 0.1 * randn32(c_s), 0.1 * randn32(c_s), 1 + 0.1 * randn32(c_s))
    for shape_name, shape, (nw, nb, ls), (fw1, fb1, fw2, fb2) in (
            ("(1, 64300, 1024) fp32", (1, N_FRAMES * FRAME_T, C), norm_ls, (w1, b1, w2, b2)),
            ("(100, 643, 1024) fp32", (N_FRAMES, FRAME_T, C), norm_ls, (w1, b1, w2, b2)),
            (f"(1, {MOGE_T}, {c_s}) fp32", (1, MOGE_T, c_s), moge_norm_ls, moge_w)):
        x = randn32(*shape)
        fn = lambda a, *p: block_mlp(a, nw, nb, *p, ls=ls)
        run = lambda: fn(x, fw1, fb1, fw2, fb2)
        plain = lambda: block_mlp_plain(x, nw, nb, fw1, fb1, fw2, fb2, ls=ls)
        ref = plain()
        c = check_fp32("block_mlp_fp32 branch", shape_name, run(), ref,
                       fn(x.to(bf16), *(p.to(bf16) for p in (fw1, fb1, fw2, fb2))), why32,
                       **block_mlp_bounds(x, ref))
        lib = products_ms(shape_name, x, fw1, fw2, 5)
        record("block_mlp_fp32", shape_name, [c], time_ms(run, 5), time_ms(plain, 5),
               (*mlp_work(x, fw1), PEAK_3XTF32), library_ms=lib)
        if shape[0] == 1 and shape[1] > MOGE_T:
            gemm_bits("block_mlp_fp32", shape_name, x, lambda a: fn(a, fw1, fb1, fw2, fb2))
    x = randn32(1, N_FRAMES * FRAME_T, C)
    shape_name = "(1, 64300, 1024) fp32"
    run = lambda: mlp(x, w1, b1, w2, b2)
    plain = lambda: mlp_plain(x, w1, b1, w2, b2)
    c = check_fp32("mlp_fp32", shape_name, run(), plain(),
                   mlp(x.to(bf16), *(p.to(bf16) for p in (w1, b1, w2, b2))), why32, **FP32)
    lib = products_ms(shape_name, x, w1, w2, 5)
    record("mlp_fp32", shape_name, [c], time_ms(run, 5), time_ms(plain, 5),
           (*mlp_work(x, w1), PEAK_3XTF32), library_ms=lib)
    gemm_bits("mlp_fp32", shape_name, x, lambda a: mlp(a, w1, b1, w2, b2))

    # the focal / shift solve at the chunk step's shape (100 frames) and
    # MoGe-2's (1 frame), 4096 points a frame, against the eager solve on the
    # same card (JAX parity bounds: rtol 1e-5 focal, atol 1e-5 shift); the
    # plain version's device time (its kernels, summed) and host time (the
    # enqueue of its ~5,600 launches) beside the kernel's
    for n in (N_FRAMES, 1):
        points, uv, weight = focal_shift_inputs(g, n)
        shape_name = f"({n}, 4096) fp32"
        run = lambda: solve_shift(points, uv, weight)
        plain = lambda: solve_shift_plain(points, uv, weight)
        (focal, shift), (ref_focal, ref_shift) = run(), plain()
        why = "fp32, each sum in another order"
        checks = [check("focal_shift focal", shape_name, focal, ref_focal, why, max_rel=1e-5,
                        l2_rel=1e-5),
                  check("focal_shift shift", shape_name, shift, ref_shift, why, max_rel=0.0,
                        l2_rel=1e-4, atol=1e-5)]
        same_bits("focal_shift", shape_name, run(), (focal, shift), "a second call")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain()
        host_ms = (time.perf_counter() - t0) * 1e3
        plain_ms = device_ms(plain)
        record("focal_shift", shape_name, checks, time_ms(run, 20), plain_ms,
               (*focal_shift_work(n, 4096, 30), PEAK_FP32))
        results["focal_shift"].setdefault("plain_host_ms", {})[shape_name] = host_ms
        log(f"  {'focal_shift':30s} {shape_name:28s} plain: {host_ms:9.3f} ms of host time to "
            f"enqueue, {plain_ms:9.3f} ms of device time")
    return results


def compare_outputs(what: str, got: dict, want: dict, keys, tol: float,
                    label: str = "bf16 kernels vs fp32 plain") -> None:
    """Relative L2 of card outputs against host ones, each within tol."""
    import torch

    for key in keys:
        a, b = got[key].double(), want[key].double()
        if not torch.isfinite(a).all():
            raise RuntimeError(f"{what} {key}: not finite")
        rel = ((a - b).norm() / b.norm()).item()
        ok = rel <= tol
        log(f"  {what} {key:14s} {tuple(a.shape)} rel L2 ({label}) = {rel:.3e}  "
            f"max abs {(a - b).abs().max().item():.3e}  tol {tol:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{what} {key}: relative error {rel} exceeds {tol}")


def phase_model() -> dict:
    """Full-width forwards: the kernel path on the card (bf16 and fp32 Pi3,
    fp32 MoGe-2) vs the plain path (fp32, host CPU). Returns each run's
    launch counts (set to 0 just before it)."""
    import numpy as np
    import torch

    from pi3_slam_tpu_torch.models.convert import (
        build_moge, build_pi3, init_moge_params, init_pi3_params, moge_state_from_jax,
        moge_vits_config, pi3_state_from_jax)
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    state = pi3_state_from_jax(init_pi3_params(0, Pi3Config()))
    log(f"  random full-width Pi3 weights (seed 0) in {time.perf_counter() - t0:.1f}s")
    imgs = np.random.default_rng(0).random((1, 4, 3, 308, 406), dtype=np.float32)
    keys = ("points", "local_points", "conf", "camera_poses")
    by_path = {}
    for merge, want in ((1, PI3_LAUNCHES), (2, PI3_KV_MERGE_LAUNCHES)):
        cfg = Pi3Config(global_kv_merge=merge)
        outs = {}
        for dtype, want_counts in ((torch.bfloat16, want), (torch.float32, fp32(want))):
            gpu = build_pi3(cfg, state, torch.device("cuda"), dtype)
            reset_launch_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                outs[dtype] = {k: v.cpu() for k, v in gpu(torch.from_numpy(imgs).cuda()).items()}
            seconds = time.perf_counter() - t0
            counts = nonzero(launch_counts())
            del gpu
            torch.cuda.empty_cache()
            path = f"pi3_merge{merge}_{str(dtype).replace('torch.', '')}"
            by_path[path] = counts
            log(f"  {path}: launches {counts}, forward on the card {seconds:.2f}s")
            if counts != want_counts:
                raise RuntimeError(f"{path}: launch counts {counts} != {want_counts}")
        cpu = build_pi3(cfg, state, torch.device("cpu"), torch.float32)
        t0 = time.perf_counter()
        with torch.no_grad():
            out_cpu = cpu(torch.from_numpy(imgs))
        log(f"  global_kv_merge={merge}: plain fp32 forward on the CPU in "
            f"{time.perf_counter() - t0:.1f}s")
        # a bf16 trunk of 75 blocks against an fp32 one: relative L2 error
        # 5e-2; the fp32 trunk (3xTF32 products) as the host's within 1e-3
        compare_outputs(f"pi3 merge={merge}", outs[torch.bfloat16], out_cpu, keys, 5e-2)
        compare_outputs(f"pi3 merge={merge}", outs[torch.float32], out_cpu, keys, 1e-3,
                        "fp32 kernels vs fp32 plain")
        del cpu, out_cpu, outs
    del state

    # full-width ViT-S backbone, 1200-3600 tokens; the neck and head widths
    # are a reduction (the published ones are not in the repository). The
    # trunk in fp32, as MoGeRunner (and the JAX runner) runs it.
    cfg = moge_vits_config()
    state = moge_state_from_jax(init_moge_params(0, cfg))
    image = torch.from_numpy(np.random.default_rng(1).random((1, 3, 308, 406), dtype=np.float32))
    tokens = cfg.num_tokens_range[1]
    gpu = build_moge(cfg, state, torch.device("cuda"), torch.float32)
    reset_launch_counts()
    with torch.no_grad():
        out_gpu = {k: v.cpu() for k, v in gpu(image.cuda(), tokens).items()}
    counts = nonzero(launch_counts())
    by_path["moge"] = counts
    if counts != MOGE_LAUNCHES:
        raise RuntimeError(f"MoGe launch counts {counts} != {MOGE_LAUNCHES}")
    image_gpu = image.cuda()
    with torch.no_grad():
        ms = time_ms(lambda: gpu(image_gpu, tokens), 5)
    log(f"  MoGe-2 forward on the card (fp32 trunk): {ms:.3f} ms")
    del gpu
    cpu = build_moge(cfg, state, torch.device("cpu"))
    t0 = time.perf_counter()
    with torch.no_grad():
        out_cpu = cpu(image, tokens)
    log(f"  MoGe-2 ViT-S at {tokens} tokens: launches {counts}; plain fp32 forward on the CPU in "
        f"{time.perf_counter() - t0:.1f}s")
    # the fp32 encoder of 12 blocks (the neck and heads fp32 on both sides);
    # the bf16 encoder it replaced read 8.5e-3 (points) and 1.55e-2
    # (metric_scale) here
    compare_outputs("moge", out_gpu, out_cpu, ("points", "mask", "metric_scale"), 1e-3,
                    "fp32 kernels vs fp32 plain")
    return by_path


def phase_blocks() -> dict:
    """The cross-attention block at Pi3's decoder widths (C 1024, 16 heads of
    64, MLP 4096, qk-norm, LayerScale 0.01, RoPE2D base 100 at 22 x 29 + 5
    positions; the random tree of seed 0) over one frame's tokens (x, y
    (4, 643, 1024)) and four frames' (x, y (1, 2572, 1024)), and two Blocks
    off the packed kernels' widths (C 1024 with 8 heads of 128; C 320 with 5
    heads of 64), each on (4, 643, C) with qk-norm, RoPE and LayerScale
    (torch's init under seed 0): the kernel path (bf16, card) against the
    plain path (fp32, host); then the cross block and the 8-heads-of-128
    Block in fp32 (the fp32 entries; the Block's attention is the sliced
    fp32 loop, reached through sdpa). Returns each run's launch counts (set
    to 0 just before it)."""
    import copy

    import numpy as np
    import torch

    from pi3_slam_tpu_torch.models.convert import (
        build_cross_block, cross_block_state_from_jax, init_cross_block_params)
    from pi3_slam_tpu_torch.models.layers import Block
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.ops.rope import make_patch_positions, rope_tables

    rng = np.random.default_rng(0)
    cpu = torch.device("cpu")
    pos = make_patch_positions(4, 22, 29, num_special=5, offset=1)  # (4, 643, 2)
    state = cross_block_state_from_jax(init_cross_block_params(0, 1024, 16, 4, True, 0.01))

    def randn(*shape, scale=1.0):
        # rounded to bf16 once, so that both sides start from the same values
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) * scale).bfloat16()

    def drive(path, make, x, why, dtype=torch.bfloat16, tol=5e-2):
        """make(device, dtype) -> run, run(x) the block's forward there. The
        card's branch out - x (in dtype) is held to the host's within tol
        relative L2, and the card run's launch counts to
        BLOCK_LAUNCHES[path]."""
        run = make(torch.device("cuda"), dtype)
        reset_launch_counts()
        with torch.no_grad():
            got = run(x.cuda()).cpu()
        counts = launch_counts()
        del run
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with torch.no_grad():
            want = make(cpu, torch.float32)(x.float())
        host_s = time.perf_counter() - t0
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{path}: not finite")
        branch, branch_want = got.double() - x.double(), want.double() - x.double()
        rel = ((branch - branch_want).norm() / branch_want.norm()).item()
        ok = rel <= tol
        ran = nonzero(counts)
        dt = str(dtype).replace("torch.", "")
        log(f"  {path}: {tuple(got.shape)} branch out - x rel L2 ({dt} kernels vs fp32 plain on "
            f"the host, {host_s:.1f}s) = {rel:.3e}  tol {tol:.0e} ({why}) {'ok' if ok else 'FAIL'}; "
            f"launches {ran}")
        if not ok:
            raise RuntimeError(f"{path}: relative error {rel} exceeds {tol}")
        if ran != BLOCK_LAUNCHES[path]:
            raise RuntimeError(f"{path}: launch counts {ran} != {BLOCK_LAUNCHES[path]}")
        return counts

    def cross(y, p):
        def make(device, dtype):
            blk = build_cross_block(state, 16, device, dtype)
            yd, pd = y.to(device, dtype), p.to(device)
            return lambda x: blk(x, yd, pd, pd)
        return make

    def block(c, heads):
        torch.manual_seed(0)
        blk = Block(c, heads, 4, qk_norm=True, layerscale=True).eval()
        cos, sin = rope_tables(pos, c // heads)

        def make(device, dtype):
            m = copy.deepcopy(blk).to(device=device, dtype=dtype)
            rope = (cos.to(device), sin.to(device))
            return lambda x: m(x, rope=rope)
        return make

    # x and y at |x| ~ 1/64: the bf16 rounding of the three residual adds
    # (2^-9 of |x|) then stays below the LayerScale-0.01 branches (rms 5e-3)
    why = "bf16 weights and activations; the plain versions in bf16 on a CPU gave 1.1e-2"
    by_path = {}
    n = 4 * FRAME_T
    by_path["cross_block_frame"] = drive(
        "cross_block_frame", cross(randn(4, FRAME_T, 1024, scale=1 / 64), pos),
        randn(4, FRAME_T, 1024, scale=1 / 64), why)
    by_path["cross_block_global"] = drive(
        "cross_block_global", cross(randn(1, n, 1024, scale=1 / 64), pos.reshape(1, n, 2)),
        randn(1, n, 1024, scale=1 / 64), why)
    why = "bf16 weights and activations; the plain versions in bf16 on a CPU gave 1.3e-2"
    for path, c, heads in (("block_d128", 1024, 8), ("block_c320", 320, 5)):
        by_path[path] = drive(path, block(c, heads), randn(4, FRAME_T, c), why)
    # the cross block and the head-dim-128 Block in fp32: the fp32 entries of
    # the packed, (B, T, H, D) and MLP kernels, the card within 1e-3 of the
    # host
    why = "fp32 kernels, 3xTF32 products"
    by_path["block_d128_fp32"] = drive("block_d128_fp32", block(1024, 8),
                                       randn(4, FRAME_T, 1024).float(), why, torch.float32, 1e-3)
    for path, y, x, p in (("cross_block_frame_fp32", randn(4, FRAME_T, 1024, scale=1 / 64),
                           randn(4, FRAME_T, 1024, scale=1 / 64), pos),
                          ("cross_block_global_fp32", randn(1, n, 1024, scale=1 / 64),
                           randn(1, n, 1024, scale=1 / 64), pos.reshape(1, n, 2))):
        by_path[path] = drive(path, cross(y, p), x.float(), why, torch.float32, 1e-3)
    return by_path


def write_frames(folder: str, n: int = 130, size: tuple = (480, 640), names=None) -> None:
    """Seeded synthetic frames (640x480 unless ``size`` says otherwise): a
    drifting smooth pattern plus noise, named frame_XXXX.png or ``names``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0 : size[0], 0 : size[1]].astype(np.float32)
    for i in range(n):
        base = np.stack([np.sin((xx + 3 * i) / 37.0), np.cos((yy - 2 * i) / 29.0),
                         np.sin((xx + yy + i) / 53.0)], axis=-1)
        img = (base * 90 + 128 + rng.normal(0, 8, base.shape)).clip(0, 255).astype(np.uint8)
        name = names[i] if names is not None else f"frame_{i:04d}.png"
        Image.fromarray(img).save(os.path.join(folder, name), compress_level=1)


# phase 4's metric-depth chunk seconds (grid keypoints), which phase 9 (b)
# sets beside --keypoints aliked --refine-observations on the same frames
METRIC_DEPTH_CHUNK_S: list = []


def run_cli(name: str, frames: str, out: str, extra: list) -> tuple[dict, list]:
    """One CLI run of python -m pi3_slam_tpu_torch.create_offline_chunks over
    the 130 frames; checks its chunk files and its launch counts per chunk.
    Returns (launch counts of the run, per-chunk records)."""
    import numpy as np

    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.utils.keypoints import grid_keypoints

    per_chunk_want = PATH_LAUNCHES[name]
    argv = ["--images", frames, "--output", out, "--chunk-length", "100", "--overlap", "20",
            "--max-kp", "400"] + extra
    log("  python -m pi3_slam_tpu_torch.create_offline_chunks " + " ".join(argv))
    reset_launch_counts()
    t0 = time.perf_counter()
    records = create_chunks(argv)
    wall = time.perf_counter() - t0
    counts = nonzero(launch_counts())
    with open(os.path.join(out, "chunks_manifest.json")) as f:
        manifest = json.load(f)
    if [m["num_frames"] for m in manifest] != [100, 50]:
        raise RuntimeError(f"unexpected chunks {manifest}")
    k = len(grid_keypoints(308, 406, 400))
    keys = {"points", "local_points", "conf", "masks", "keypoints", "colors", "camera_poses",
            "camera_poses_cw", "image_paths", "original_height", "original_width",
            "intrinsics", "chunk_index", "start_idx", "end_idx"}
    for entry, record in zip(manifest, records):
        with np.load(os.path.join(out, "chunks", entry["file"])) as z:
            scaled = record["metric_scale"] is not None
            want = keys | {"metric_scale"} if scaled else keys
            if set(z.files) != want:
                raise RuntimeError(f"{entry['file']} keys {sorted(z.files)} != {sorted(want)}")
            n = entry["num_frames"]
            if z["points"].shape != (n, k, 3) or z["camera_poses"].shape != (n, 4, 4):
                raise RuntimeError(f"{entry['file']}: shapes {z['points'].shape}")
            for key in ("points", "local_points", "conf", "camera_poses", "camera_poses_cw",
                        "intrinsics") + (("metric_scale",) if scaled else ()):
                if not np.isfinite(z[key].astype(np.float64)).all():
                    raise RuntimeError(f"{entry['file']}: {key} not finite")
            if scaled and float(z["metric_scale"]) != np.float32(record["metric_scale"]):
                raise RuntimeError(f"{entry['file']}: metric_scale differs from its record")
            if (int(z["original_height"]), int(z["original_width"])) != (308, 406):
                raise RuntimeError("unexpected target size")
    fps = [r["fps"] for r in records]
    seconds = [r["infer_s"] for r in records]
    per_chunk = [nonzero(r["launches"]) for r in records]
    want = {kernel: per * len(manifest) for kernel, per in per_chunk_want.items()}
    log(f"  {name}: chunks {[m['file'] for m in manifest]}, seconds per chunk {seconds}, "
        f"frames/s per chunk {fps}, CLI wall {wall:.1f}s")
    log(f"  {name}: launch counts {counts} (expected {want}); per chunk {per_chunk}")
    if counts != want or per_chunk != [per_chunk_want] * len(manifest):
        raise RuntimeError(f"{name}: launch counts {counts}, per chunk {per_chunk}: expected "
                           f"{per_chunk_want} per chunk")
    return counts, records


def phase_cli(tmp: str) -> dict:
    """Both main paths through the CLI, writing under tmp; returns each
    path's launch counts."""
    from pi3_slam_tpu_torch.models.convert import init_moge_params, moge_vits_config, save_params_npz

    frames = os.path.join(tmp, "frames")
    os.makedirs(frames)
    write_frames(frames)
    moge = os.path.join(tmp, "moge_random.npz")
    save_params_npz(moge, init_moge_params(0, moge_vits_config()))
    counts, records = run_cli("metric_depth", frames, os.path.join(tmp, "metric"),
                              ["--moge-path", moge])
    scales = [r["metric_scale"] for r in records]
    if all(sc is not None for sc in scales):
        log(f"  metric_depth: every chunk holds metric_scale: {scales}")
    else:  # the creator printed "metric scale skipped: too few valid ..." for these
        log(f"  metric_depth: metric_scale per chunk {scales}; None = the JAX message "
            "'metric scale skipped: too few valid MoGe/Pi3 depth pairs' (random weights)")
    by_path = {"metric_depth": counts}
    METRIC_DEPTH_CHUNK_S[:] = [r["infer_s"] for r in records]
    by_path["kv_merge"], _ = run_cli("kv_merge", frames, os.path.join(tmp, "kv_merge"),
                                     ["--global-kv-merge", "2", "--no-metric-depth"])
    # the fp32 model (the JAX creator computes it on its device): every block
    # through the kernels' fp32 entries, MoGe-2 as in the default run
    by_path["float32"], _ = run_cli("float32", frames, os.path.join(tmp, "float32"),
                                    ["--compute-dtype", "float32", "--moge-path", moge])
    return by_path


def phase_sol() -> dict:
    """The speed-of-light probe through its entry point; returns the run's
    launch counts (set to 0 just before it)."""
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.tools.perf_lab import ITERS, SOL_H, SOL_T, probe

    # one warm-up and ITERS timed calls of each kernel
    want = {k: ITERS + 1 for k in ("dots_attention", "flash_attention_packed", "flash_attention",
                                   "block_mlp")}
    reset_launch_counts()
    results = probe(["sol"])
    counts = launch_counts()
    ran = nonzero(counts)
    log(f"  sol: launches {ran}")
    if ran != want:
        raise RuntimeError(f"sol: launch counts {ran} != {want}")
    for name, r in results.items():
        if not (math.isfinite(r["ms"]) and r["ms"] > 0):
            raise RuntimeError(f"sol: {name} took {r['ms']} ms")
    peak = next(r["tflops"] for n, r in results.items() if n.startswith("square"))
    for name, r in results.items():
        if not name.startswith("square"):
            log(f"  sol: {name.split(' (')[0]} {r['tflops']:.1f} TFLOP/s, {r['tflops'] / peak:.1%} "
                f"of the {peak:.1f} of the 8192^3 matmul")
    # the library yardstick and both bounds of the packed flash kernel at the
    # probe's shape (after the counts were read: not part of the probe run)
    import torch

    t, h = SOL_T, SOL_H
    q, k, v = ((torch.randn(1, t, h, 64, device="cuda") * 0.05).to(torch.bfloat16) for _ in range(3))
    lib = sdpa_ms(q, k, v, 1.0, ITERS)
    del q, k, v
    flops = attention_flops(1, h, t, t, 64)
    log(f"  sol: scaled_dot_product_attention at (1, {t}, {h}, 64) {lib:.3f} ms (library "
        f"yardstick); bounds of that shape: products {flops / PEAK_BF16 * 1e3:.3f} ms, exp2 "
        f"{exp2_ms(h * t * t):.3f} ms")
    return counts


def check_artifacts(result: dict, n_poses: int) -> np.ndarray:
    """The reconstructor's three files exist and are finite; the TUM file has
    n_poses poses. Returns its positions."""
    from pi3_slam_tpu_torch.io.ply import read_ply
    from pi3_slam_tpu_torch.io.tum import read_tum_trajectory

    traj = read_tum_trajectory(result["artifacts"]["trajectory"])
    if traj["positions"].shape != (n_poses, 3):
        raise RuntimeError(f"trajectory has {traj['positions'].shape[0]} poses, not {n_poses}")
    for key in ("positions", "quaternions_xyzw"):
        if not np.isfinite(traj[key]).all():
            raise RuntimeError(f"trajectory {key} not finite")
    for name in ("points", "cameras"):
        xyz = read_ply(result["artifacts"][name])["xyz"]
        if not np.isfinite(xyz).all():
            raise RuntimeError(f"{name} PLY not finite")
    log(f"  artifacts: {n_poses} poses, {read_ply(result['artifacts']['points'])['xyz'].shape[0]} "
        "points, cameras PLY, all finite")
    return traj["positions"]


def log_alignments(result: dict) -> None:
    for a, t in zip(result["alignment"], result["timings"][1:]):
        log(f"    chunk {t['chunk']}: {a.method} route, {a.num_common_tracks} common / "
            f"{a.num_used_tracks} used tracks, scale {float(a.sim3.scale):.4f}, "
            f"{'ok' if a.success else 'FAILED'}")


def phase_reconstruct(tmp: str) -> None:
    """(a) phase 4's metric-depth chunks through the port's reconstructor CLI;
    (b) the eval-scale synthetic system on the card, and its first two chunks
    again on the host CPU."""
    import shutil

    from pi3_slam_tpu_torch.reconstruct_offline import reconstruct
    from pi3_slam_tpu_torch.utils.evaluation import ape_translation

    argv = ["--chunks", os.path.join(tmp, "metric"), "--output", os.path.join(tmp, "recon")]
    log("  (a) python -m pi3_slam_tpu_torch.reconstruct_offline " + " ".join(argv))
    result = reconstruct(argv)
    check_artifacts(result, 130)
    log_alignments(result)

    log("  (b) eval-scale synthetic chunks: 420 frames (5 x 100 + a 20-frame tail), 400 "
        "keypoints, overlap 20")
    scene = os.path.join(tmp, "eval")
    t0 = time.perf_counter()
    gt = write_synthetic_chunks(scene, np.random.default_rng(0), **EVAL_SCALE)
    log(f"    written in {time.perf_counter() - t0:.1f}s")
    argv = ["--chunks", scene, "--output", os.path.join(scene, "card"),
            "--max-observations-per-track", "10", "--ba-iterations", "10"]
    log("    python -m pi3_slam_tpu_torch.reconstruct_offline " + " ".join(argv))
    t0 = time.perf_counter()
    card = reconstruct(argv)
    wall = time.perf_counter() - t0
    pos = check_artifacts(card, len(gt))
    log_alignments(card)
    for t in card["timings"]:
        log(f"    chunk {t['chunk']}: reconstruction {t['recon_s']:.3f}s, of it BA {t['ba_s']:.3f}s "
            f"({t['ba_iterations']} iterations)"
            + (f", align {t['align_s']:.3f}s (refine {t.get('refine_iterations')} iterations)"
               if "align_s" in t else ""))
    ape = ape_translation(gt, pos)
    log(f"    card: APE RMSE {ape.rmse:.4f} m (gate 0.07), reconstructor wall {wall:.1f}s")
    if ape.rmse >= 0.07:
        raise RuntimeError(f"eval-scale APE RMSE {ape.rmse} m >= 0.07 m")
    if [t["frames"] for t in card["timings"]] != [100] * 5 + [20]:
        raise RuntimeError(f"eval-scale chunks {[t['frames'] for t in card['timings']]}")
    if len(card["alignment"]) != 5 or not all(
            a.success and a.num_common_tracks > 2000 for a in card["alignment"]):
        raise RuntimeError("eval-scale alignments: expected 5 with > 2000 common tracks each")
    if [t["ba_iterations"] for t in card["timings"]] != [10] * 6:
        raise RuntimeError(f"eval-scale BA iterations {[t['ba_iterations'] for t in card['timings']]}")

    ba_against_host(os.path.join(scene, "chunks", "chunk_000000.npz"))

    # the first two chunks end to end on the card (twice), on the host CPU,
    # and on the card without BA
    two = os.path.join(tmp, "eval2")
    os.makedirs(os.path.join(two, "chunks"))
    for i in (0, 1):
        shutil.copy(os.path.join(scene, "chunks", f"chunk_{i:06d}.npz"), os.path.join(two, "chunks"))
    runs = {}
    for name, device, extra in (("card", "cuda", []), ("host", "cpu", []), ("card again", "cuda", []),
                                ("card without BA", "cuda", ["--ba-iterations", "0"])):
        argv = ["--chunks", two, "--output", os.path.join(two, name.replace(" ", "_")),
                "--max-observations-per-track", "10", "--device", device] + extra
        t0 = time.perf_counter()
        res = reconstruct(argv)
        runs[name] = (check_artifacts(res, 180), time.perf_counter() - t0, res["timings"])
    for name in ("card", "host"):
        _, wall, timings = runs[name]
        log(f"    two chunks on the {name}: wall {wall:.2f}s, reconstruction " + ", ".join(
            f"{t['recon_s']:.3f}s" for t in timings) + ", of it BA " + ", ".join(
            f"{t['ba_s']:.3f}s" for t in timings) + f", align {timings[1]['align_s']:.3f}s")
    # A chunk BA fixes no camera: from its fifth step the damping (below
    # 1e-6 of the diagonal) no longer holds the gauge, each step's component
    # along it comes from rounding, and the card's summation order (another
    # than the host's) moves the end-to-end poses by millimetres, about as
    # far as a run without BA lies; this bound only catches a solve gone
    # wrong by centimetres. ba_against_host holds the card to the host where
    # the solution is fixed. The card's own sums take a fixed order, so a
    # second run on the card gives the same poses to the bit.
    worst, rms = pose_distance(runs["card"][0], runs["host"][0])
    same = np.array_equal(runs["card again"][0], runs["card"][0])
    no_ba = pose_distance(runs["card without BA"][0], runs["host"][0])[0]
    log(f"    two chunks, card vs host after a similarity: largest {worst:.3e} m (tol 2e-2), "
        f"RMS {rms:.3e} m {'ok' if worst <= 2e-2 else 'FAIL'}; card vs card again: "
        f"{'the same poses, bit for bit, ok' if same else 'poses differ, FAIL'}; card without BA "
        f"vs host {no_ba:.3e} m")
    if worst > 2e-2:
        raise RuntimeError(f"a card pose lies {worst} m from the host's after a similarity")
    if not same:
        raise RuntimeError("two runs of the reconstruction on the card gave different poses")


def check_online_outputs(out: str, n_poses: int) -> None:
    """Both TUM files of an online run with --save-tum
    --tum-integer-timestamps: n_poses finite poses stamped 0 .. n_poses - 1;
    and its point cloud."""
    from pi3_slam_tpu_torch.io.tum import read_tum_trajectory

    for name in ("trajectory_tum.txt", "trajectory.tum"):
        traj = read_tum_trajectory(os.path.join(out, name))
        if traj["positions"].shape != (n_poses, 3) or not np.isfinite(traj["positions"]).all():
            raise RuntimeError(f"{name}: {traj['positions'].shape} poses, or not finite")
        if not np.array_equal(traj["timestamps"], np.arange(n_poses)):
            raise RuntimeError(f"{name}: stamps are not the integers 0 .. {n_poses - 1}")
    if not os.path.exists(os.path.join(out, "final_points.ply")):
        raise RuntimeError("final_points.ply missing")


def stage_line(status: dict) -> str:
    return ", ".join(f"{k} {v['total_s']:.3f}s / {v['count']}" for k, v in status["timing"].items())


def fresh_run(slam, **changes):
    """A copy of an online driver with an empty chain and its config
    changed; the model, MoGe-2 and the chunk step are shared (no second
    full-width build)."""
    import copy
    import dataclasses

    import torch

    from pi3_slam_tpu_torch.utils.timing import TimingStats

    run = copy.copy(slam)
    run.config = dataclasses.replace(slam.config, **changes)
    run.sfm_device = torch.device("cpu") if run.config.sfm_backend == "cpu" else slam.device
    run.reconstructions, run.alignment_results, run.chunk_launches = [], [], []
    run.timing = TimingStats()
    run._produced = run._consumed = 0
    return run


def ba_beside_loads(slam, chunk_path: str) -> None:
    """What holds the online consumer's BA back. Chunk 0's BA at eval scale
    (100 frames, 40,000 tracks; phase 6's chunk) on a high-priority stream of
    another thread, as the consumer runs it, alone and beside four loads on
    this thread: the chunk step (a 100-frame forward and MoGe-2, ~13,500
    launches), bf16 matmuls that fill the SMs with few launches, a pure-Python
    loop that holds the GIL and launches nothing, and 40,000 tiny kernels
    (launches without SM load); beside the chunk step also on a stream of
    the default priority. Then the BA's parts alone and beside the matmuls:
    the BA without its per-iteration host read (ftol 0), 600 small kernels
    and one sync, ten 600 x 600 LU solves, ten batched 3 x 3 inverses of
    40,000 and ten one-element host reads, each followed by a sync. Prints
    each one's seconds, and each load's alone and beside it."""
    import threading

    import torch

    from pi3_slam_tpu_torch.sfm.ba import bundle_adjust, run_bundle_adjust
    from pi3_slam_tpu_torch.sfm.reconstruction import build_chunk_reconstruction
    from pi3_slam_tpu_torch.slam.offline_reconstructor import load_chunk_npz

    recon = build_chunk_reconstruction(load_chunk_npz(chunk_path), run_ba=False, device="cpu")
    kpf = recon.num_tracks // recon.num_frames
    streams = {"high": torch.cuda.Stream(priority=-1), "default": torch.cuda.Stream()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    imgs = torch.randint(0, 256, (100, 3, 308, 406), dtype=torch.uint8, device="cuda",
                         generator=gen)
    kps = torch.rand(100, 400, 2, device="cuda", generator=gen) * 300
    a = torch.randn(16384, 16384, device="cuda", dtype=torch.bfloat16, generator=gen)
    tiny = torch.zeros(16, device="cuda")

    def forward():
        slam.step(imgs, kps)
        slam.moge.infer_depth_async(imgs[0])

    def matmuls():
        for _ in range(80):
            a @ a

    def python():
        t_end = time.perf_counter() + 1.0
        while time.perf_counter() < t_end:
            sum(range(1000))

    def launches():
        for _ in range(40000):
            tiny.add_(1.0)

    def ba():
        run_bundle_adjust(recon.to_problem(device="cuda"), 10, 2.0, tracks_per_frame=kpf)

    def ba_no_reads():
        bundle_adjust(recon.to_problem(device="cuda"), iterations=10, tracks_per_frame=kpf,
                      ftol=0.0)
        torch.cuda.current_stream().synchronize()

    x = torch.ones(40000, 10, device="cuda")
    s_dense = torch.eye(600, device="cuda") * 2 + 0.001
    b = torch.ones(600, 1, device="cuda")
    h = torch.eye(3, device="cuda").expand(40000, 3, 3) * 2

    def kernels():
        for _ in range(600):
            x.mul_(1.0)
        torch.cuda.current_stream().synchronize()

    def solves():
        for _ in range(10):
            torch.linalg.solve_ex(s_dense, b)
            torch.cuda.current_stream().synchronize()

    def inverses():
        for _ in range(10):
            torch.linalg.inv_ex(h)
            torch.cuda.current_stream().synchronize()

    def reads():
        for _ in range(10):
            bool(x[0, 0] > 0)

    def on_stream(work, priority="high") -> float:
        with torch.cuda.stream(streams[priority]):
            t0 = time.perf_counter()
            work()
            return time.perf_counter() - t0

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def beside(load, work, priority="high") -> tuple:
        load_alone = timed(load)
        out = {}
        thread = threading.Thread(target=lambda: out.update(s=on_stream(work, priority)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        thread.start()
        load()
        torch.cuda.synchronize()
        load_beside = time.perf_counter() - t0
        thread.join()
        return out["s"], load_alone, load_beside

    on_stream(ba)  # warms the stream's allocator and the solver handles
    log(f"    (d) chunk 0's BA ({recon.num_frames} frames, {recon.num_tracks} tracks) on a "
        f"high-priority stream of another thread: alone {on_stream(ba):.3f}s")
    for name, load, priority in (
            ("the chunk step", forward, "high"), ("the chunk step", forward, "default"),
            ("80 bf16 16384^3 matmuls", matmuls, "high"), ("a pure-Python loop", python, "high"),
            ("40,000 tiny kernels", launches, "high")):
        got, load_alone, load_beside = beside(load, ba, priority)
        log(f"        BA beside {name}, {priority} priority: {got:.3f}s; the load "
            f"{load_alone:.3f}s alone, {load_beside:.3f}s with the BA beside it")
    for name, work in (("BA without host reads (ftol 0)", ba_no_reads),
                       ("600 small kernels, one sync", kernels),
                       ("10 LU solves 600 x 600, each synced", solves),
                       ("10 batched 3 x 3 inverses of 40,000, each synced", inverses),
                       ("10 one-element host reads", reads)):
        on_stream(work)
        alone = on_stream(work)
        got, load_alone, load_beside = beside(matmuls, work)
        log(f"        {name}: alone {alone:.4f}s, beside the matmuls {got:.3f}s (matmuls "
            f"{load_alone:.3f}s alone, {load_beside:.3f}s)")


def phase_online(tmp: str) -> tuple[dict, float]:
    """(a) the online CLI in process over phase 4's 130 frames at the
    evaluation settings; (b) the drive modes over 340 frames, sync then
    async; (c) async with sfm_backend 'cpu'. Returns (a)'s launch counts and
    its wall seconds."""
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.pi3_slam_online import run_online
    from pi3_slam_tpu_torch.slam.config import OnlineConfig
    from pi3_slam_tpu_torch.slam.online import Pi3SLAMOnline

    moge = os.path.join(tmp, "moge_random.npz")
    out = os.path.join(tmp, "online")
    argv = ["--images", os.path.join(tmp, "frames"), "--output", out, "--chunk-length", "100",
            "--overlap", "20", "--max-kp", "400", "--tum-integer-timestamps", "--moge-path", moge,
            "--save-tum"]
    log("  (a) python -m pi3_slam_tpu_torch.pi3_slam_online " + " ".join(argv))
    reset_launch_counts()
    t0 = time.perf_counter()
    result = run_online(argv)
    cli_wall = wall = time.perf_counter() - t0
    counts = nonzero(launch_counts())
    per_chunk = [nonzero(c) for c in result["chunk_launches"]]
    want = PATH_LAUNCHES["metric_depth"]
    status = result["queue_status"]
    log(f"    {result['num_chunks']} chunks, {result['num_frames']} frames, {result['fps']:.2f} "
        f"frames/s, CLI wall {wall:.1f}s; stages: {stage_line(status)}")
    log(f"    launch counts {counts}; per chunk {per_chunk} (expected {want})")
    if (result["num_chunks"], result["num_frames"]) != (2, 150):  # 100 + the 50-frame tail
        raise RuntimeError(f"online: {result['num_chunks']} chunks, {result['num_frames']} frames")
    if per_chunk != [want] * 2 or counts != {k: 2 * v for k, v in want.items()}:
        raise RuntimeError(f"online: launch counts {counts}, per chunk {per_chunk}")
    if (status["chunks_consumed"], status["chunks_inflight"], status["alignments"]) != (2, 0, 1):
        raise RuntimeError(f"online: queue status {status}")
    check_online_outputs(out, 130)

    log("  (b) 260 frames (3 chunks of 100 and a 20-frame tail padded to 100), sync then async")
    frames = os.path.join(tmp, "frames260")
    os.makedirs(frames)
    write_frames(frames, 260)
    paths = sorted(os.path.join(frames, f) for f in os.listdir(frames))
    slam = Pi3SLAMOnline(OnlineConfig(chunk_length=100, overlap=20, max_keypoints=400,
                                      moge_checkpoint_path=moge, output_dir=out))
    runs = {}
    for name, pipelined, backend, iterations in (
            ("sync", False, "auto", 10), ("async", True, "auto", 10),
            ("async, SfM on the host", True, "cpu", 10), ("sync without BA", False, "auto", 0)):
        run = fresh_run(slam, sfm_backend=backend, ba_iterations=iterations)
        t0 = time.perf_counter()
        r = run.process_image_paths(paths, pipelined=pipelined)
        wall = time.perf_counter() - t0
        st = run.queue_status()
        stage = {k: v["total_s"] for k, v in st["timing"].items()}
        runs[name] = (wall, stage, run._merged_trajectory()[0])
        log(f"    {name}: Online: {r['num_frames']} frames in {wall:.2f}s -> "
            f"{r['num_frames'] / wall:.2f} FPS, {wall / r['num_chunks']:.3f}s a chunk; stages "
            f"{stage_line(st)}; queue: {st['chunks_consumed']} consumed, {st['chunks_inflight']} "
            f"in flight, {st['alignments']} alignments ({st['alignment_failures']} failed)")
        per = [nonzero(c) for c in run.chunk_launches]
        if r["num_chunks"] != 4 or per != [want] * 4 or st["chunks_inflight"]:
            raise RuntimeError(f"{name}: {r['num_chunks']} chunks, launches per chunk {per}")
    sync_wall, sync, sync_traj = runs["sync"]
    forward = sync["dispatch"] + sync["materialize"]
    sfm = sync["metric_scale"] + sync["reconstruction"] + sync["alignment"]
    for name in ("async", "async, SfM on the host"):
        wall, stage, traj = runs[name]
        log(f"    {name} vs sync: wall {wall:.2f}s vs {sync_wall:.2f}s; sync forward + pull "
            f"{forward:.2f}s, SfM {sfm:.2f}s (sum {forward + sfm:.2f}s, max {max(forward, sfm):.2f}s); "
            f"build (pull + BA) {stage['reconstruction']:.2f}s beside the forward vs "
            f"{sync['reconstruction']:.2f}s alone")
    # the async consumer does the sync run's work in the same order
    diff = float(np.abs(runs["async"][2] - sync_traj).max())
    log(f"    async vs sync merged trajectories: at most {diff:.3e} m apart (tol 1e-5) "
        f"{'ok' if diff <= 1e-5 else 'FAIL'}")
    if diff > 1e-5:
        raise RuntimeError(f"async trajectory {diff} m from the sync one")
    # Not held: random weights put chunk 0's cameras within millimetres of
    # each other, and its BA then moves them by decimetres along directions
    # that fp32 rounding decides, so the host's SfM (another summation order)
    # lands as far from the card's as a run without BA does. (e) holds the
    # same chain card against host on a scene that fixes the answer.
    def extent(centers):  # the largest distance from their mean
        return float(np.linalg.norm(centers - centers.mean(0), axis=1).max())

    host, no_ba = (pose_distance(runs[name][2], sync_traj)
                   for name in ("async, SfM on the host", "sync without BA"))
    log(f"    SfM on the host vs the card (sync), after a similarity: largest {host[0]:.3e} m, "
        f"RMS {host[1]:.3e} (raw {float(np.abs(runs['async, SfM on the host'][2] - sync_traj).max()):.3e}); "
        f"the card without BA: largest {no_ba[0]:.3e} m, RMS {no_ba[1]:.3e}; the trajectory's "
        f"extent {extent(sync_traj):.3e} m, chunk 0's cameras {extent(runs['sync without BA'][2][:100]):.3e} m "
        f"before BA and {extent(sync_traj[:100]):.3e} m after; not held on random weights, see (e)")
    ba_beside_loads(slam, os.path.join(tmp, "eval", "chunks", "chunk_000000.npz"))
    online_sfm_against_host(slam, tmp)
    return counts, cli_wall


# (e)'s bound on the largest per-pose distance between the card's and the
# host's merged trajectories after one similarity. On an NVIDIA H100 80GB HBM3
# at 700 W the card read 1.063e-3 m and the card without BA 8.767e-3 m; the
# bound sits near their geometric mean, about three times from each.
ONLINE_TOL = 3e-3


def online_sfm_against_host(slam, tmp: str) -> None:
    """(e) The online SfM chain (chunk reconstruction and BA, Sim3 alignment
    and prior BA, sync) on phase 6's eval-scale synthetic chunks, served in
    place of the chunk step as tests/test_torch_online.py serves them: on the
    card, on the host CPU and on the card without BA. The card's merged
    trajectory lies within ONLINE_TOL of the host's after one similarity; the
    run without BA must lie outside it."""
    import glob
    import shutil

    from PIL import Image

    scene = os.path.join(tmp, "eval")
    chunks = {}
    for path in sorted(glob.glob(os.path.join(scene, "chunks", "chunk_*.npz"))):
        with np.load(path) as z:
            chunks[str(z["image_paths"][0])] = {k: z[k] for k in z.files}
    frames = os.path.join(tmp, "eval_frames")
    os.makedirs(frames)
    width, height = 644, 476  # multiples of 14: the loader's resize is the identity
    paths = [os.path.join(frames, f"frame_{i:04d}.png") for i in range(420)]
    Image.fromarray(np.full((height, width, 3), 127, np.uint8)).save(paths[0])
    for path in paths[1:]:
        shutil.copyfile(paths[0], path)
    truth = make_synthetic_sequence(np.random.default_rng(0), 420, 5000, 640, 480, 0.08, 0.0007)[1]

    def serve(run):
        def dispatch(batch):
            d = chunks[os.path.basename(batch["paths"][0])]
            run._produced += 1
            return {"dev": {"camera_poses": d["camera_poses"], "points_kp": d["points"],
                            "colors_kp": d["colors"], "intrinsics": d["intrinsics"]},
                    "moge_depth": None, "ready": None, "kps": d["keypoints"].astype(np.float32),
                    "batch": batch}

        run._dispatch_device = dispatch

    from pi3_slam_tpu_torch.utils.evaluation import ape_translation

    trajs = {}
    for name, backend, iterations in (("card", "auto", 10), ("host", "cpu", 10),
                                      ("card without BA", "auto", 0)):
        run = fresh_run(slam, sfm_backend=backend, ba_iterations=iterations,
                        pixel_limit=width * height)
        serve(run)
        t0 = time.perf_counter()
        r = run.process_image_paths(paths, pipelined=False)
        trajs[name] = run._merged_trajectory()[0]
        log(f"    (e) {name}: {r['num_chunks']} chunks in {time.perf_counter() - t0:.2f}s, "
            f"{len(run.alignment_results)} alignments "
            f"({sum(not a.success for a in run.alignment_results)} failed), APE RMSE "
            f"{ape_translation(truth, trajs[name]).rmse:.4f} m")
    worst, rms = pose_distance(trajs["card"], trajs["host"])
    control = pose_distance(trajs["card without BA"], trajs["host"])[0]
    log(f"    (e) online SfM, card vs host after a similarity: largest {worst:.3e} m (tol "
        f"{ONLINE_TOL:g}), RMS {rms:.3e}; the card without BA vs the host {control:.3e} m "
        f"{'ok' if worst <= ONLINE_TOL < control else 'FAIL'}")
    if worst > ONLINE_TOL:
        raise RuntimeError(f"online SfM: a card pose lies {worst} m from the host's")
    if control <= ONLINE_TOL:
        raise RuntimeError(f"online SfM: the tolerance {ONLINE_TOL} passes a run without BA "
                           f"({control} m)")


def pose_distance(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """Largest and RMS distance between two (N, 3) position sets after the
    least-squares similarity that takes a onto b."""
    import torch

    from pi3_slam_tpu_torch.geometry.sim3 import sim3_apply, umeyama

    a, b = torch.as_tensor(a, dtype=torch.float32).cpu(), torch.as_tensor(b, dtype=torch.float32).cpu()
    d = (sim3_apply(umeyama(a, b), a) - b).norm(dim=-1)
    return d.max().item(), d.square().mean().sqrt().item()


def ba_against_host(chunk_path: str) -> None:
    """Chunk 0's BA at eval scale (100 frames, 40,000 tracks of 10 slots)
    from one start on the card and on the host CPU: one LM step at the
    starting damping 1e-4, and the first four steps (damping 1e-4 down to
    2.7e-6, each accepted for a cost drop of 0.6% or more), while the damping
    still fixes the solution. Each bound must also reject the host's result
    with 1% of the tracks removed."""
    import torch

    from pi3_slam_tpu_torch.sfm.ba import _gn_step, bundle_adjust
    from pi3_slam_tpu_torch.sfm.reconstruction import build_chunk_reconstruction
    from pi3_slam_tpu_torch.slam.offline_reconstructor import load_chunk_npz

    chunk = load_chunk_npz(chunk_path)
    kpf = chunk["keypoints"].shape[1]
    recon = build_chunk_reconstruction(chunk, run_ba=False, device="cpu")
    step, solve = {}, {}
    for name in ("cuda", "cpu", "cpu, 1% of the tracks removed"):
        device = name.split(",")[0]
        prob = recon.to_problem(device=device)
        if "removed" in name:
            prob = prob._replace(track_valid=prob.track_valid * (
                torch.arange(prob.track_valid.shape[0]) % 100 != 0))
        n = prob.centers.shape[0]
        s = _gn_step(prob, 2.0, torch.tensor(1e-4, device=device), torch.zeros(n, device=device),
                     tracks_per_frame=kpf)
        step[name] = s[0].cpu()
        out, info = bundle_adjust(prob, iterations=4, tracks_per_frame=kpf, return_info=True)
        solve[name] = (out.centers.cpu(), float(info["final_cost"]))

    def gaps(name):
        return ((step[name] - step["cpu"]).abs().max().item(),
                pose_distance(solve[name][0], solve["cpu"][0])[0],
                abs(solve[name][1] - solve["cpu"][1]) / solve["cpu"][1])

    # On an NVIDIA H100 80GB HBM3 at 700 W the card read 2.07e-6 (the step's
    # rotations), 1.35e-5 (four steps' centers) and 7.8e-6 (the cost). The
    # step's centers are not held: removing 1% of the tracks moves them about
    # as far as the card's other summation order does.
    tols = (1e-5, 5e-5, 1e-4)
    labels = ("one step, rotations", "4 steps, centers after a similarity",
              "4 steps, relative cost")
    card, cut = gaps("cuda"), gaps("cpu, 1% of the tracks removed")
    for label, got, control, tol in zip(labels, card, cut, tols):
        log(f"    chunk 0 BA, card vs host, {label}: {got:.3e} (tol {tol:g}; the host with 1% of "
            f"the tracks removed: {control:.3e}) {'ok' if got <= tol < control else 'FAIL'}")
        if got > tol:
            raise RuntimeError(f"chunk 0 BA, {label}: card {got} from the host, tolerance {tol}")
        if control <= tol:
            raise RuntimeError(f"chunk 0 BA, {label}: the tolerance {tol} passes a problem with "
                               f"1% of the tracks removed ({control})")


# --- phase 8: the evaluation on the port from converted reference
# checkpoints. The reference Pi3 and MoGe-2 key maps, inverted: the port's
# converters (pi3_slam_tpu_torch/models/convert.py) map these names onto the
# JAX layout, so a JAX-layout tree gives the state dict they expect.

REF_BLOCK = {"norm1_scale": "norm1.weight", "norm1_bias": "norm1.bias",
             "qkv_kernel": "attn.qkv.weight", "qkv_bias": "attn.qkv.bias",
             "proj_kernel": "attn.proj.weight", "proj_bias": "attn.proj.bias",
             "norm2_scale": "norm2.weight", "norm2_bias": "norm2.bias",
             "fc1_kernel": "mlp.fc1.weight", "fc1_bias": "mlp.fc1.bias",
             "fc2_kernel": "mlp.fc2.weight", "fc2_bias": "mlp.fc2.bias",
             "q_norm_scale": "attn.q_norm.weight", "q_norm_bias": "attn.q_norm.bias",
             "k_norm_scale": "attn.k_norm.weight", "k_norm_bias": "attn.k_norm.bias",
             "ls1": "ls1.gamma", "ls2": "ls2.gamma"}


def _ref_blocks(sd: dict, prefix: str, stacked: dict, indices) -> None:
    for layer, idx in enumerate(indices):
        for leaf, name in REF_BLOCK.items():
            if leaf in stacked:
                a = stacked[leaf][layer]
                sd[f"{prefix}{idx}.{name}"] = a.T if leaf.endswith("_kernel") else a


def _ref_dinov2(sd: dict, prefix: str, enc: dict) -> None:
    kernel = enc["patch_embed_kernel"]  # (3 p p, C)
    c, p = kernel.shape[1], math.isqrt(kernel.shape[0] // 3)
    sd[f"{prefix}patch_embed.proj.weight"] = kernel.T.reshape(c, 3, p, p)
    sd[f"{prefix}patch_embed.proj.bias"] = enc["patch_embed_bias"]
    sd[f"{prefix}cls_token"] = enc["cls_token"].reshape(1, 1, c)
    sd[f"{prefix}pos_embed"] = enc["pos_embed"].reshape(1, -1, c)
    if enc["register_tokens"].shape[0]:  # a plain DINOv2 has none
        sd[f"{prefix}register_tokens"] = enc["register_tokens"].reshape(1, -1, c)
    sd[f"{prefix}norm.weight"] = enc["norm_scale"]
    sd[f"{prefix}norm.bias"] = enc["norm_bias"]
    _ref_blocks(sd, f"{prefix}blocks.", enc["blocks"], range(len(enc["blocks"]["qkv_kernel"])))


def reference_pi3_state_dict(tree: dict) -> dict:
    """A JAX-layout Pi3 tree -> the reference Pi3's state dict (numpy
    arrays, views of the tree's leaves)."""
    sd: dict = {}
    _ref_dinov2(sd, "encoder.", tree["encoder"])
    dec = tree["decoder"]
    sd["register_token"] = dec["register_token"][None, None]
    pairs = len(dec["even_blocks"]["qkv_kernel"])
    _ref_blocks(sd, "decoder.", dec["even_blocks"], range(0, 2 * pairs, 2))
    _ref_blocks(sd, "decoder.", dec["odd_blocks"], range(1, 2 * pairs, 2))
    for name in ("point_decoder", "conf_decoder", "camera_decoder"):
        hd = tree[name]
        sd[f"{name}.projects.weight"] = hd["project_kernel"].T
        sd[f"{name}.projects.bias"] = hd["project_bias"]
        _ref_blocks(sd, f"{name}.blocks.", hd["blocks"], range(len(hd["blocks"]["qkv_kernel"])))
        sd[f"{name}.linear_out.weight"] = hd["out_kernel"].T
        sd[f"{name}.linear_out.bias"] = hd["out_bias"]
    for name in ("point_head", "conf_head"):
        sd[f"{name}.proj.weight"] = tree[name]["kernel"].T
        sd[f"{name}.proj.bias"] = tree[name]["bias"]
    cam = tree["camera_head"]
    for i in range(2):
        for j in (1, 2, 3):
            sd[f"camera_head.res_conv.{i}.res_conv{j}.weight"] = cam[f"res_conv{i}"][f"fc{j}_kernel"].T
            sd[f"camera_head.res_conv.{i}.res_conv{j}.bias"] = cam[f"res_conv{i}"][f"fc{j}_bias"]
    for leaf, name in (("mlp1", "more_mlps.0"), ("mlp2", "more_mlps.2"), ("fc_t", "fc_t"),
                       ("fc_rot", "fc_rot")):
        sd[f"camera_head.{name}.weight"] = cam[f"{leaf}_kernel"].T
        sd[f"camera_head.{name}.bias"] = cam[f"{leaf}_bias"]
    return sd


def _ref_conv(sd: dict, name: str, p: dict, leaf: str = "") -> None:
    sd[f"{name}.weight"] = p[f"{leaf}kernel"].transpose(3, 2, 0, 1)  # HWIO -> OIHW
    sd[f"{name}.bias"] = p[f"{leaf}bias"]


def _ref_conv_stack(sd: dict, prefix: str, p: dict) -> None:
    for kind in ("input_blocks", "output_blocks"):
        for i, conv in enumerate(p[kind]):
            if conv is not None:
                _ref_conv(sd, f"{prefix}{kind}.{i}", conv)
    for i, level in enumerate(p["res_blocks"]):
        for j, blk in enumerate(level):
            base = f"{prefix}res_blocks.{i}.{j}."
            _ref_conv(sd, f"{base}layers.2", blk, "conv1_")
            _ref_conv(sd, f"{base}layers.5", blk, "conv2_")
            for norm, layer in (("norm1", 0), ("norm2", 3)):
                if f"{norm}_scale" in blk:
                    sd[f"{base}layers.{layer}.weight"] = blk[f"{norm}_scale"]
                    sd[f"{base}layers.{layer}.bias"] = blk[f"{norm}_bias"]
            if "skip_kernel" in blk:
                _ref_conv(sd, f"{base}skip_connection", blk, "skip_")
    for i, res in enumerate(p["resamplers"]):
        _ref_conv(sd, f"{prefix}resamplers.{i}.0", res, "conv1_")
        _ref_conv(sd, f"{prefix}resamplers.{i}.2", res, "conv2_")


def reference_moge_checkpoint(tree: dict) -> tuple[dict, dict]:
    """A JAX-layout MoGe-2 tree -> the reference checkpoint's 'model' state
    dict (numpy arrays) and its 'model_config'."""
    import dataclasses

    from pi3_slam_tpu_torch.models.moge_model import MoGeConfig

    cfg = MoGeConfig.from_json(str(tree["_config_json"]))
    sd: dict = {}
    _ref_dinov2(sd, "encoder.backbone.", tree["backbone"])
    for i, proj in enumerate(tree["output_projections"]):
        _ref_conv(sd, f"encoder.output_projections.{i}", proj)
    stacks = {}
    for name in ("neck", "points_head", "mask_head", "normal_head"):
        stacks[name] = None
        if getattr(cfg, name) is not None:
            _ref_conv_stack(sd, f"{name}.", tree[name])
            stacks[name] = dataclasses.asdict(getattr(cfg, name))
    for i, lin in enumerate(tree.get("scale_head") or []):  # Linear layers, a ReLU between
        sd[f"scale_head.{2 * i}.weight"] = lin["kernel"].T
        sd[f"scale_head.{2 * i}.bias"] = lin["bias"]
    model_config = {
        "encoder": {"backbone": cfg.backbone, "intermediate_layers": cfg.intermediate_layers,
                    "dim_out": cfg.encoder_dim_out},
        **stacks,
        "scale_head": {"dims": list(cfg.scale_head_dims)} if cfg.scale_head_dims else None,
        "remap_output": cfg.remap_output,
        "num_tokens_range": list(cfg.num_tokens_range),
    }
    return sd, model_config


def write_safetensors(path: str, tensors: dict) -> None:
    """An F32 .safetensors file: an 8-byte little-endian header length, the
    JSON header (dtype, shape, data_offsets), then the raw bytes."""
    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + 4 * a.size]}
        offset += 4 * a.size
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for a in tensors.values():
            np.ascontiguousarray(a, dtype="<f4").tofile(f)


def tree_leaves(node, prefix: str = ""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from tree_leaves(v, f"{prefix}/{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from tree_leaves(v, f"{prefix}/#{i}")
    else:
        yield prefix, node


def same_tree(what: str, got: dict, want: dict) -> int:
    """Every leaf of got equal to want's (np.array_equal); returns the count."""
    g, w = dict(tree_leaves(got)), dict(tree_leaves(want))
    if g.keys() != w.keys():
        raise RuntimeError(f"{what}: converted leaves differ: {sorted(g.keys() ^ w.keys())[:5]}")
    bad = [k for k in w if (g[k] is None) != (w[k] is None)
           or (w[k] is not None and not np.array_equal(np.asarray(g[k]), np.asarray(w[k])))]
    if bad:
        raise RuntimeError(f"{what}: {len(bad)} converted leaves differ from the tree: {bad[:5]}")
    return len(w)


def smooth_poses(n: int) -> np.ndarray:
    """(n, 4, 4) camera-to-world: forward motion with a slight yaw (the
    trajectory of tools/smoke_eval_scripts.py's fabricated scenes)."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        poses[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[i, :3, 3] = [0.05 * i, 0.01 * np.sin(0.3 * i), 0.02 * i]
    return poses


def write_7scenes(root: str, frames: str) -> None:
    """One 7-Scenes-shaped scene, <root>/scene/seq-01: phase 4's 130 frames
    as frame-XXXXXX.color.png with a pose file each."""
    import shutil

    seq = os.path.join(root, "scene", "seq-01")
    os.makedirs(seq)
    for i, pose in enumerate(smooth_poses(130)):
        shutil.copyfile(os.path.join(frames, f"frame_{i:04d}.png"),
                        os.path.join(seq, f"frame-{i:06d}.color.png"))
        np.savetxt(os.path.join(seq, f"frame-{i:06d}.pose.txt"), pose)


def write_euroc(root: str, n: int = 530, skip: int = 400, height: int = 480,
                width: int = 752) -> str:
    """A EuRoC-shaped MH_03 (cam0 frames named by their nanosecond stamps at
    20 Hz, the ``skip`` frames its start-frame skip drops copies of the first
    kept one; ground truth at 200 Hz around them) and a radial-tangential
    cam0 calibration; returns the calibration's path."""
    import shutil

    mav0 = os.path.join(root, "MH_03", "mav0")
    cam0 = os.path.join(mav0, "cam0", "data")
    os.makedirs(cam0)
    os.makedirs(os.path.join(mav0, "state_groundtruth_estimate0"))
    t0, dt = 1403636579763555584, 50_000_000
    names = [f"{t0 + i * dt}.png" for i in range(n)]
    write_frames(cam0, n - skip, (height, width), names[skip:])
    for name in names[:skip]:
        shutil.copyfile(os.path.join(cam0, names[skip]), os.path.join(cam0, name))
    gt_t = np.arange(t0 - 10 * dt, t0 + (n + 9) * dt, dt // 10, dtype=np.int64)
    poses = smooth_poses(len(gt_t))
    with open(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp,px,py,pz,qw,qx,qy,qz\n")
        for t, pose in zip(gt_t, poses):
            r = pose[:3, :3]
            qw = 0.5 * np.sqrt(max(0.0, 1 + r[0, 0] + r[1, 1] + r[2, 2]))
            q = [(r[2, 1] - r[1, 2]) / (4 * qw), (r[0, 2] - r[2, 0]) / (4 * qw),
                 (r[1, 0] - r[0, 1]) / (4 * qw)]
            f.write(f"{t},{pose[0, 3]},{pose[1, 3]},{pose[2, 3]},{qw},{q[0]},{q[1]},{q[2]}\n")
    calib = os.path.join(root, "cam0_calib.json")
    with open(calib, "w") as f:
        json.dump({"image_height": height, "image_width": width,
                   "intrinsic_type": "PINHOLE_RADIAL_TANGENTIAL",
                   "intrinsics": {"aspect_ratio": 1.0, "focal_length": 0.7 * width,
                                  "principal_pt_x": width / 2 + 1.0,
                                  "principal_pt_y": height / 2 - 1.0,
                                  "radial_distortion_1": -0.05, "radial_distortion_2": 0.01,
                                  "radial_distortion_3": 0.0, "tangential_distortion_1": 1e-4,
                                  "tangential_distortion_2": 1e-4, "skew": 0.0}}, f)
    return calib


def convert(model: str, src: str, out: str) -> float:
    """python -m pi3_slam_tpu_torch.tools.convert_checkpoint in process;
    returns its wall seconds."""
    from pi3_slam_tpu_torch.tools.convert_checkpoint import main as convert_main

    argv = ["--model", model, "--input", src, "--output", out]
    log("    python -m pi3_slam_tpu_torch.tools.convert_checkpoint " + " ".join(argv))
    t0 = time.perf_counter()
    if convert_main(argv):
        raise RuntimeError(f"converting {src} failed")
    return time.perf_counter() - t0


def eval_run(argv: list, name: str, n_frames: int) -> dict:
    """One run of python -m pi3_slam_tpu_torch.tools.eval in process on one
    scene or sequence: a finite APE, its ground truth and trajectory with
    n_frames poses, two chunks that each launch the metric-depth path's
    kernels. Returns the tool's record of it."""
    from pi3_slam_tpu_torch.io.tum import read_tum_trajectory
    from pi3_slam_tpu_torch.tools.eval import run as evaluate

    log("    python -m pi3_slam_tpu_torch.tools.eval " + " ".join(argv))
    res = evaluate(argv)[name]
    steps = res["steps"]
    online = "pi3_slam_online" in steps
    per_chunk = [nonzero(c) for c in (steps["pi3_slam_online"]["chunk_launches"] if online else
                                      [r["launches"] for r in steps["create_offline_chunks"]])]
    if per_chunk != [PATH_LAUNCHES["metric_depth"]] * 2:
        raise RuntimeError(f"{name}: launches per chunk {per_chunk}, expected two chunks of "
                           f"{PATH_LAUNCHES['metric_depth']}")
    if not math.isfinite(res["rmse"]) or res["pairs"] != n_frames:
        raise RuntimeError(f"{name}: APE RMSE {res['rmse']} over {res['pairs']} pairs")
    out = os.path.dirname(res["gt"])
    for path in (res["gt"], os.path.join(out, "trajectory_tum.txt")):
        positions = read_tum_trajectory(path)["positions"]
        if positions.shape != (n_frames, 3) or not np.isfinite(positions).all():
            raise RuntimeError(f"{path}: {positions.shape} poses, or not finite")
    if online:
        r = steps["pi3_slam_online"]
        log(f"    {name}, online: {res['seconds']:.2f}s ({r['fps']:.2f} frames/s through the "
            f"online CLI; stages {stage_line(r['queue_status'])}), APE RMSE {res['rmse']:.4f} m "
            f"over {res['pairs']} poses")
    else:
        records = steps["create_offline_chunks"]
        recon = steps["reconstruct_offline"]["timings"]
        log(f"    {name}, offline: {res['seconds']:.2f}s; frames/s into chunks "
            f"{[round(r['fps'], 2) for r in records]}; reconstruction per chunk "
            f"{[round(t['recon_s'], 3) for t in recon]}s; APE RMSE {res['rmse']:.4f} m over "
            f"{res['pairs']} poses")
    return res


def phase_eval(tmp: str) -> dict:
    """(a) the converter CLI on a reference-named Pi3 model.safetensors and a
    MoGe-2 model.pt made from the random trees; (b)-(d) the eval tool on
    them. Returns the eval runs' launch counts."""
    import torch

    from pi3_slam_tpu_torch.models.convert import (
        init_moge_params,
        init_pi3_params,
        load_params_npz,
        load_pi3_checkpoint,
        moge_vits_config,
    )
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts

    ckpt = os.path.join(tmp, "ckpt")
    os.makedirs(ckpt)
    log("  (a) the converters: a reference-named Pi3 model.safetensors from init_pi3_params(0), "
        "a MoGe-2 model.pt from init_moge_params(0, moge_vits_config())")
    tree = init_pi3_params(0)
    src = os.path.join(ckpt, "model.safetensors")
    write_safetensors(src, reference_pi3_state_dict(tree))
    pi3 = os.path.join(ckpt, "pi3.npz")
    seconds = convert("pi3", src, pi3)
    os.remove(src)
    params, cfg = load_pi3_checkpoint(pi3)
    n = same_tree("Pi3", params, tree)
    if cfg != Pi3Config():
        raise RuntimeError(f"the converted Pi3 checkpoint embeds {cfg}, not Pi3Config()")
    log(f"    Pi3: {n} leaves equal to the random tree, config Pi3Config(); {seconds:.2f}s")
    del tree, params
    tree = init_moge_params(0, moge_vits_config())
    sd, model_config = reference_moge_checkpoint(tree)
    src = os.path.join(ckpt, "model.pt")
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "model_config": model_config}, src)
    moge = os.path.join(ckpt, "moge.npz")
    seconds = convert("moge", src, moge)
    n = same_tree("MoGe-2", load_params_npz(moge), tree)
    log(f"    MoGe-2: {n} leaves equal to the random tree (its config JSON too); {seconds:.2f}s")

    no_gt = os.path.join(tmp, "no_gt")  # no ground-truth file: the tool makes it
    data = os.path.join(tmp, "7scenes")
    write_7scenes(data, os.path.join(tmp, "frames"))
    reset_launch_counts()
    for mode, label in (("offline", "(b)"), ("online", "(c)")):
        log(f"  {label} 7-Scenes {mode}: 130 frames at 640x480")
        eval_run(["7scenes", data, pi3, moge, os.path.join(tmp, f"eval_{mode}"), "--scenes", "scene",
                  "--mode", mode, "--gt-dir", no_gt], "scene", 130)
    log("  (d) EuRoC MH_03: 530 frames at 752x480, the first 400 skipped, radial-tangential calib")
    euroc = os.path.join(tmp, "euroc")
    calib = write_euroc(euroc)
    eval_run(["euroc", euroc, pi3, calib, moge, os.path.join(tmp, "eval_euroc"), "--seqs", "MH_03",
              "--gt-dir", no_gt], "MH_03", 130)
    return nonzero(launch_counts())


# --- phase 9: the appearance path (ALIKED, ZNCC refinement, loop closure)

# (c)'s bounds, card against host: the dense maps' relative L2 (cuDNN fp32,
# TF32 off, against the CPU's convolutions), then from the card's own maps
# the keypoints of valid slots (px) and the descriptors' relative L2
ALIKED_MAP_TOL = 1e-4
ALIKED_KP_TOL = 1e-4
ALIKED_DESC_TOL = 1e-5
# (d): refined coordinates (px) and ZNCC peaks, card against host. Where two
# displacements score within rounding of each other the first maximum can
# differ by a pixel between card and host; such an observation is a near-tie
# when its peaks agree within ZNCC_PEAK_TOL, and at most ZNCC_TIE_SHARE of
# the observations may be one
ZNCC_UV_TOL = 1e-4
ZNCC_PEAK_TOL = 1e-5
ZNCC_TIE_SHARE = 1e-3
# (e): the largest distance between the card's and the host's loop-closed
# trajectories after one similarity, on a circle of radius 5; the card's
# trajectory without loop closure must lie outside it
LOOP_TOL = 1e-2


def write_loop_chunks(out: str, rng, n_frames=150, n_landmarks=2500, chunk_length=30, overlap=5,
                      n_kp=100, noise_px=0.4, pt_sigma=0.03, desc_dim=64) -> np.ndarray:
    """tests/test_loop_system.py's scene, copied with numpy and scipy: a
    closed circle of radius 5 (cameras facing outward) around a landmark
    ring, each chunk in its own random Sim3 gauge with point noise, and a
    unit descriptor per landmark, so the revisit is found by appearance.
    Returns the true camera centers."""
    from scipy.spatial.transform import Rotation

    from pi3_slam_tpu_torch.data.datasets import chunk_windows

    w, h, f = 640, 480, 500.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    theta = 2 * np.pi * np.arange(n_frames) / n_frames
    centers = np.stack([5 * np.cos(theta), 5 * np.sin(theta), np.zeros(n_frames)], axis=1)
    rots = np.stack([np.stack([[-np.sin(t), np.cos(t), 0.0], [0.0, 0.0, 1.0],
                               [np.cos(t), np.sin(t), 0.0]], axis=1) for t in theta])
    phi = rng.uniform(0, 2 * np.pi, n_landmarks)
    rad = rng.uniform(9, 13, n_landmarks)
    landmarks = np.stack([rad * np.cos(phi), rad * np.sin(phi),
                          rng.uniform(-2.5, 2.5, n_landmarks)], axis=1)
    desc = rng.normal(size=(n_landmarks, desc_dim))
    desc = (desc / np.linalg.norm(desc, axis=-1, keepdims=True)).astype(np.float32)
    os.makedirs(os.path.join(out, "chunks"), exist_ok=True)
    for ci, (s, e) in enumerate(chunk_windows(n_frames, chunk_length, overlap)):
        frames = list(range(s, e))
        nf = len(frames)
        g_s = rng.uniform(0.8, 1.25)
        g_R = Rotation.from_rotvec(rng.normal(size=3) * 0.08).as_matrix()
        g_t = rng.normal(size=3) * 0.4
        kps = np.zeros((nf, n_kp, 2), np.float32)
        pts = np.zeros((nf, n_kp, 3), np.float32)
        descs = np.zeros((nf, n_kp, desc_dim), np.float32)
        poses = np.tile(np.eye(4), (nf, 1, 1))
        for j, fidx in enumerate(frames):
            cam = (landmarks - centers[fidx]) @ rots[fidx]
            z = cam[:, 2]
            uv = np.stack([K[0, 0] * cam[:, 0] / z + K[0, 2], K[1, 1] * cam[:, 1] / z + K[1, 2]], 1)
            vis = (z > 1.0) & (uv[:, 0] > 5) & (uv[:, 0] < w - 5) & (uv[:, 1] > 5) & (uv[:, 1] < h - 5)
            sel_rng = np.random.default_rng(fidx)  # the same keypoints in every chunk
            vis_ids = np.nonzero(vis)[0]
            sel = vis_ids[sel_rng.permutation(len(vis_ids))[:n_kp]]
            sel = np.concatenate([sel, np.repeat(sel[-1:], n_kp - len(sel))])
            kps[j] = uv[sel] + sel_rng.normal(size=(n_kp, 2)) * noise_px
            pw = g_s * landmarks[sel] @ g_R.T + g_t
            pts[j] = pw + rng.normal(size=pw.shape) * (pt_sigma * g_s)
            descs[j] = desc[sel]
            poses[j, :3, :3] = g_R @ rots[fidx]
            poses[j, :3, 3] = g_s * g_R @ centers[fidx] + g_t
        np.savez_compressed(
            os.path.join(out, "chunks", f"chunk_{ci:06d}.npz"),
            keypoints=kps.astype(np.float16), points=pts.astype(np.float16),
            colors=np.full((nf, n_kp, 3), 128, np.uint8), camera_poses=poses.astype(np.float32),
            intrinsics=np.tile(K, (nf, 1, 1)).astype(np.float32),
            image_paths=np.asarray([f"frame_{i:04d}.png" for i in frames]),
            original_width=w, original_height=h, masks=np.ones((nf, n_kp), bool),
            descriptors=descs.astype(np.float16))
    with open(os.path.join(out, "chunk_metadata.json"), "w") as fj:
        json.dump({"chunk_length": chunk_length, "overlap": overlap}, fj)
    return centers


def rel_l2(got, want) -> float:
    import torch

    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / want.norm()).item()


def appearance_chunks(out: str, records: list) -> None:
    """The eval tool's appearance chunks: keypoint validity, float16
    descriptors and the refined fan (int16 frames, float32 coordinates), all
    finite; per chunk the share of refined observations and the seconds of
    ALIKED, of the refinement and of the whole chunk."""
    import glob

    paths = sorted(glob.glob(os.path.join(out, "chunks", "chunk_*.npz")))
    if len(paths) != len(records) or len(paths) != 2:
        raise RuntimeError(f"{out}: {len(paths)} chunk files, {len(records)} records")
    for path, rec in zip(paths, records):
        with np.load(path) as z:
            want = {"keypoint_valid": np.bool_, "descriptors": np.float16, "obs_frame": np.int16,
                    "obs_uv": np.float32, "obs_valid": np.bool_, "obs_refined": np.bool_}
            for key, dtype in want.items():
                if key not in z.files or z[key].dtype != dtype:
                    raise RuntimeError(f"{path}: {key} missing or not {np.dtype(dtype)}")
                if not np.isfinite(z[key].astype(np.float32)).all():
                    raise RuntimeError(f"{path}: {key} not finite")
            n, k, m = z["obs_frame"].shape
            if z["descriptors"].shape != (n, k, 128) or z["obs_uv"].shape != (n, k, m, 2):
                raise RuntimeError(f"{path}: descriptors {z['descriptors'].shape}, obs_uv "
                                   f"{z['obs_uv'].shape}")
            fan = z["obs_valid"][:, :, 1:]
            share = z["obs_refined"].sum() / max(1, fan.sum())
            log(f"      {os.path.basename(path)}: {n} frames x {k} keypoints "
                f"({z['keypoint_valid'].mean():.3f} valid), fan {m}; "
                f"{fan.sum()} projected observations in bounds, {share:.4f} of them refined; "
                f"ALIKED {rec['aliked_s']:.3f}s, refinement {rec['refine_s'] * 1e3:.2f} ms "
                f"(device), whole chunk {rec['infer_s']:.3f}s ({rec['fps']:.2f} frames/s)")


def aliked_card_vs_host(aliked: str, frames: str) -> None:
    """(c) ALIKED-n16 on eight 308x406 frames: the dense maps on the card
    and on the host CPU; then detection and SDDH on both from the card's own
    maps. Then the card's time for a 100-frame chunk."""
    import torch
    from PIL import Image

    from pi3_slam_tpu_torch.models.aliked import (
        aliked_dense_maps,
        aliked_state_from_jax,
        build_aliked,
        describe_keypoints,
        detect_keypoints,
    )
    from pi3_slam_tpu_torch.models.convert import load_aliked_checkpoint
    from pi3_slam_tpu_torch.utils.keypoints import ALIKEDExtractor

    tree, cfg = load_aliked_checkpoint(aliked)
    card = build_aliked(cfg, aliked_state_from_jax(tree), "cuda")
    host = build_aliked(cfg, aliked_state_from_jax(tree), "cpu")
    imgs = np.stack([np.asarray(Image.open(os.path.join(frames, f"frame_{i:04d}.png"))
                                .resize((406, 308), Image.BILINEAR)) for i in range(0, 120, 15)])
    x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).float() / 255.0
    with torch.no_grad():
        fc, sc = aliked_dense_maps(card, x.cuda())
        fh, sh = aliked_dense_maps(host, x)
        e_f, e_s = rel_l2(fc, fh), rel_l2(sc, sh)
        log(f"    (c) ALIKED-n16 dense maps, 8 frames at 308x406, card vs host: relative L2 "
            f"features {e_f:.3e}, scores {e_s:.3e} (tol {ALIKED_MAP_TOL:g})")
        if max(e_f, e_s) > ALIKED_MAP_TOL:
            raise RuntimeError(f"ALIKED dense maps: card vs host {e_f}, {e_s}")
        dc = detect_keypoints(sc, 400, cfg.nms_radius, cfg.detection_threshold)
        dh = detect_keypoints(sc.cpu(), 400, cfg.nms_radius, cfg.detection_threshold)
        valid = dh["valid"]
        if not torch.equal(dc["valid"].cpu(), valid):
            raise RuntimeError("ALIKED detection: card and host validity differ")
        kp_err = (dc["keypoints"].cpu() - dh["keypoints"])[valid].abs().max().item()
        desc_c = describe_keypoints(card, fc, dc["keypoints"])
        desc_h = describe_keypoints(host, fc.cpu(), dh["keypoints"])
        e_d = rel_l2(desc_c, desc_h)
        log(f"    (c) from the card's maps: {int(valid.sum())} of {valid.numel()} slots valid on "
            f"both, keypoints max |err| {kp_err:.3e} px (tol {ALIKED_KP_TOL:g}), descriptors "
            f"relative L2 {e_d:.3e} (tol {ALIKED_DESC_TOL:g})")
        if kp_err > ALIKED_KP_TOL or e_d > ALIKED_DESC_TOL:
            raise RuntimeError(f"ALIKED detection / SDDH: card vs host {kp_err} px, {e_d}")
    chunk = np.repeat(imgs.transpose(0, 3, 1, 2), 13, axis=0)[:100]
    ex = ALIKEDExtractor(aliked, max_num_keypoints=400, device="cuda")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.extract(chunk)
        times.append(time.perf_counter() - t0)
    log(f"    (c) ALIKED-n16 on a 100-frame chunk at 308x406, 400 keypoints (mini-batches of 8, "
        f"uint8 from the host to the host copy): {', '.join(f'{t:.3f}' for t in times)} s")


def zncc_on_card() -> None:
    """(d) ZNCC refinement on the card: planted sub-pixel shifts recovered
    (tests/test_correlation.py's bounds), then 100 smooth 308x406 frames at
    the eval settings, card against host with a keypoint at the last frame's
    bottom-right corner, and the card's time at 300 keypoints with fan 7 and
    400 with fan 10."""
    import torch
    from scipy.ndimage import gaussian_filter, shift as ndshift

    from pi3_slam_tpu_torch.ops.correlation import zncc_refine_observations

    rng = np.random.default_rng(0)

    def smooth(h, w):
        img = gaussian_filter(rng.normal(size=(h, w)), 2.0)
        return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)

    h, w = 64, 80
    img0 = smooth(h, w)
    true = (1.3, -0.7)
    t = 50
    tu, tv = rng.uniform(15, w - 15, t), rng.uniform(15, h - 15, t)
    obs = np.stack([tu + true[1], tv + true[0]], axis=1) + rng.normal(size=(t, 2))
    ruv, peak, ok = zncc_refine_observations(
        torch.tensor(np.stack([img0, ndshift(img0, true, order=3, mode="nearest")]), device="cuda"),
        torch.zeros(t, dtype=torch.long, device="cuda"),
        torch.tensor(np.stack([tu, tv], axis=1), dtype=torch.float32, device="cuda"),
        torch.ones((t, 1), dtype=torch.long, device="cuda"),
        torch.tensor(obs[:, None], dtype=torch.float32, device="cuda"),
        patch_radius=4, search_radius=4)
    ok = ok.cpu().numpy()[:, 0]
    gt = np.stack([tu + true[1], tv + true[0]], axis=1)
    before = np.linalg.norm(obs - gt, axis=1)[ok].mean()
    after = np.linalg.norm(ruv.cpu().numpy()[:, 0] - gt, axis=1)[ok].mean()
    log(f"    (d) planted shift (1.3, -0.7) px: {ok.mean():.2f} refined, mean error {before:.3f} -> "
        f"{after:.3f} px, mean peak {peak.cpu().numpy()[:, 0][ok].mean():.3f}")
    if ok.mean() <= 0.9 or after >= 0.25 or after >= 0.3 * before:
        raise RuntimeError(f"ZNCC on the card: {ok.mean()} refined, {before} -> {after} px")

    n, h, w = 100, 308, 406
    base = smooth(h, w)
    shifts = rng.uniform(-2, 2, (n, 2))
    gray = np.stack([ndshift(base, s, order=1, mode="nearest") for s in shifts])

    def observations(k, fan):
        tf = np.repeat(np.arange(n), k)
        tuv = np.stack([rng.uniform(0, w - 1, n * k), rng.uniform(0, h - 1, n * k)], axis=1)
        of = rng.integers(0, n, (n * k, fan - 1))
        ouv = tuv[:, None] + (shifts[of] - shifts[tf][:, None])[..., ::-1]
        ouv = ouv + rng.normal(size=ouv.shape)
        tf[-1], tuv[-1], of[-1], ouv[-1] = n - 1, (w - 1, h - 1), n - 1, (w - 1, h - 1)
        return [torch.tensor(a, dtype=dt) for a, dt in ((tf, torch.long), (tuv, torch.float32),
                                                      (of, torch.long), (ouv, torch.float32))]

    gray_t = torch.from_numpy(gray)
    for k, fan in ((300, 7), (400, 10)):
        args = observations(k, fan)
        card_args = [gray_t.cuda()] + [a.cuda() for a in args]
        card = zncc_refine_observations(*card_args)
        torch.cuda.synchronize()  # a device-side fault surfaces here
        ms = time_ms(lambda: zncc_refine_observations(*card_args), 5)
        line = (f"    (d) {n} frames at {h}x{w}, {k} keypoints, fan {fan}: {args[2].numel()} "
                f"observations, {ms:.2f} ms on the card, {card[2].float().mean().item():.3f} refined")
        if fan == 7:
            host = zncc_refine_observations(gray_t, *args)
            same = torch.equal(card[2].cpu(), host[2])
            d_uv = (card[0].cpu() - host[0]).abs().amax(-1)
            ties = d_uv > ZNCC_UV_TOL
            e_uv = d_uv[~ties].max().item()
            e_pk = (card[1].cpu() - host[1]).abs().max().item()
            line += (f"; card vs host: flags {'equal' if same else 'DIFFER'}, uv max |err| "
                     f"{e_uv:.2e} px (tol {ZNCC_UV_TOL:g}) but for {int(ties.sum())} near-ties "
                     f"(share {ties.float().mean().item():.2e}, tol {ZNCC_TIE_SHARE:g}; largest "
                     f"{d_uv.max().item():.3f} px), peak {e_pk:.2e} (tol {ZNCC_PEAK_TOL:g}); "
                     f"the last frame's bottom-right corner "
                     f"{'refined' if card[2][-1, -1] else 'kept'}, finite")
            if (not same or e_pk > ZNCC_PEAK_TOL
                    or ties.float().mean().item() > ZNCC_TIE_SHARE):
                raise RuntimeError(f"ZNCC card vs host: flags {same}, peaks {e_pk}, "
                                   f"{int(ties.sum())} coordinates apart")
            if not torch.isfinite(card[0]).all():
                raise RuntimeError("ZNCC on the card: refined coordinates not finite")
        log(line)


def loop_closure_on_card(tmp: str) -> None:
    """(e) The reconstructor CLI on tests/test_loop_system.py's circle (150
    frames, six chunks of 30): with --loop-closure on the card, without it on
    the card, and with it on the host CPU. The first-last edge is found, the
    loop-closed APE is below the open one, and the card's loop-closed
    trajectory lies within LOOP_TOL of the host's after one similarity while
    the open one does not."""
    from pi3_slam_tpu_torch.io.tum import read_tum_trajectory
    from pi3_slam_tpu_torch.reconstruct_offline import reconstruct
    from pi3_slam_tpu_torch.utils.evaluation import ape_translation

    scene = os.path.join(tmp, "loop")
    truth = write_loop_chunks(scene, np.random.default_rng(0))
    runs, traj = {}, {}
    for name, extra in (("card, loop closure", ["--loop-closure"]), ("card, open", []),
                        ("host, loop closure", ["--loop-closure", "--device", "cpu"])):
        out = os.path.join(tmp, "loop_" + name.replace(", ", "_").replace(" ", "_"))
        argv = ["--chunks", scene, "--output", out, "--max-observations-per-track", "6",
                "--ba-iterations", "3", *extra]
        log("    python -m pi3_slam_tpu_torch.reconstruct_offline " + " ".join(argv))
        t0 = time.perf_counter()
        runs[name] = r = reconstruct(argv)
        seconds = time.perf_counter() - t0
        traj[name] = read_tum_trajectory(r["artifacts"]["trajectory"])["positions"]
        ape = ape_translation(truth, traj[name]).rmse
        stats = r["loop_closure"]
        line = f"    (e) {name}: {seconds:.2f}s, APE RMSE {ape:.4f} m"
        if stats is not None:
            edges = ", ".join(f"{e.i}-{e.j} ({e.num_inliers}/{e.num_matches})"
                              for e in stats["edges"])
            line += (f"; loop closure {stats['seconds']:.3f}s, edges {edges or 'none'}, pose-graph "
                     f"cost {stats.get('initial_cost', 0):.4f} -> {stats.get('final_cost', 0):.4f}")
        log(line)
        runs[name] = (r, ape)
    r, ape_loop = runs["card, loop closure"]
    n_chunks = len(r["reconstructions"])
    if (0, n_chunks - 1) not in [(e.i, e.j) for e in r["loop_closure"]["edges"]]:
        raise RuntimeError("loop closure on the card: no edge between the first and last chunks")
    if ape_loop >= runs["card, open"][1]:
        raise RuntimeError(f"loop closure on the card: APE {ape_loop} not below the open "
                           f"{runs['card, open'][1]}")
    worst, rms = pose_distance(traj["card, loop closure"], traj["host, loop closure"])
    control = pose_distance(traj["card, open"], traj["host, loop closure"])[0]
    log(f"    (e) loop-closed trajectory, card vs host after a similarity: largest {worst:.3e} "
        f"(tol {LOOP_TOL:g}), RMS {rms:.3e}; the card's open trajectory vs the host {control:.3e} "
        f"{'ok' if worst <= LOOP_TOL < control else 'FAIL'}")
    if worst > LOOP_TOL:
        raise RuntimeError(f"loop closure: a card pose lies {worst} from the host's")
    if control <= LOOP_TOL:
        raise RuntimeError(f"loop closure: the tolerance {LOOP_TOL} passes the open run "
                           f"({control})")


def phase_appearance(tmp: str) -> dict:
    """(a) the converter CLI on a lightglue-named aliked-n16 state dict;
    (b) the eval tool's 7-Scenes offline and online runs with --keypoints
    aliked --refine --loop on phase 8's scene and checkpoints; (c) ALIKED
    card vs host; (d) ZNCC on the card; (e) loop closure on the card.
    Returns (b)'s launch counts."""
    import torch

    from pi3_slam_tpu_torch.models.aliked import CONFIGS, aliked_state_from_jax, init_aliked_params
    from pi3_slam_tpu_torch.models.convert import load_params_npz
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.tools.eval import run as evaluate

    ckpt = os.path.join(tmp, "ckpt")
    log("  (a) the converter: a lightglue-named aliked-n16 state dict from init_aliked_params(0)")
    tree = init_aliked_params(0, CONFIGS["aliked-n16"])
    src = os.path.join(ckpt, "aliked-n16.pth")
    torch.save(aliked_state_from_jax(tree), src)
    aliked = os.path.join(ckpt, "aliked.npz")
    seconds = convert("aliked", src, aliked)
    params = load_params_npz(aliked)
    if str(params.pop("_model_name")) != "aliked-n16":
        raise RuntimeError("the converted ALIKED file names another variant")
    f32 = {k: v for k, v in tree_leaves(tree)}
    n = same_tree("ALIKED", dict(tree_leaves(params)),
                  {k: np.asarray(v, np.float32) for k, v in f32.items()})
    log(f"    ALIKED: {n} leaves equal to the tree in float32 (the state dict's dtype); "
        f"{seconds:.2f}s")

    pi3, moge = os.path.join(ckpt, "pi3.npz"), os.path.join(ckpt, "moge.npz")
    data, no_gt = os.path.join(tmp, "7scenes"), os.path.join(tmp, "no_gt")
    reset_launch_counts()
    for mode, label in (("offline", "(b)"), ("online", "(b)")):
        log(f"  {label} 7-Scenes {mode} with --keypoints aliked --refine --loop: 130 frames")
        argv = ["7scenes", data, pi3, moge, os.path.join(tmp, f"appearance_{mode}"), "--scenes",
                "scene", "--mode", mode, "--gt-dir", no_gt, "--keypoints", "aliked",
                "--aliked-npz", aliked, "--refine", "--loop"]
        log("    python -m pi3_slam_tpu_torch.tools.eval " + " ".join(argv))
        res = evaluate(argv)["scene"]
        steps = res["steps"]
        if mode == "offline":
            records = steps["create_offline_chunks"]
            per_chunk = [nonzero(r["launches"]) for r in records]
            appearance_chunks(os.path.dirname(res["gt"]), records)
            stats = steps["reconstruct_offline"]["loop_closure"]
        else:
            per_chunk = [nonzero(c) for c in steps["pi3_slam_online"]["chunk_launches"]]
            stats = steps["pi3_slam_online"]["loop_closure"]
        if per_chunk != [PATH_LAUNCHES["metric_depth"]] * 2:
            raise RuntimeError(f"appearance {mode}: launches per chunk {per_chunk}")
        if stats is None or not math.isfinite(res["rmse"]) or res["pairs"] != 130:
            raise RuntimeError(f"appearance {mode}: loop closure {stats}, APE {res['rmse']} over "
                               f"{res['pairs']} pairs")
        log(f"    {mode}: {res['seconds']:.2f}s, loop closure {stats['num_loop_edges']} edges "
            f"(two chunks: detection pairs chunks three or more apart), APE RMSE {res['rmse']:.4f} m over "
            f"{res['pairs']} poses (random weights: printed, not held)")
    counts = nonzero(launch_counts())
    log("  (b) phase 4's 130 frames through the creator CLI with MoGe-2 and phase 8's converted "
        "Pi3, --keypoints aliked --refine-observations, beside phase 4's grid-keypoint run")
    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks

    argv = ["--images", os.path.join(tmp, "frames"), "--output", os.path.join(tmp, "steady"),
            "--chunk-length", "100", "--overlap", "20", "--max-kp", "400", "--model-path", pi3,
            "--moge-path", moge, "--keypoints", "aliked", "--aliked-path", aliked,
            "--refine-observations"]
    log("    python -m pi3_slam_tpu_torch.create_offline_chunks " + " ".join(argv))
    t0 = time.perf_counter()
    records = create_chunks(argv)
    wall = time.perf_counter() - t0
    if [nonzero(r["launches"]) for r in records] != [PATH_LAUNCHES["metric_depth"]] * 2:
        raise RuntimeError(f"aliked + refine: launches {[r['launches'] for r in records]}")
    grid, appearance = METRIC_DEPTH_CHUNK_S[1], records[1]["infer_s"]
    log(f"    aliked + refine: {wall:.1f}s; seconds per chunk "
        f"{', '.join(f'{r['infer_s']:.3f}' for r in records)}; ALIKED "
        f"{', '.join(f'{r['aliked_s']:.3f}' for r in records)} s; refinement "
        f"{', '.join(f'{r['refine_s'] * 1e3:.1f}' for r in records)} ms")
    log(f"    the second chunk (frames 80-129 padded to 100; each run's first chunk carries its "
        f"set-up): {grid:.3f} s with grid keypoints (phase 4), {appearance:.3f} s with ALIKED and "
        f"the refinement ({appearance - grid:+.3f} s)")
    log("  (c) ALIKED-n16, card vs host")
    aliked_card_vs_host(aliked, os.path.join(tmp, "frames"))
    log("  (d) ZNCC refinement on the card")
    zncc_on_card()
    log("  (e) loop closure on the card: tests/test_loop_system.py's circle")
    loop_closure_on_card(tmp)
    return counts


# --- phase 10: localization and telemetry (the second camera, georeferencing)

# (b) planted registration: the Sim3 against the truth (rotation angle in
# rad, translation in m, scale relative) and the card's Sim3 against the
# host's (largest entry difference)
REG_ROT_TOL = 1e-3
REG_T_TOL = 1e-2
REG_S_TOL = 1e-3
REG_HOST_TOL = 1e-4
# (c) planted PnP: each pose against the truth (rad, m) and the card's
# against the host's on the same samples; the triangulated cloud against the
# truth (its median, and the largest distance among points seen from ten or
# more views, m) and the card's against the host's. The refinement keeps the
# best sample's inliers; where that 8-point DLT pose was off, they are a
# part of the true ones on one side of the image, and with 2 mm point noise
# and 0.5 px the pose rests a few 1e-3 rad and centimetres off (on an NVIDIA
# H100 80GB HBM3 at 700 W up to 3.8e-3 rad and 4.4e-2 m over 100 images);
# a wrong solve lands decimetres off
PNP_ROT_TOL = 1e-2
PNP_C_TOL = 0.1
PNP_HOST_ROT_TOL = 1e-4
PNP_HOST_C_TOL = 1e-3
TRI_GATE_PX = 3.0  # the CLI's --triangulate-max-rms
TRI_MEDIAN_TOL = 1e-2
TRI_TOL = 0.15
TRI_HOST_TOL = 1e-3
# (d) the georeferenced trajectory against the true ENU track and the card's
# against the host's, largest distance with no similarity (m); the largest
# angle between a camera's estimated and true gravity direction (rad)
GEO_TOL = 0.4
GEO_HOST_TOL = 5e-2
GRAVITY_TOL = 2e-2
# (d)'s track: phase 6's corridor with a sideways sway of 1.5 m (period 21
# s), so that GPS fixes the rotation about the direction of travel (on a
# straight track only gravity does, and the per-chunk refine turns the chunks
# slowly: 0.53 rad to 0.43 in its 20 iterations)
GEO_SWAY = 1.5
GEO_SWAY_RATE = 0.03
# the WGS84 constants of sfm/priors.py, for the fixes of a known ENU track
WGS84_A = 6378137.0
WGS84_E2 = (1.0 / 298.257223563) * (2.0 - 1.0 / 298.257223563)


def rotation_angle(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Angles (rad) of a b^T for (..., 3, 3) rotations."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(np.asarray(a, np.float64) @ np.swapaxes(
        np.asarray(b, np.float64), -1, -2)).magnitude()


def unit_rows(rng, n: int, dim: int) -> np.ndarray:
    d = rng.normal(size=(n, dim))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def planted_chunk(names, K, centers, rots, landmarks, desc, sel, gauge=None, noise=0.002,
                  rng=None, outliers=0.0):
    """A ChunkReconstruction (no BA) whose frame j owns tracks at the
    landmarks sel[j] (point noise ``noise`` m, a share ``outliers`` of them
    displaced by N(0, 1 m)), with their descriptors; in the Sim3 gauge
    (s, R, t) that takes map coordinates to the chunk's."""
    from pi3_slam_tpu_torch.sfm.reconstruction import ChunkReconstruction

    n, k = sel.shape
    ids = sel.reshape(-1)
    pts = landmarks[ids] + rng.normal(size=(ids.size, 3)) * noise
    bad = rng.uniform(size=ids.size) < outliers
    pts[bad] += rng.normal(size=(int(bad.sum()), 3))
    r_cw = np.transpose(rots, (0, 2, 1))
    cam = np.einsum("nij,nkj->nki", r_cw, landmarks[sel] - centers[:, None])
    uv = np.stack([K[0, 0] * cam[..., 0] / cam[..., 2] + K[0, 2],
                   K[1, 1] * cam[..., 1] / cam[..., 2] + K[1, 2]], -1).reshape(-1, 1, 2)
    c = centers
    if gauge is not None:
        gs, gR, gt = gauge
        pts, c, r_cw = gs * pts @ gR.T + gt, gs * centers @ gR.T + gt, r_cw @ gR.T
    frame = np.repeat(np.arange(n), k).astype(np.int32)
    return ChunkReconstruction(
        frame_names=list(names), rotations=r_cw.astype(np.float32), centers=c.astype(np.float32),
        intrinsics=np.tile([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], (n, 1)).astype(np.float32),
        points=pts.astype(np.float32), colors=np.full((ids.size, 3), 0.5, np.float32),
        track_frame=frame, track_kp=np.tile(np.arange(k), n).astype(np.int32),
        track_uv=uv[:, 0].astype(np.float32), track_valid=np.ones(ids.size, np.float32),
        obs_frame=frame[:, None].copy(), obs_uv=uv.astype(np.float32),
        obs_valid=np.ones((ids.size, 1), np.float32), image_width=640, image_height=480,
        track_desc=desc[ids])


def visible(K, center, rot, points, margin=5.0, width=640, height=480):
    """Indices of the points in front of a camera (camera-to-world ``rot``)
    and inside its image, and their pixels."""
    cam = (points - center) @ rot
    z = cam[:, 2]
    uv = np.stack([K[0, 0] * cam[:, 0] / z + K[0, 2], K[1, 1] * cam[:, 1] / z + K[1, 2]], 1)
    ok = ((z > 0.5) & (uv[:, 0] > margin) & (uv[:, 0] < width - margin) & (uv[:, 1] > margin)
          & (uv[:, 1] < height - margin))
    return np.nonzero(ok)[0], uv


def planted_scene(rng, n_map=400, chunk=100, n_kp=400, n_landmarks=20000, dim=128):
    """The map: 4 chunks of 100 frames of phase 6's corridor, 400 tracks a
    frame at landmarks (2 mm of point noise: at 5 mm, 8-point DLT samples of
    the PnP phase come out centimetres off and a RANSAC vote at 5 px can find
    none) with 128-d unit descriptors; and the second camera's path, 0.4 m
    beside the map's with another yaw."""
    from scipy.spatial.transform import Rotation

    K, centers, rots, landmarks = make_synthetic_sequence(rng, n_map, n_landmarks, 640, 480, 0.08,
                                                          0.0007)
    desc = unit_rows(rng, n_landmarks, dim)
    sel = np.zeros((n_map, n_kp), np.int64)
    for i in range(n_map):
        ids = visible(K, centers[i], rots[i], landmarks)[0]
        sel[i] = rng.choice(ids, n_kp, replace=False)
    recons = [planted_chunk([f"map_{i:04d}.png" for i in range(c, c + chunk)], K,
                            centers[c:c + chunk], rots[c:c + chunk], landmarks, desc,
                            sel[c:c + chunk], rng=rng) for c in range(0, n_map, chunk)]
    q_centers = centers + np.array([0.0, 0.4, 0.1])
    q_rots = np.stack([Rotation.from_euler("yx", [0.03 * np.sin(i / 20), 0.02]).as_matrix()
                       for i in range(n_map)]) @ rots
    return K, landmarks, desc, recons, q_centers, q_rots


def registration_on_card(scene, rng) -> None:
    """(b) Two query chunks of 100 frames, 400 tracks a frame, in the gauge
    of a known Sim3 (scale 1.3), 20% of the points displaced, registered onto
    the 4-chunk map by register_reconstruction on the card and on the host."""
    import torch
    from scipy.spatial.transform import Rotation

    from pi3_slam_tpu_torch.sfm.localize import _pool_map_tracks, register_reconstruction

    K, landmarks, desc, recons, q_centers, q_rots = scene
    pool = _pool_map_tracks(recons)
    s_true = 1.3
    R_true = Rotation.from_euler("xyz", [0.3, -0.2, 0.5]).as_matrix()
    t_true = np.array([2.0, -1.0, 0.5])
    # the query gauge: map = s R q + t, so q = R^T (map - t) / s
    gauge = (1.0 / s_true, R_true.T, -R_true.T @ t_true / s_true)
    for c, start in enumerate((40, 240)):
        frames = range(start, start + 100)
        sel = np.stack([rng.choice(visible(K, q_centers[i], q_rots[i], landmarks)[0], 400,
                                   replace=False) for i in frames])
        window = slice(start, start + 100)
        query = planted_chunk([f"query_{i:04d}.png" for i in frames], K, q_centers[window],
                              q_rots[window], landmarks, desc, sel, gauge=gauge, rng=rng,
                              outliers=0.2)
        res = {}
        for where, device in (("card", "cuda"), ("host", "cpu")):
            t0 = time.perf_counter()
            r = register_reconstruction(recons, query, map_pool=pool, apply=False, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            res[where] = (r, time.perf_counter() - t0)
        r = res["card"][0]
        if not (r.success and res["host"][0].success):
            raise RuntimeError(f"registration of query chunk {c} failed: {r}, {res['host'][0]}")
        s, R, t = (x.detach().cpu().double().numpy() for x in r.sim3)
        hs, hR, ht = (x.detach().cpu().double().numpy() for x in res["host"][0].sim3)
        rot_err = float(rotation_angle(R, R_true))
        t_err = float(np.linalg.norm(t - t_true))
        s_err = abs(float(s) / s_true - 1.0)
        host = max(abs(float(s - hs)), np.abs(R - hR).max(), np.abs(t - ht).max())
        log(f"    (b) query chunk {c}: {r.num_matches} matches, {r.num_inliers} inliers "
            f"(host {res['host'][0].num_inliers}), inlier RMS {r.inlier_rms:.4f} m; against the "
            f"truth: rotation {rot_err:.3e} rad (tol {REG_ROT_TOL:g}), translation {t_err:.3e} m "
            f"(tol {REG_T_TOL:g}), scale {s_err:.3e} (tol {REG_S_TOL:g}); card vs host "
            f"{host:.3e} (tol {REG_HOST_TOL:g}); {res['card'][1]:.3f}s on the card, "
            f"{res['host'][1]:.3f}s on the host")
        if rot_err > REG_ROT_TOL or t_err > REG_T_TOL or s_err > REG_S_TOL:
            raise RuntimeError(f"registration of query chunk {c} off the truth")
        if host > REG_HOST_TOL:
            raise RuntimeError(f"registration of query chunk {c}: card vs host {host}")


def pnp_on_card(scene, rng, n_images=100, n_corr=1000, n_new=2000) -> None:
    """(c) 100 query images, each with 1000 keypoints on pooled map tracks
    (their descriptors, 0.5 px noise, 30% displaced by 30-200 px),
    localized by localize_by_descriptors on the card and on the host with
    the same samples; then a planted cloud of the second camera's own points
    triangulated from the localized poses."""
    from pi3_slam_tpu_torch.sfm.localize import (_pool_map_tracks, localize_by_descriptors,
                                                 triangulate_points)

    K, landmarks, desc, recons, q_centers, q_rots = scene
    pool_pts, pool_desc = _pool_map_tracks(recons)
    # one pooled track per landmark: the first, which mutual matching picks
    first = {}
    for j, d in enumerate(pool_desc):
        first.setdefault(d.tobytes(), j)
    uniq = np.array(sorted(first.values()))
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float32)
    frames = np.linspace(20, 380, n_images).astype(int)
    poses = {"card": [], "host": []}
    secs = {"card": [], "host": []}
    for k, i in enumerate(frames):
        vis, uv = visible(K, q_centers[i], q_rots[i], pool_pts[uniq])
        if vis.size < n_corr:
            raise RuntimeError(f"query image {k}: {vis.size} visible pooled tracks")
        pick = rng.choice(vis, n_corr, replace=False)
        kp = uv[pick] + rng.normal(size=(n_corr, 2)) * 0.5
        bad = rng.uniform(size=n_corr) < 0.3
        ang = rng.uniform(0, 2 * np.pi, int(bad.sum()))
        kp[bad] += np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(30, 200, (bad.sum(), 1))
        d = pool_desc[uniq[pick]]
        # the host repeats every fifth image: its matching (host numpy, as
        # on the card's run) takes most of a localization's time
        for where, device in (("card", "cuda"), ("host", "cpu"))[:1 if k % 5 else 2]:
            t = {}
            res = localize_by_descriptors(recons, kp.astype(np.float32), d, intr, seed=k,
                                          map_pool=(pool_pts, pool_desc), device=device,
                                          timings=t)
            if not res.success or res.num_matches != n_corr:
                raise RuntimeError(f"query image {k} on the {where}: {res}")
            poses[where].append(res)
            secs[where].append(t)
    card, host = poses["card"], poses["host"]
    R_est = np.stack([r.rotation for r in card])
    c_est = np.stack([r.center for r in card])
    rot_err = rotation_angle(R_est, np.transpose(q_rots[frames], (0, 2, 1)))
    c_err = np.linalg.norm(c_est - q_centers[frames], axis=1)
    host_rot = rotation_angle(R_est[::5], np.stack([r.rotation for r in host]))
    host_c = np.linalg.norm(c_est[::5] - np.stack([r.center for r in host]), axis=1)
    same = [a.num_inliers == b.num_inliers for a, b in zip(card[::5], host)]
    inl = np.array([r.num_inliers for r in card])
    log(f"    (c) {n_images} images, {n_corr} matches each: inliers {inl.min()}-{inl.max()}; "
        f"against the truth rotation up to {rot_err.max():.3e} rad (tol {PNP_ROT_TOL:g}, median "
        f"{np.median(rot_err):.3e}), center up to {c_err.max():.3e} m (tol {PNP_C_TOL:g}, median "
        f"{np.median(c_err):.3e}); card vs host on every fifth image: "
        f"rotation {host_rot.max():.3e} rad (tol {PNP_HOST_ROT_TOL:g}), center "
        f"{host_c.max():.3e} m (tol {PNP_HOST_C_TOL:g}), the same inlier count in "
        f"{sum(same)}/{len(host)}")
    for where in ("card", "host"):
        med = {key: float(np.median([t[key] for t in secs[where]])) * 1e3
               for key in ("match_s", "ransac_s", "refine_s")}
        log(f"    (c) per image on the {where}, median: match {med['match_s']:.2f} ms (host "
            f"numpy), RANSAC {med['ransac_s']:.2f} ms, refine {med['refine_s']:.2f} ms")
    if rot_err.max() > PNP_ROT_TOL or c_err.max() > PNP_C_TOL:
        raise RuntimeError("PnP on the card: a pose off the truth")
    if host_rot.max() > PNP_HOST_ROT_TOL or host_c.max() > PNP_HOST_C_TOL or not all(same):
        raise RuntimeError("PnP: card and host disagree")

    # the second camera's own points: n_new points beside the corridor, seen
    # with 0.5 px noise by the localized views
    new = np.stack([rng.uniform(-3, 34, n_new), rng.uniform(-2, 2, n_new),
                    rng.uniform(5, 9, n_new)], axis=1)
    obs = np.zeros((n_new, n_images, 2), np.float32)
    val = np.zeros((n_new, n_images), np.float32)
    for k, i in enumerate(frames):
        vis, uv = visible(K, q_centers[i], q_rots[i], new)
        obs[vis, k] = uv[vis] + rng.normal(size=(vis.size, 2)) * 0.5
        val[vis, k] = 1.0
    keep = val.sum(1) >= 2
    obs, val, new = obs[keep], val[keep], new[keep]
    out = {}
    for where, device in (("card", "cuda"), ("host", "cpu")):
        t0 = time.perf_counter()
        pts, rms, n_front = triangulate_points(R_est, c_est, intr, obs, val, device=device)
        out[where] = (pts.cpu().numpy(), rms.cpu().numpy(), n_front.cpu().numpy(),
                      time.perf_counter() - t0)
    pts, rms, n_front, secs_card = out["card"]
    err = np.linalg.norm(pts - new, axis=1)
    # a point seen from two adjacent views (0.29 m apart) at 9 m is only
    # good to decimetres in depth; from ten or more views (2.9 m of baseline
    # and more), to centimetres
    wide = val.sum(1) >= 10
    host = np.abs(pts - out["host"][0]).max()
    log(f"    (c) triangulation of {len(new)} new points over {int(val.sum())} observations "
        f"({int(val.sum(1).mean())} views a point on average): RMS up to {rms.max():.3f} px "
        f"(gate {TRI_GATE_PX:g}); error median {np.median(err):.3e} m (tol {TRI_MEDIAN_TOL:g}), "
        f"up to "
        f"{err[wide].max():.3e} m over the {int(wide.sum())} points seen from ten views or more "
        f"(tol {TRI_TOL:g}), up to {err.max():.3e} m over all; card vs host {host:.3e} m (tol "
        f"{TRI_HOST_TOL:g}); {secs_card * 1e3:.1f} ms on the card, {out['host'][3] * 1e3:.1f} "
        "ms on the host")
    if (rms.max() > TRI_GATE_PX or np.median(err) > TRI_MEDIAN_TOL or err[wide].max() > TRI_TOL
            or wide.sum() < len(new) // 2 or (n_front != val.sum(1)).any()):
        raise RuntimeError("triangulation on the card: a point off the gate or the truth")
    if host > TRI_HOST_TOL:
        raise RuntimeError(f"triangulation: card vs host {host} m")


def enu_to_lla(enu: np.ndarray, origin=(47.37, 8.54, 410.0)) -> np.ndarray:
    """Geodetic fixes of local ENU points, inverting sfm/priors.geodetic_to_enu's
    linearisation about ``origin``."""
    lat0, lon0, alt0 = origin
    s = np.sin(np.radians(lat0))
    rn = WGS84_A / np.sqrt(1.0 - WGS84_E2 * s * s)
    rm = WGS84_A * (1.0 - WGS84_E2) / (1.0 - WGS84_E2 * s * s) ** 1.5
    return np.stack([lat0 + np.degrees(enu[:, 1] / rm),
                     lon0 + np.degrees(enu[:, 0] / (rn * np.cos(np.radians(lat0)))),
                     alt0 + enu[:, 2]], axis=1)


def lla_to_enu(lla: np.ndarray, origin=(47.37, 8.54, 410.0)) -> np.ndarray:
    """The ENU point (about ``origin``) of one geodetic fix, the inverse of
    enu_to_lla."""
    lat0, lon0, alt0 = origin
    s = np.sin(np.radians(lat0))
    rn = WGS84_A / np.sqrt(1.0 - WGS84_E2 * s * s)
    rm = WGS84_A * (1.0 - WGS84_E2) / (1.0 - WGS84_E2 * s * s) ** 1.5
    return np.array([np.radians(lla[1] - lon0) * rn * np.cos(np.radians(lat0)),
                     np.radians(lla[0] - lat0) * rm, lla[2] - alt0])


def parse_colmap(folder: str) -> tuple[int, int, int]:
    """Counts of cameras, images and points of a COLMAP text model; every
    number parses, every quaternion is a unit one and every POINTS2D line
    holds (x, y, id) triples."""
    rows = {}
    for name in ("cameras", "images", "points3D"):
        with open(os.path.join(folder, f"{name}.txt")) as f:
            rows[name] = [line.split() for line in f if not line.startswith("#")]
    heads, points2d = rows["images"][0::2], rows["images"][1::2]
    numbers = ([r[2:] for r in rows["cameras"]] + [h[1:9] for h in heads]
               + [r[1:8] for r in rows["points3D"]] + points2d)
    if not all(np.isfinite(np.asarray(r, np.float64)).all() for r in numbers):
        raise RuntimeError(f"{folder}: a number that does not parse as a finite one")
    q = np.asarray([h[1:5] for h in heads], np.float64)
    if (np.abs(np.linalg.norm(q, axis=1) - 1.0) > 1e-6).any() or any(len(p) % 3 for p in points2d):
        raise RuntimeError(f"{folder}: a quaternion off the unit sphere or a short POINTS2D line")
    return len(rows["cameras"]), len(heads), len(rows["points3D"])


def telemetry_on_card(tmp: str, n_frames: int = 260) -> None:
    """(d) phase 6's eval-scale synthetic chunks (260 frames: chunks of 100,
    overlap 20), frames named by millisecond timestamps, with generic-JSON
    telemetry at 50 Hz: GPS fixes about the true ENU track (sigma 0.5 m) and
    the true camera-frame gravity plus N(0, 0.01). The reconstructor CLI with
    --telemetry --gps-sigma 0.5 --save-colmap on the card, then the host."""
    from scipy.spatial.transform import Rotation

    from pi3_slam_tpu_torch.io.tum import read_tum_trajectory
    from pi3_slam_tpu_torch.reconstruct_offline import reconstruct

    rng = np.random.default_rng(3)
    scene = os.path.join(tmp, "geo")
    t_start = 1_600_000_000.0
    truth = write_synthetic_chunks(
        scene, np.random.default_rng(1), **dict(EVAL_SCALE, n_frames=n_frames),
        frame_name_fn=lambda i: f"{1_600_000_000_000 + 100 * i:013d}.png", sway=GEO_SWAY,
        sway_rate=GEO_SWAY_RATE)
    rots = make_synthetic_sequence(np.random.default_rng(1), n_frames, 5000, 640, 480, 0.08, 0.0007,
                                   GEO_SWAY, GEO_SWAY_RATE)[2]
    ts = np.arange(0.0, 0.1 * n_frames + 0.1, 0.02)
    track = np.stack([np.interp(ts, 0.1 * np.arange(n_frames), truth[:, i]) for i in range(3)], 1)
    nearest = np.clip((ts / 0.1).round().astype(int), 0, n_frames - 1)
    g_cam = np.einsum("nji,j->ni", rots, [0.0, 0.0, -1.0])  # R_wc^T (-z)
    fixes = enu_to_lla(track + rng.normal(size=track.shape) * 0.5)
    measured = g_cam[nearest] + rng.normal(size=(len(ts), 3)) * 0.01
    telemetry = {"gps": np.c_[t_start + ts, fixes], "gravity": np.c_[t_start + ts, measured]}
    path = os.path.join(scene, "telemetry.json")
    with open(path, "w") as f:
        json.dump({k: v.tolist() for k, v in telemetry.items()}, f)
    runs = {}
    for where, device in (("card", "cuda"), ("host", "cpu")):
        argv = ["--chunks", scene, "--output", os.path.join(scene, where),
                "--max-observations-per-track", "10", "--telemetry", path, "--gps-sigma", "0.5",
                "--save-colmap", "--device", device]
        log("    python -m pi3_slam_tpu_torch.reconstruct_offline " + " ".join(argv))
        t0 = time.perf_counter()
        res = reconstruct(argv)
        wall = time.perf_counter() - t0
        stats = res["telemetry"]
        traj = read_tum_trajectory(res["artifacts"]["trajectory"])
        runs[where] = traj
        R_wc = Rotation.from_quat(traj["quaternions_xyzw"]).as_matrix()
        down = np.einsum("nji,j->ni", R_wc, [0.0, 0.0, -1.0])
        grav = np.arccos(np.clip(np.sum(down * g_cam, axis=1), -1.0, 1.0))
        # the true track in the run's ENU frame, whose origin is the first
        # frame's (noisy) GPS fix
        lla0 = np.asarray(stats["origin"])
        enu_origin = lla_to_enu(lla0)
        geo = np.linalg.norm(traj["positions"] - (truth - enu_origin), axis=1)
        n_live = sum(int(r.track_valid.sum()) for r in res["reconstructions"])
        counts = parse_colmap(os.path.join(scene, where, "colmap"))
        log(f"    (d) {where}: {wall:.2f}s; telemetry gps={stats['gps']} "
            f"gravity={stats['gravity']}, {stats['refined_chunks']} chunks refined in {stats['seconds']:.3f}s "
            f"({stats['seconds'] / max(1, stats['refined_chunks']):.3f}s a chunk), GPS fit RMS "
            f"{stats['gps_rms_m']:.3f} m, scale {stats['scale']:.4f}; against the true ENU track "
            f"with no similarity largest {geo.max():.3f} m (tol {GEO_TOL:g}), RMS "
            f"{np.sqrt(np.mean(geo ** 2)):.3f} m; gravity angle up to {grav.max():.3e} rad (tol "
            f"{GRAVITY_TOL:g}); COLMAP {counts[0]} cameras, {counts[1]} images, {counts[2]} "
            f"points ({n_live} live tracks)")
        if not (stats["gps"] and stats["gravity"]) or stats["refined_chunks"] != len(
                res["reconstructions"]):
            raise RuntimeError(f"telemetry on the {where}: {stats}")
        if geo.max() > GEO_TOL or grav.max() > GRAVITY_TOL:
            raise RuntimeError(f"telemetry on the {where}: trajectory {geo.max()} m off the ENU "
                               f"track, gravity {grav.max()} rad")
        if counts != (n_frames, n_frames, n_live):
            raise RuntimeError(f"COLMAP model on the {where}: {counts}, expected "
                               f"{(n_frames, n_frames, n_live)}")
    host = np.linalg.norm(runs["card"]["positions"] - runs["host"]["positions"], axis=1).max()
    log(f"    (d) card vs host with no similarity: largest {host:.3e} m (tol {GEO_HOST_TOL:g}) "
        f"{'ok' if host <= GEO_HOST_TOL else 'FAIL'}")
    if host > GEO_HOST_TOL:
        raise RuntimeError(f"telemetry: a card pose lies {host} m from the host's")


def phase_localization(tmp: str) -> dict:
    """(a) a second camera's chunks through the creator CLI and
    localize_camera --query-chunks against phase 9's offline ALIKED map;
    (b) planted registration, (c) planted PnP and triangulation, card and
    host; (d) the telemetry priors and COLMAP export through the
    reconstructor CLI. Returns (a)'s launch counts."""
    import glob

    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks
    from pi3_slam_tpu_torch.localize_camera import main as localize
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts

    ckpt = os.path.join(tmp, "ckpt")
    seq = os.path.join(tmp, "7scenes", "scene", "seq-01")
    query = os.path.join(tmp, "second_camera")
    argv = ["--images", os.path.join(seq, "*.color.png"), "--skip-start", "15", "--output", query,
            "--model-path", os.path.join(ckpt, "pi3.npz"), "--moge-path",
            os.path.join(ckpt, "moge.npz"), "--chunk-length", "100", "--overlap", "20",
            "--max-kp", "400", "--keypoints", "aliked", "--aliked-path",
            os.path.join(ckpt, "aliked.npz")]
    log("  (a) the second camera: python -m pi3_slam_tpu_torch.create_offline_chunks "
        + " ".join(argv))
    reset_launch_counts()
    records = create_chunks(argv)
    counts = nonzero(launch_counts())
    per_chunk = [nonzero(r["launches"]) for r in records]
    if per_chunk != [PATH_LAUNCHES["metric_depth"]] * 2:
        raise RuntimeError(f"second camera: launches per chunk {per_chunk}")
    log(f"    {len(records)} chunks, seconds {[round(r['infer_s'], 3) for r in records]}; "
        f"launch counts {counts}")
    out = os.path.join(tmp, "localize_register")
    argv = ["--map-chunks", os.path.join(tmp, "appearance_offline", "scene"), "--query-chunks",
            query, "--output", out]
    log("    python -m pi3_slam_tpu_torch.localize_camera " + " ".join(argv))
    t0 = time.perf_counter()
    rc = localize(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "registration_stats.json")) as f:
        stats = json.load(f)
    if rc not in (0, 1) or len(stats) != len(glob.glob(os.path.join(query, "chunks", "*.npz"))):
        raise RuntimeError(f"localize_camera: exit code {rc}, {len(stats)} stats entries")
    log(f"    exit code {rc} in {wall:.2f}s; per chunk (matches, inliers) "
        f"{[(s['num_matches'], s['num_inliers']) for s in stats]} (random weights: printed, not "
        "held)")
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    scene = planted_scene(rng)
    log(f"  (b) planted registration: a map of 4 chunks x 100 frames x 400 tracks, 128-d "
        f"descriptors (built in {time.perf_counter() - t0:.1f}s)")
    registration_on_card(scene, rng)
    log("  (c) planted PnP: 100 query images x 1000 matches, 0.5 px noise, 30% outliers")
    pnp_on_card(scene, rng)
    log("  (d) telemetry: GPS + gravity priors and the COLMAP export, eval-scale chunks")
    telemetry_on_card(tmp)
    return counts


# --- phase 11: dense mapping (mapping/: TSDF fusion, raycast, surface nets,
# the mesh export of both CLIs)
# (b): the planted sphere's surface-nets mesh against the sphere, in voxels
# (tests/test_mapping.py's test_tsdf_sphere_fusion bounds), and its colour
PLANT_MEDIAN_VOXELS, PLANT_P95_VOXELS, PLANT_COLOR_TOL = 1.5, 3.0, 0.05
# (b): the first 20 frames on the card and the host CPU: at most
# FUSE_HOST_SHARE of the voxels may differ by more than FUSE_HOST_DIFF in tsdf.
# The pixel index is round(fx x / z + cx); where u lands within rounding of
# .5 the card's product (another summation order) picks the next pixel. A
# straight transcription on the host measured 6.9e-7 of 1.44M voxels off at
# 24 views of 154x203
FUSE_HOST_DIFF, FUSE_HOST_SHARE = 1e-5, 1e-4
# (b): raycast depth within RAY_VOXELS voxels of the analytic depth on
# RAY_SHARE of the interior rays that hit (the silhouette less its 1-pixel
# rim, where a ray grazes the sphere), as tests/test_mapping.py's raycast
# test restricts them
RAY_VOXELS, RAY_SHARE = 1.0, 0.99
PLANT_FRAMES, PLANT_H, PLANT_W, PLANT_N, PLANT_HOST_FRAMES = 100, 154, 203, 189, 20
PLANT_INTR = np.array([178.0, 178.0, PLANT_W / 2, PLANT_H / 2])
SPHERE_COLOR = np.array([0.3, 0.6, 0.9])
# a frame-at-a-time pass reads and writes the voxel state (tsdf, weight,
# rgb: 20 bytes) once a frame
FUSE_BYTES_PER_VOXEL_FRAME = 40.0


def look_at_origin(center: np.ndarray) -> np.ndarray:
    """World -> camera rotation of a camera at ``center`` looking at the origin
    (tests/test_mapping.py's _look_at_origin)."""
    z = -center / np.linalg.norm(center)
    up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) <= 0.99 else np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def sphere_depth(center, R, intr, h, w, radius=1.0) -> np.ndarray:
    """Exact z-depth of the sphere |p| = radius from a pinhole camera, 0 where
    the ray misses (tests/test_mapping.py's _render_sphere_depth)."""
    fx, fy, cx, cy = intr
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xn, yn = (u - cx) / fx, (v - cy) / fy
    rc = R @ center
    a = xn**2 + yn**2 + 1.0
    b = 2.0 * (xn * rc[0] + yn * rc[1] + rc[2])
    disc = b**2 - 4 * a * (float(center @ center) - radius**2)
    s = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), 0.0)
    return np.where((disc > 0) & (s > 0), s, 0.0)


class Tee:
    """Standard output to the terminal and to a buffer (the online run's
    lines, its live-mesh thread's included)."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def lines(self) -> list:
        return "".join(self.parts).splitlines()


def check_mesh(path: str) -> dict:
    """A mesh PLY that reads back with finite vertices and faces in range."""
    from pi3_slam_tpu_torch.io.mesh import read_mesh_ply

    mesh = read_mesh_ply(path)
    v, f = mesh["vertices"], mesh["faces"]
    if not np.isfinite(v).all() or (f.size and (f.min() < 0 or f.max() >= len(v))):
        raise RuntimeError(f"{path}: vertices not finite or faces out of range")
    return mesh


def mapping_offline(tmp: str) -> dict:
    """(a) the creator CLI with --save-dense, then the reconstructor CLI with
    --export-mesh --save-volume --render-previews 2. Returns the creator
    run's launch counts."""
    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks
    from pi3_slam_tpu_torch.mapping import TSDFVolume
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.reconstruct_offline import reconstruct

    chunks = os.path.join(tmp, "mapping_chunks")
    argv = ["--images", os.path.join(tmp, "frames"), "--output", chunks, "--chunk-length", "100",
            "--overlap", "20", "--max-kp", "400", "--model-path",
            os.path.join(tmp, "ckpt", "pi3.npz"), "--moge-path",
            os.path.join(tmp, "moge_random.npz"), "--save-dense"]
    log("  (a) python -m pi3_slam_tpu_torch.create_offline_chunks " + " ".join(argv))
    reset_launch_counts()
    t0 = time.perf_counter()
    records = create_chunks(argv)
    wall = time.perf_counter() - t0
    counts = nonzero(launch_counts())
    per_chunk = [nonzero(r["launches"]) for r in records]
    if per_chunk != [PATH_LAUNCHES["metric_depth"]] * 2:
        raise RuntimeError(f"--save-dense: launches per chunk {per_chunk}")
    with np.load(os.path.join(chunks, "chunks", "chunk_000000.npz")) as z:
        dense = z["local_points_dense"].shape
    log(f"    2 chunks in {wall:.1f}s, seconds per chunk {[round(r['infer_s'], 3) for r in records]}, "
        f"dense maps {dense}; launch counts {counts}")
    out = os.path.join(tmp, "mapping_recon")
    argv = ["--chunks", chunks, "--output", out, "--export-mesh", "--save-volume",
            "--render-previews", "2"]
    log("    python -m pi3_slam_tpu_torch.reconstruct_offline " + " ".join(argv))
    t0 = time.perf_counter()
    res = reconstruct(argv)
    wall = time.perf_counter() - t0
    check_artifacts(res, 130)
    if "mesh" not in res["artifacts"]:
        raise RuntimeError("the reconstructor wrote no mesh")
    mesh = check_mesh(res["artifacts"]["mesh"])
    vol = TSDFVolume.load(os.path.join(out, "fused_volume.npz"))
    previews = sorted(os.listdir(os.path.join(out, "mesh_previews")))
    if previews != ["depth_000.png", "depth_001.png", "normal_000.png", "normal_001.png"]:
        raise RuntimeError(f"mesh previews {previews}")
    t = res["mesh_timings"]
    log(f"    {wall:.1f}s: volume {vol.shape} at voxel {vol.voxel_size:.4f} ({(vol.weight > 0).mean():.3f} "
        f"observed), mesh {len(mesh['vertices'])} vertices / {len(mesh['faces'])} faces (random "
        f"weights decide the geometry: printed, not held); fusion {t['fuse_s']:.3f}s (chunks "
        f"loaded, fused on the card, pulled), meshing {t['mesh_s']:.3f}s (host: volume saved, "
        f"surface nets, normals, PLY), raycast per 240x320 preview "
        f"{[round(x, 3) for x in t['raycast_s']]}s")
    return counts


def planted_sphere_views():
    """(b)'s scene: PLANT_FRAMES analytic views of the unit sphere at
    PLANT_H x PLANT_W, coloured, with the TSDF config and bounds of a
    PLANT_N^3 grid. Returns (depths, intr, rots, cens, colors, config,
    bounds)."""
    from pi3_slam_tpu_torch.mapping import TSDFConfig

    depths, rots, cens = [], [], []
    for i in range(PLANT_FRAMES):
        ang = 2 * np.pi * i / PLANT_FRAMES
        elev = 0.5 * np.sin(3 * ang)
        c = 3.0 * np.array([np.cos(ang) * np.cos(elev), np.sin(ang) * np.cos(elev), np.sin(elev)])
        R = look_at_origin(c)
        depths.append(sphere_depth(c, R, PLANT_INTR, PLANT_H, PLANT_W))
        rots.append(R)
        cens.append(c)
    depths, rots, cens = np.stack(depths), np.stack(rots), np.stack(cens)
    intr = np.tile(PLANT_INTR, (PLANT_FRAMES, 1))
    colors = np.broadcast_to(SPHERE_COLOR, depths.shape + (3,))
    vs = 2.2 / (PLANT_N - 1.5)  # ceil(2.2 / vs) + 1 = PLANT_N voxels an axis
    return (depths, intr, rots, cens, colors, TSDFConfig(voxel_size=vs),
            (np.full(3, -1.1), np.full(3, 1.1)))


def planted_mapping() -> None:
    """(b) 100 analytic views of the unit sphere at 154x203 fused on the card
    into 189^3 voxels: the mesh against the sphere, a second fusion bit for
    bit, 20 frames card against host, 4 raycasts against the analytic depth."""
    import torch

    from pi3_slam_tpu_torch.mapping import fuse_tsdf, raycast_depth

    depths, intr, rots, cens, colors, cfg, bounds = planted_sphere_views()
    vs = cfg.voxel_size

    def fuse(n, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vol = fuse_tsdf(depths[:n], intr[:n], rots[:n], cens[:n], colors=colors[:n], config=cfg,
                        bounds=bounds, device=device)
        torch.cuda.synchronize()
        return vol, time.perf_counter() - t0

    fuse(10, "cuda")  # warm-up: the first launches of each op
    card, secs = fuse(PLANT_FRAMES, "cuda")
    again, secs2 = fuse(PLANT_FRAMES, "cuda")
    V = int(np.prod(card.shape))
    bound_ms = FUSE_BYTES_PER_VOXEL_FRAME * V * PLANT_FRAMES / PEAK_BYTES * 1e3
    same = all(np.array_equal(getattr(card, k), getattr(again, k)) for k in ("tsdf", "weight",
                                                                            "color"))
    log(f"    (b) {PLANT_FRAMES} views of {PLANT_H}x{PLANT_W} into {card.shape} = {V} voxels "
        f"(voxel {vs:.5f}): fusion {secs:.3f}s and {secs2:.3f}s a chunk on the card "
        f"({PLANT_FRAMES / secs2:.1f} frames/s, {V * PLANT_FRAMES / secs2 / 1e9:.2f} Gvoxel-updates/s) "
        f"beside the bytes bound of a frame-at-a-time pass {bound_ms:.2f} ms "
        f"({FUSE_BYTES_PER_VOXEL_FRAME:.0f} B a voxel and frame over 3.35 TB/s); second run "
        f"bit-identical: {same}")
    if not same:
        raise RuntimeError("two card fusions of the planted sphere differ")
    t0 = time.perf_counter()
    verts, faces, vcols = card.extract_mesh()
    mesh_s = time.perf_counter() - t0
    err = np.abs(np.linalg.norm(verts, axis=1) - 1.0) / vs
    color = np.abs(np.median(vcols, axis=0) - SPHERE_COLOR).max()
    log(f"    (b) surface nets {mesh_s:.2f}s on the host: {len(verts)} vertices, {len(faces)} "
        f"faces; |r - R| median {np.median(err):.3f} voxels (tol {PLANT_MEDIAN_VOXELS:g}), 95th "
        f"percentile {np.percentile(err, 95):.3f} (tol {PLANT_P95_VOXELS:g}); median colour off "
        f"by {color:.2e} (tol {PLANT_COLOR_TOL:g})")
    if (len(faces) < 1000 or np.median(err) >= PLANT_MEDIAN_VOXELS
            or np.percentile(err, 95) >= PLANT_P95_VOXELS or color >= PLANT_COLOR_TOL):
        raise RuntimeError("the planted sphere's mesh is off the sphere")

    n = PLANT_HOST_FRAMES
    card20, card20_s = fuse(n, "cuda")
    t0 = time.perf_counter()
    host20 = fuse_tsdf(depths[:n], intr[:n], rots[:n], cens[:n], colors=colors[:n], config=cfg,
                       bounds=bounds, device="cpu")
    host_s = time.perf_counter() - t0
    diff = np.abs(card20.tsdf - host20.tsdf)
    share = float((diff > FUSE_HOST_DIFF).mean())
    wdiff = float((card20.weight != host20.weight).mean())
    log(f"    (b) the first {n} frames, card vs host CPU: {share:.3e} of the voxels differ by more "
        f"than {FUSE_HOST_DIFF:g} in tsdf (tol {FUSE_HOST_SHARE:g}; {int((diff > FUSE_HOST_DIFF).sum())} "
        f"voxels, largest {diff.max():.3e}), weights differ in {wdiff:.3e}; card {card20_s:.3f}s, "
        f"host {host_s:.2f}s")
    if share > FUSE_HOST_SHARE:
        raise RuntimeError(f"card vs host fusion: {share} of the voxels differ")

    ray_ms, within, agree = [], [], []
    for k in range(4):
        ang = 0.37 + k * np.pi / 2
        c = 3.0 * np.array([np.cos(ang), np.sin(ang), 0.21 * (-1) ** k])
        R = look_at_origin(c)
        raycast_depth(card, PLANT_INTR, R, c, PLANT_H, PLANT_W, device="cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = raycast_depth(card, PLANT_INTR, R, c, PLANT_H, PLANT_W, device="cuda")
        ray_ms.append((time.perf_counter() - t0) * 1e3)
        host = raycast_depth(card, PLANT_INTR, R, c, PLANT_H, PLANT_W, device="cpu")
        gt = sphere_depth(c, R, PLANT_INTR, PLANT_H, PLANT_W)
        hit = gt > 0
        interior = np.zeros_like(hit)
        interior[1:-1, 1:-1] = (hit[1:-1, 1:-1] & hit[:-2, 1:-1] & hit[2:, 1:-1]
                                & hit[1:-1, :-2] & hit[1:-1, 2:])
        rays = interior & out["mask"]
        within.append(float((np.abs(out["depth"] - gt)[rays] < RAY_VOXELS * vs).mean()))
        agree.append(float((out["mask"] == host["mask"]).mean()))
        if rays.sum() < 0.9 * interior.sum():
            raise RuntimeError(f"raycast view {k}: {rays.sum()} of {interior.sum()} interior rays hit")
    log(f"    (b) 4 raycasts of {PLANT_H}x{PLANT_W} on the card: {[round(x, 2) for x in ray_ms]} ms "
        f"a view (normals and the host copy included); depth within {RAY_VOXELS:g} voxel of the "
        f"analytic depth on {[round(x, 5) for x in within]} of the interior rays that hit (tol "
        f"{RAY_SHARE:g}); card and host hit masks agree on {[round(x, 5) for x in agree]}")
    if min(within) < RAY_SHARE:
        raise RuntimeError(f"raycast depth off the sphere: {within}")


def mapping_online(tmp: str, online_wall: float) -> None:
    """(c) the online CLI in process with --export-mesh --save-volume
    --live-mesh-every 1 over phase 4's 130 frames."""
    import threading

    from pi3_slam_tpu_torch.mapping import TSDFVolume
    from pi3_slam_tpu_torch.pi3_slam_online import run_online

    out = os.path.join(tmp, "online_mesh")
    argv = ["--images", os.path.join(tmp, "frames"), "--output", out, "--chunk-length", "100",
            "--overlap", "20", "--max-kp", "400", "--tum-integer-timestamps", "--moge-path",
            os.path.join(tmp, "moge_random.npz"), "--save-tum", "--export-mesh", "--save-volume",
            "--live-mesh-every", "1"]
    log("  (c) python -m pi3_slam_tpu_torch.pi3_slam_online " + " ".join(argv))
    tee, stdout = Tee(sys.stdout), sys.stdout
    sys.stdout = tee
    try:
        t0 = time.perf_counter()
        result = run_online(argv)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in threading.enumerate():
            if t.name == "live-mesh":
                t.join(timeout=300)
        join_s = time.perf_counter() - t0
    finally:
        sys.stdout = stdout
    live = [line for line in tee.lines() if line.startswith("live mesh")]
    check_online_outputs(out, 130)
    if "mesh" not in result["artifacts"]:
        raise RuntimeError("the online CLI wrote no mesh")
    mesh = check_mesh(os.path.join(out, "fused_mesh.ply"))
    vol = TSDFVolume.load(os.path.join(out, "fused_volume.npz"))
    log(f"    CLI wall {wall:.1f}s with the mesh flags vs {online_wall:.1f}s without (phase 7 "
        f"(a)); the live-mesh thread ended {join_s:.1f}s after the CLI returned; volume "
        f"{vol.shape}, mesh {len(mesh['vertices'])} vertices; live refreshes: {live}")
    if not any(line.startswith("live mesh: ") for line in live) or any(
            "refresh failed" in line for line in live):
        raise RuntimeError(f"online live mesh: {live}")


def phase_mapping(tmp: str, online_wall: float) -> dict:
    """(a) offline mesh export, (b) the planted sphere at eval scale, (c)
    online mesh export with the live refresh, (d) the tsdf probe. Returns
    (a)'s creator run's launch counts."""
    from pi3_slam_tpu_torch.tools import perf_lab

    counts = mapping_offline(tmp)
    log("  (b) a planted sphere at eval scale")
    planted_mapping()
    mapping_online(tmp, online_wall)
    log("  (d) python -m pi3_slam_tpu_torch.tools.perf_lab tsdf")
    perf_lab.probe(["tsdf"])
    return counts


# --- phase 12: the last single-device modules: MoGe v1 with its converter,
# the online viewer and the debug projections, the model-shape probes and
# trace_summary

MOGE_V1_T = 2452  # 43 x 57 patches of a 308x406 frame at 2500 tokens + cls
MOGE_V1_LAUNCHES = {"attention_single_pass_packed_fp32": 24, "block_mlp_fp32": 24,
                    **FOCAL_LAUNCHES}
# (a)'s bound, chosen before the first run: the card's fp32 MoGe v1 against
# the host's, relative L2 of the points and the depth inside both masks and
# of the mask score over the frame, each within MOGE_V1_TOL (phase 3's MoGe-2
# bound: 24 fp32 blocks on 3xTF32 products read ~1e-6 there), and the masks
# agreeing on MOGE_V1_MASK_SHARE of the pixels; the same forward with a bf16
# trunk must fail it. The random head's points are mostly its planted
# view-plane pass-through (models/convert.random_moge_v1_state_dict), so the
# trunk is held on its own too: the patch tokens of each backbone layer the
# head reads, within the same MOGE_V1_TOL
MOGE_V1_TOL = 1e-3
MOGE_V1_MASK_SHARE = 0.999
# (b): the debug projections' per-observation errors (px), card against host,
# both fp32 (the reprojection of phase 6's well-posed chunk, ~1e2 px at most)
DEBUG_PX_TOL = 1e-3
PROBE_RUNS = ("all", "mlp-sweep", "refine", "kv-accuracy")  # all: global frame block packed stages mlp forward


def moge_v1_convert(tmp: str) -> str:
    """(c) a random full-width v1 state dict (ViT-L with the 'exp' remap of
    the released v1 checkpoints, the dataclass defaults otherwise, seed 0)
    in the reference naming, written as a model.pt with torch.save in the
    {"model", "model_config"} layout, through the converter tool. Returns
    the .npz path."""
    import torch

    from pi3_slam_tpu_torch.models.convert import random_moge_v1_state_dict
    from pi3_slam_tpu_torch.models.moge_v1 import MoGeV1Config
    from pi3_slam_tpu_torch.tools import convert_checkpoint

    model_config = {"encoder": "dinov2_vitl14", "remap_output": "exp"}
    t0 = time.perf_counter()
    sd = random_moge_v1_state_dict(MoGeV1Config.from_model_config(model_config), 0)
    pt, out = os.path.join(tmp, "moge_v1.pt"), os.path.join(tmp, "moge_v1.npz")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "model_config": model_config}, pt)
    n = sum(v.size for v in sd.values())
    del sd
    log(f"  (c) a random ViT-L v1 state dict ({n / 1e6:.1f}M parameters) written to model.pt in "
        f"{time.perf_counter() - t0:.1f}s; python -m pi3_slam_tpu_torch.tools.convert_checkpoint "
        "--model moge --input moge_v1.pt --output moge_v1.npz")
    tee, stdout = Tee(sys.stdout), sys.stdout
    sys.stdout = tee
    try:
        t0 = time.perf_counter()
        code = convert_checkpoint.main(["--model", "moge", "--input", pt, "--output", out])
    finally:
        sys.stdout = stdout
    log(f"    converted in {time.perf_counter() - t0:.1f}s")
    if code != 0 or "detected MoGe v1 checkpoint layout" not in tee.lines():
        raise RuntimeError(f"the converter tool on a v1 checkpoint: exit {code}, {tee.lines()}")
    os.remove(pt)
    return out


def moge_v1_against_host(npz: str) -> dict:
    """(a) moge_v1_infer at full width on one 308x406 frame on the card (fp32
    trunk), against the host's fp32 path of the same weights, and the bf16
    trunk as the control that the bound must reject. Returns the card run's
    launch counts (set to 0 just before it)."""
    import torch

    from pi3_slam_tpu_torch.models.convert import (
        build_moge_v1, load_moge_v1_checkpoint, moge_v1_state_from_jax)
    from pi3_slam_tpu_torch.models.moge_v1 import (
        moge_v1_forward, moge_v1_infer, moge_v1_postprocess)
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts

    tree, cfg = load_moge_v1_checkpoint(npz)
    state = moge_v1_state_from_jax(tree)
    del tree
    tokens = cfg.num_tokens_range[1]
    image = torch.from_numpy(np.random.default_rng(2).random((1, 3, 308, 406), dtype=np.float32))
    outs, counts = {}, None
    for name, device, trunk in (("card fp32", "cuda", torch.float32),
                                ("card bf16 trunk", "cuda", torch.bfloat16),
                                ("host fp32", "cpu", torch.float32)):
        model = build_moge_v1(cfg, state, torch.device(device), trunk)
        img = image.to(device)
        if name == "card fp32":
            reset_launch_counts()
        layers = []  # the head's input: (patch tokens, class token) of each layer it reads
        hook = model.head.register_forward_pre_hook(
            lambda mod, args: layers.append([t.float().cpu() for t, _ in args[0]]))
        t0 = time.perf_counter()
        with torch.no_grad():
            fwd = moge_v1_forward(model, img, tokens)
            res = moge_v1_postprocess(cfg, fwd)
        outs[name] = {**{k: v.cpu() for k, v in res.items()}, "score": fwd["mask"].cpu(),
                      "layers": layers[0]}
        seconds = time.perf_counter() - t0
        hook.remove()
        if name == "card fp32":
            counts = nonzero(launch_counts())
            with torch.no_grad():
                ms = time_ms(lambda: moge_v1_infer(model, img, tokens), 5)
            log(f"    MoGe v1 ViT-L at {tokens} tokens ({MOGE_V1_T} tokens a block): launches "
                f"{counts}; moge_v1_infer on the card {ms:.3f} ms (fp32 trunk)")
            if counts != MOGE_V1_LAUNCHES:
                raise RuntimeError(f"MoGe v1 launch counts {counts} != {MOGE_V1_LAUNCHES}")
        else:
            log(f"    {name}: forward and infer in {seconds:.1f}s")
        del model
        torch.cuda.empty_cache()
    host = outs["host fp32"]
    mask_share = float(host["mask"].float().mean())
    if not (0.05 < mask_share < 0.95 and torch.isfinite(host["depth"][host["mask"]]).all()):
        raise RuntimeError(f"MoGe v1 on the host: mask share {mask_share}, depth not finite")

    def rel(a, b):
        a, b = a.double(), b.double()
        return ((a - b).norm() / b.norm()).item()

    for name in ("card fp32", "card bf16 trunk"):
        o = outs[name]
        both = o["mask"] & host["mask"]
        got = {"points": rel(o["points"][both], host["points"][both]),
               "depth": rel(o["depth"][both], host["depth"][both]),
               "mask score": rel(o["score"], host["score"]),
               **{f"trunk layer {i}": rel(a, b) for i, a, b in zip(
                   cfg.layer_indices, o["layers"], host["layers"])}}
        agree = float((o["mask"] == host["mask"]).float().mean())
        ok = max(got.values()) <= MOGE_V1_TOL and agree >= MOGE_V1_MASK_SHARE
        log(f"    {name} vs host fp32: rel L2 " + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
            + f" (tol {MOGE_V1_TOL:g}); masks agree on {agree:.6f} (tol {MOGE_V1_MASK_SHARE}); "
            f"intrinsics {o['intrinsics'][0].diagonal().tolist()} vs "
            f"{host['intrinsics'][0].diagonal().tolist()}: "
            + ("within the bound" if ok else "outside the bound on " + ", ".join(
                [k for k, v in got.items() if v > MOGE_V1_TOL]
                + ([] if agree >= MOGE_V1_MASK_SHARE else ["the masks"]))))
        if name == "card fp32" and not ok:
            raise RuntimeError(f"MoGe v1 on the card against the host: {got}, masks {agree}")
        if name != "card fp32" and ok:
            raise RuntimeError("MoGe v1: the bound passes the bf16 trunk's output")
    return counts


def moge_v1_kernels() -> dict:
    """Rows 2 and 4 fp32 at MoGe v1's encoder shapes, (1, 2452, 3072) with
    the encoder's q scale and (1, 2452, 1024) with hidden 4096, against
    their plain versions (ops/compare.FP32; the bf16 entry rejected), NaN
    rows past T = 2452 in the operand maps bit-identical, each beside its
    bound and its library call. Returns {kernel: sub-row}."""
    import torch

    from pi3_slam_tpu_torch.ops.block_mlp import block_mlp, block_mlp_plain
    from pi3_slam_tpu_torch.ops.compare import FP32, block_mlp_bounds
    from pi3_slam_tpu_torch.ops.packed_attention import (
        attention_single_pass_packed, packed_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(12)
    bf16, t, h, c = torch.bfloat16, MOGE_V1_T, 16, 1024
    why = "3xTF32 products, fp32 sums in another order"
    rows = {}

    def row(name, shape, checks, ms, plain_ms, work, library_ms):
        bound_ms, bound_by = bound(*work)
        rows[name] = dict(shape=shape, max_abs_err=max(x.max_abs_err for x in checks), ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
        log(f"  {name:30s} {shape:28s} kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms   bound "
            f"{bound_ms:8.3f} ms ({bound_by})   library {library_ms:9.3f} ms")

    qkv = torch.randn(1, t, 3 * c, generator=g, device="cuda")
    q_scale = 64**-0.5 * 1.4426950408889634  # the encoder's: D^-1/2 log2(e)
    shape = f"(1, {t}, {3 * c}) fp32 q_scale"
    run = lambda: attention_single_pass_packed(qkv, h, q_scale=q_scale)  # noqa: E731
    plain = lambda: packed_attention_plain(qkv, h, q_scale=q_scale)  # noqa: E731
    got = run()
    chk = check_fp32("attention_single_pass_packed_fp32", shape, got, plain(),
                     attention_single_pass_packed(qkv.to(bf16), h, q_scale=q_scale), why, **FP32)
    padded = torch.nn.functional.pad(qkv, (0, 0, 0, 60))
    nan_rows(padded, t)
    same_bits("attention_single_pass_packed_fp32", f"(1, {t + 60}, {3 * c}) true_t={t}, NaN rows",
              attention_single_pass_packed(padded, h, true_t=t, q_scale=q_scale), got)
    same_bits("attention_single_pass_packed_fp32", shape, run(), got, "a second call")
    del padded, got
    q, k, v = qkv.view(1, t, 3, h, 64).unbind(2)
    row("attention_single_pass_packed_fp32", shape, [chk], time_ms(run, 10), time_ms(plain, 3),
        (attention_flops(1, h, t, t, 64), qkv.numel() * 4 + qkv.numel() // 3 * 4, PEAK_3XTF32),
        sdpa_ms(q, k, v, q_scale * math.log(2.0), 10))
    del qkv, q, k, v

    x = torch.randn(1, t, c, generator=g, device="cuda")
    w1, b1 = torch.randn(4 * c, c, generator=g, device="cuda") * 0.02, \
        torch.randn(4 * c, generator=g, device="cuda") * 0.1
    w2, b2 = torch.randn(c, 4 * c, generator=g, device="cuda") * 0.02, \
        torch.randn(c, generator=g, device="cuda") * 0.1
    nw, nb, ls = (1 + 0.1 * torch.randn(c, generator=g, device="cuda"),
                  0.1 * torch.randn(c, generator=g, device="cuda"),
                  1 + 0.1 * torch.randn(c, generator=g, device="cuda"))
    fn = lambda a, *p: block_mlp(a, nw, nb, *p, ls=ls)  # noqa: E731
    run = lambda: fn(x, w1, b1, w2, b2)  # noqa: E731
    plain = lambda: block_mlp_plain(x, nw, nb, w1, b1, w2, b2, ls=ls)  # noqa: E731
    shape = f"(1, {t}, {c})/{4 * c} fp32"
    ref = plain()
    chk = check_fp32("block_mlp_fp32 branch", shape, run(), ref,
                     fn(x.to(bf16), *(p.to(bf16) for p in (w1, b1, w2, b2))), why,
                     **block_mlp_bounds(x, ref))
    gemm_bits("block_mlp_fp32", shape, x, lambda a: fn(a, w1, b1, w2, b2))
    row("block_mlp_fp32", shape, [chk], time_ms(run, 10), time_ms(plain, 5),
        (*mlp_work(x, w1), PEAK_3XTF32), products_ms(shape, x, w1, w2, 10))
    return rows


def viewer_and_debug_projections(tmp: str) -> None:
    """(b) the online CLI with --visualize --save-debug-projections over
    phase 4's first 45 frames (chunks of 20, overlap 5: three chunks, the
    tail padded): one [viz] line a chunk (viser is not installed there: the
    viewer's console lines), and a GIF a chunk or, without matplotlib, the
    JAX package's "debug projections failed" line a chunk; then the
    debug projections' numbers on phase 6's first eval-scale chunk (its
    reconstruction as built, before BA: 100 frames, 200 picked tracks) with
    the errors on the card against the host."""
    import glob
    import importlib.util
    import shutil

    from pi3_slam_tpu_torch.pi3_slam_online import run_online
    from pi3_slam_tpu_torch.sfm.reconstruction import build_chunk_reconstruction
    from pi3_slam_tpu_torch.sfm.serialization import debug_projection_data
    from pi3_slam_tpu_torch.slam.offline_reconstructor import load_chunk_npz

    frames = os.path.join(tmp, "frames45")
    os.makedirs(frames, exist_ok=True)
    for name in sorted(os.listdir(os.path.join(tmp, "frames")))[:45]:
        shutil.copy(os.path.join(tmp, "frames", name), frames)
    out = os.path.join(tmp, "online_viz")
    argv = ["--images", frames, "--output", out, "--chunk-length", "20", "--overlap", "5",
            "--max-kp", "100", "--no-metric-depth", "--tum-integer-timestamps", "--visualize",
            "--save-debug-projections"]
    log("  (b) python -m pi3_slam_tpu_torch.pi3_slam_online " + " ".join(argv))
    tee, stdout = Tee(sys.stdout), sys.stdout
    sys.stdout = tee
    try:
        t0 = time.perf_counter()
        result = run_online(argv)
        wall = time.perf_counter() - t0
    finally:
        sys.stdout = stdout
    n = result["num_chunks"]
    viz = [line for line in tee.lines() if line.startswith("[viz] chunk")]
    failed = [line for line in tee.lines() if line.startswith("debug projections failed")]
    gifs = sorted(os.listdir(os.path.join(out, "debug_projections")))
    log(f"    {n} chunks in {wall:.1f}s; viewer lines: {viz}")
    if len(viz) != n:
        raise RuntimeError(f"{len(viz)} [viz] chunk lines for {n} chunks")
    if importlib.util.find_spec("matplotlib") is None:
        log(f"    matplotlib is not installed here: {len(failed)} x {failed[:1]}, no GIF")
        if len(failed) != n or "matplotlib" not in failed[0] or gifs:
            raise RuntimeError(f"debug projections without matplotlib: {failed}, {gifs}")
    else:
        log(f"    matplotlib is installed: GIFs {gifs}")
        if failed or gifs != [f"chunk_{i:06d}.gif" for i in range(n)]:
            raise RuntimeError(f"debug projections: {failed}, {gifs}")

    chunk = sorted(glob.glob(os.path.join(tmp, "eval", "**", "chunk_*.npz"), recursive=True))[0]
    recon = build_chunk_reconstruction(load_chunk_npz(chunk), run_ba=False, device="cpu")
    t0 = time.perf_counter()
    card = debug_projection_data(recon, recon.num_frames, device="cuda")
    card_s = time.perf_counter() - t0
    host = debug_projection_data(recon, recon.num_frames, device="cpu")
    worst, n_obs, n_finite = 0.0, 0, 0
    for a, b in zip(card, host):
        for key in ("rows", "cols", "observed", "reprojected"):
            if not np.array_equal(a[key], b[key]):
                raise RuntimeError(f"debug projections: {key} differ card vs host")
        fin = np.isfinite(b["errors"])
        if not np.array_equal(np.isfinite(a["errors"]), fin):
            raise RuntimeError("debug projections: finite errors differ card vs host")
        if fin.any():
            worst = max(worst, float(np.abs(a["errors"][fin] - b["errors"][fin]).max()))
        n_obs, n_finite = n_obs + len(fin), n_finite + int(fin.sum())
    picked = len({int(r) for d in card for r in d["rows"]})
    titles = sum(a["title"] == b["title"] for a, b in zip(card, host))
    log(f"    debug projections' numbers on {os.path.basename(chunk)}: {picked} tracks picked, "
        f"{n_obs} observations ({n_finite} finite errors), errors on the card within "
        f"{worst:.3e} px of the host's (tol {DEBUG_PX_TOL:g}), {titles}/{len(card)} titles equal, "
        f"card {card_s:.2f}s")
    if worst > DEBUG_PX_TOL or n_finite == 0:
        raise RuntimeError(f"debug projections card vs host: {worst} px, {n_finite} finite")


def probes_and_trace(tmp: str) -> dict:
    """(d) the model-shape probes through perf_lab's entry point (PROBE_RUNS:
    one process, one built model), then trace_summary on a --profile-dir
    creator run over (b)'s 45 frames. Returns the probes' launch counts (set
    to 0 just before them)."""
    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts
    from pi3_slam_tpu_torch.tools import perf_lab, trace_summary

    reset_launch_counts()
    t0 = time.perf_counter()
    for name in PROBE_RUNS:
        log(f"  (d) python -m pi3_slam_tpu_torch.tools.perf_lab {name}")
        perf_lab.probe([name])
    counts = nonzero(launch_counts())
    log(f"    the probes in {time.perf_counter() - t0:.1f}s; launches {counts}")
    rows = ("flash_attention_packed", "attention_single_pass_packed", "qkv_rope_producer",
            "block_mlp", "flash_attention_partial", "flash_attention", "attention_single_pass",
            "mlp", "block_mlp_fp32", "mlp_fp32")
    if any(not counts.get(r) for r in rows):
        raise RuntimeError(f"the probes launched no {[r for r in rows if not counts.get(r)]}")
    prof = os.path.join(tmp, "profile")
    argv = ["--images", os.path.join(tmp, "frames45"), "--output", os.path.join(tmp, "profiled"),
            "--chunk-length", "20", "--overlap", "5", "--max-kp", "100", "--no-metric-depth",
            "--profile-dir", prof]
    log("  (d) python -m pi3_slam_tpu_torch.create_offline_chunks " + " ".join(argv))
    create_chunks(argv)
    log(f"  (d) python -m pi3_slam_tpu_torch.tools.trace_summary {prof} 15")
    tee, stdout = Tee(sys.stdout), sys.stdout
    sys.stdout = tee
    try:
        trace_summary.main([prof, "15"])
    finally:
        sys.stdout = stdout
    total = next(line for line in tee.lines() if line.startswith("device leaf total:"))
    if float(total.split()[3]) <= 0 or "  kernel" not in "\n".join(tee.lines()):
        raise RuntimeError(f"trace_summary read no device time: {total}")
    return counts


def phase_last_modules(tmp: str) -> tuple[dict, dict]:
    """(c), (a), (b), (d); returns the launch counts of the moge_v1 and probes
    paths and the kernel sub-rows at MoGe v1's shapes."""
    npz = moge_v1_convert(tmp)
    log("  (a) MoGe v1 at full width: the converted checkpoint through moge_v1_infer")
    counts = {"moge_v1": moge_v1_against_host(npz)}
    rows = moge_v1_kernels()
    viewer_and_debug_projections(tmp)
    counts["probes"] = probes_and_trace(tmp)
    return counts, rows


# --- phase 13: the repo-root tools (pi3_slam_tpu_torch/tools) on the card


def launches_since(before: dict) -> dict:
    from pi3_slam_tpu_torch.ops import launch_counts

    return nonzero({k: v - before.get(k, 0) for k, v in launch_counts().items()})


def scaled(counts: dict, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


def perf_pipeline_on_card(tmp: str) -> None:
    """(a) offline, (b) --online on the same workdir: 420 frames in windows of
    100 with overlap 20 are five chunks and a 20-frame tail padded to 100,
    each with the metric-depth path's launches."""
    from pi3_slam_tpu_torch.ops import launch_counts
    from pi3_slam_tpu_torch.tools import perf_pipeline

    argv = ["--workdir", os.path.join(tmp, "perf_pipeline"), "--moge-checkpoint",
            os.path.join(tmp, "moge_random.npz")]
    want = scaled(PATH_LAUNCHES["metric_depth"], 6)
    for label, extra in (("(a)", []), ("(b)", ["--online"])):
        log(f"  {label} python -m pi3_slam_tpu_torch.tools.perf_pipeline " + " ".join(argv + extra))
        before = launch_counts()
        t0 = time.perf_counter()
        res = perf_pipeline.run(argv + extra)
        wall = time.perf_counter() - t0
        counts = launches_since(before)
        log(f"    {label} {wall:.1f}s (frames, model build and run); launches {counts}")
        if counts != want or len(res["per_chunk_fps"]) != 5 or not res["value"] > 0:
            raise RuntimeError(f"perf_pipeline {label}: {res}, launches {counts} (expected {want})")
        if extra and res["num_chunks"] != 6:
            raise RuntimeError(f"perf_pipeline --online: {res['num_chunks']} chunks")
    chunks = os.path.join(tmp, "perf_pipeline", "chunks_out", "chunks")
    frames = []
    for name in sorted(os.listdir(chunks)):
        with np.load(os.path.join(chunks, name)) as z:
            frames.append(z["points"].shape[0])
            if not all(np.isfinite(z[k].astype(np.float64)).all()
                       for k in ("points", "conf", "camera_poses", "intrinsics")):
                raise RuntimeError(f"perf_pipeline: {name} holds values that are not finite")
    if frames != [100] * 5 + [20]:
        raise RuntimeError(f"perf_pipeline: chunks of {frames} frames")


def online_floor_on_card() -> None:
    """(c) the SfM chain's stages alone at eval scale, on the card and on the
    host CPU."""
    from pi3_slam_tpu_torch.tools import perf_online_floor

    res = {}
    for device in ("cuda", "cpu"):
        log(f"  (c) python -m pi3_slam_tpu_torch.tools.perf_online_floor --device {device}")
        t0 = time.perf_counter()
        res[device] = perf_online_floor.run(["--device", device])
        its = res[device]["ba_iterations"]
        log(f"    {time.perf_counter() - t0:.1f}s; BA iterations {its} "
            f"({'all' if its == [10] * 6 else 'not all'} 10)")
        if len(its) != 6 or len(res[device]["align_s_per_chunk"]) != 5:  # five and a tail
            raise RuntimeError(f"perf_online_floor --device {device}: {res[device]}")
    card, host = res["cuda"], res["cpu"]
    log(f"    card against host: steady recon {card['steady_recon_s']} / {host['steady_recon_s']} s, "
        f"align {card['steady_align_s']} / {host['steady_align_s']} s, series ceiling "
        f"{card['fps_ceiling_single_core']} / {host['fps_ceiling_single_core']} frames/s")


def import_on_card(tmp: str) -> None:
    """(d) a reference .pt chunk directory through the importer, then the
    reconstructor CLI on the card."""
    from pi3_slam_tpu_torch.reconstruct_offline import reconstruct
    from pi3_slam_tpu_torch.tools import import_reference_chunks
    from pi3_slam_tpu_torch.tools.synthetic import write_reference_pt_chunks

    src, out = os.path.join(tmp, "reference_pt"), os.path.join(tmp, "imported")
    write_reference_pt_chunks(src)
    log(f"  (d) python -m pi3_slam_tpu_torch.tools.import_reference_chunks {src} {out}")
    if import_reference_chunks.main([src, out]) != 0:
        raise RuntimeError("import_reference_chunks failed")
    argv = ["--chunks", out, "--output", os.path.join(tmp, "imported_recon"), "--ba-iterations", "2"]
    log("    python -m pi3_slam_tpu_torch.reconstruct_offline " + " ".join(argv))
    pos = check_artifacts(reconstruct(argv), 6)
    log(f"    6 finite poses, centres {np.round(pos, 4).tolist()}")


def smoke_on_card(tmp: str) -> None:
    """(e) smoke_e2e at its defaults (ALIKED, the refinement, dense maps, loop
    closure, COLMAP, the mesh), its CLIs in processes of their own; the random
    full-width Pi3 and aliked-n16 files are phase 8's and 9's (the same seed-0
    weights the tool would write)."""
    from pi3_slam_tpu_torch.tools import smoke_e2e

    ckpt = os.path.join(tmp, "ckpt")
    orig = smoke_e2e.save_random_weights
    smoke_e2e.save_random_weights = lambda work, keypoints: (
        os.path.join(ckpt, "pi3.npz"), os.path.join(ckpt, "aliked.npz"))
    argv = ["--workdir", os.path.join(tmp, "smoke")]
    log("  (e) python -m pi3_slam_tpu_torch.tools.smoke_e2e " + " ".join(argv))
    t0 = time.perf_counter()
    try:
        smoke_e2e.main(argv)
    except SystemExit as e:
        raise RuntimeError(f"smoke_e2e failed (exit code {e.code})") from None
    finally:
        smoke_e2e.save_random_weights = orig
    log(f"    {time.perf_counter() - t0:.1f}s")


def kv_drift_on_card() -> None:
    """(f) kv_merge_drift --full --seeds 0 (fp32, 8 and 16 frames of 308x406,
    merge 2 and 4, sharpen 1 and 8), then the floor: the sharpened exact
    forward twice on the same frames."""
    from pi3_slam_tpu_torch.models.convert import init_pi3_params
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config
    from pi3_slam_tpu_torch.ops import launch_counts
    from pi3_slam_tpu_torch.tools import kv_merge_drift as kv

    cfg = Pi3Config()
    tree = init_pi3_params(0, cfg)
    log("  (f) python -m pi3_slam_tpu_torch.tools.kv_merge_drift --full --seeds 0")
    before = launch_counts()
    t0 = time.perf_counter()
    rows = kv.run(["--full", "--seeds", "0"], make_params=lambda seed: tree)
    wall = time.perf_counter() - t0
    counts = launches_since(before)
    # four exact and eight merged fp32 forwards: 2 sharpenings x (8, 16 frames) x (1, 2, 4)
    want = add(scaled(fp32(PI3_LAUNCHES), 4), scaled(fp32(PI3_KV_MERGE_LAUNCHES), 8))
    log(f"    {wall:.1f}s; launches {counts} (expected {want})")
    if len(rows) != 8 or counts != want:
        raise RuntimeError(f"kv_merge_drift: {len(rows)} rows, launches {counts}")
    dead = [r for r in rows if not r["trans_rel"] > 1e-8]
    if dead:  # the JAX test's wiring check: the merge must move the poses
        raise RuntimeError(f"kv_merge_drift: merged runs equal to the exact one: {dead}")
    model = kv.build_model(kv.sharpen_params(tree, 8.0), cfg, "cuda")
    imgs = kv.make_video_frames(np.random.default_rng(1000), 8, 308, 406)
    floor = kv.drift_metrics(kv.forward(model, imgs), kv.forward(model, imgs))
    sharp = [r for r in rows if r["sharpen"] == 8.0]
    log(f"    the floor, an exact run against a second exact run on the card (sharpen 8, 8 "
        f"frames): {floor}; the merged runs at sharpen 8: trans_rel "
        f"{[round(r['trans_rel'], 6) for r in sharp]}, rot_deg {[round(r['rot_deg'], 4) for r in sharp]}")
    del model


def ablate_on_card() -> None:
    """(g) ablate_observation_fan at eval scale, one seed, on the card."""
    from pi3_slam_tpu_torch.tools import ablate_observation_fan

    log("  (g) python -m pi3_slam_tpu_torch.tools.ablate_observation_fan --seeds 0")
    rows = ablate_observation_fan.run(["--seeds", "0"])
    if [r["alignments_ok"] for r in rows] != ["5/5", "5/5"] or not all(
            math.isfinite(r["ape_rmse_m"]) for r in rows):
        raise RuntimeError(f"ablate_observation_fan: {rows}")


def phase_tools(tmp: str) -> dict:
    """(a)-(g); returns the launch counts of the phase (the "tools" path)."""
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    perf_pipeline_on_card(tmp)
    online_floor_on_card()
    import_on_card(tmp)
    smoke_on_card(tmp)
    kv_drift_on_card()
    ablate_on_card()
    counts = nonzero(launch_counts())
    log(f"  phase 13 in {time.perf_counter() - t0:.1f}s; launches {counts}")
    return counts


# --- phase 14: multi-device (pi3_slam_tpu_torch/parallel) over meshes whose
# devices repeat the one card (multi_card_check.py: over distinct cards)

# (b)'s bound on the relative L2 of the sharded forwards' pointmaps,
# confidence and poses against the single-device step's, both bf16. Phase 3
# holds a bf16 forward within 5e-2 of the fp32 one; a tp or sp route is the
# same bf16 forward with its sums in another order (tp: bf16 partials of the
# row-parallel products added in fp32; sp: the ring's fixed-shift partials;
# both: the unpacked attention route, rows 6 / 7 in place of the producer and
# rows 1 / 2), so it is held to that bound too, which also rejects a 10%-off
# output (relative L2 0.1). The control is the single-device unpacked route
# (the sp 2 mesh on one card with the ring switched off: every attention on
# the first device, the block MLP's rows split as on the sp mesh)
SHARD_TOL = 5e-2
# (b)'s bound on the ring's own share, held in fp32 (ring_share): sp 2
# against the control, and tp 2 x sp 2 against tp 2. Each pair differs only
# in the 18 global blocks' attention (the ring's fixed-shift partials in
# place of row 6). In bf16 sp 2 and the control read ~8e-3 apart on an H100
# (sharded_forwards logs it): rounding of bf16 activations in another order,
# amplified over 36 blocks, would hide a faulty ring (key shard 0 at every
# step), which moves the output by ~1e-3. In fp32 over frames 0-19 the pairs
# read at most 1.4e-6 and the faulty ring 9.5e-4 to 1.5e-3 (LayerScale 0.01
# damps what attention adds); 5e-5 sits ~35x above the one and ~20x under
# the other.
RING_TOL = 5e-5
# tp 2: the 57 encoder / frame / head blocks on row 7 and the 18 global blocks
# on row 6, once on each tp shard; the MLP halves are plain products
MULTI_TP2_LAUNCHES = {"attention_single_pass": 114, "flash_attention": 36}
# sp 2: 57 encoder / frame / head blocks on row 7; 18 global blocks of 2 ring
# steps x 2 shards on row 5; the block MLP on each sp row shard where T
# divides (the 18 global blocks, 2 pieces each; T 643 is odd: 1 piece)
MULTI_SP2_LAUNCHES = {"attention_single_pass": 57, "flash_attention_partial": 72, "block_mlp": 93}
# tp 2 x sp 2: each tp shard's 57 row-7 blocks, and its ring in the global
# blocks (4 row-5 launches a shard); the MLP halves plain products
MULTI_TP2_SP2_LAUNCHES = {"attention_single_pass": 114, "flash_attention_partial": 144}


def chunk_inputs(frames: str):
    """Phase 4's two chunk windows of the 130 frames at 308x406 (frames 0-99,
    and 80-129 padded to 100 by repeating the last frame) with 400 grid
    keypoints, as the creator builds them: [(uint8 frames, keypoints)]."""
    from pi3_slam_tpu_torch.data import ChunkDataset, calculate_target_size
    from pi3_slam_tpu_torch.slam.chunk_creator import pad_tail
    from pi3_slam_tpu_torch.utils.keypoints import grid_keypoints

    paths = sorted(glob.glob(os.path.join(frames, "*.png")))
    ds = ChunkDataset(paths, 100, 20, calculate_target_size(paths[0], 255000 // 2))
    out = []
    for i in range(2):
        images = ds[i]["images"]
        kp = grid_keypoints(*images.shape[-2:], 400)
        kps = np.broadcast_to(kp[None], (images.shape[0],) + kp.shape).astype(np.float32)
        out.append(pad_tail(images, kps, 100))
    return out


def sync_all() -> None:
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def wall_ms(fn, iters: int) -> float:
    """Mean host time of fn() over iters calls between synchronisations of
    every card (the time of work spread over several cards; one warm-up)."""
    fn()
    sync_all()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync_all()
    return (time.perf_counter() - t0) / iters * 1e3


# the note on the seconds of a phase 14 run whose mesh repeats one card
ONE_CARD = [""]


def counted(what: str, fn, want: dict) -> dict:
    """fn() with the counts set to 0 just before it; its launch counts must
    equal want. Returns (its result, the counts)."""
    from pi3_slam_tpu_torch.ops import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    counts = nonzero(launch_counts())
    log(f"  {what}: launches {counts} in {time.perf_counter() - t0:.2f}s{ONE_CARD[0]}")
    if counts != want:
        raise RuntimeError(f"{what}: launch counts {counts} != {want}")
    return out, counts


def dp_step_bits(model, inputs, devs) -> dict:
    """(a) two chunks through make_sharded_chunk_step on a dp 2 mesh over
    devs[:2], each output bit for bit the single-device step's on the same
    chunk (on the first card)."""
    import torch

    from pi3_slam_tpu_torch.ops import uncounted
    from pi3_slam_tpu_torch.parallel import make_mesh
    from pi3_slam_tpu_torch.slam.chunk_creator import make_chunk_step, make_sharded_chunk_step

    dev = torch.device("cuda", 0)
    up = [(torch.from_numpy(i).to(dev), torch.from_numpy(k).to(dev)) for i, k in inputs]
    single = make_chunk_step(model, 0.1, 0.03, True)
    with uncounted():
        want = [{k: v.cpu() for k, v in single(i, k).items()} for i, k in up]
    step = make_sharded_chunk_step(model, 0.1, 0.03, True, make_mesh(2, 1, devs[:2]))
    got, counts = counted(f"(a) dp 2 over {devs[:2]}: make_sharded_chunk_step on chunks 0-99 "
                          "and 80-129 (padded)", lambda: step([i for i, _ in up], [k for _, k in up]),
                          scaled(add(PI3_LAUNCHES, FOCAL_LAUNCHES), 2))
    for c in range(2):
        same = all(torch.equal(got[c][k].cpu(), want[c][k]) for k in want[c])
        log(f"  (a) chunk {c}: {len(want[c])} outputs bit-identical to the single-device step: "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise RuntimeError(f"(a) chunk {c}: the dp 2 step differs from the single-device step")
    return counts


def sharded_forwards(model, images, devs) -> dict:
    """(b) the forward over frames 0-99 on dp 1 x tp 2, dp 1 x tp 1 x sp 2
    and dp 1 x tp 2 x sp 2 against the single-device step (packed route), the
    single-device unpacked route as a control, and a 10%-off output
    rejected; over distinct cards each sharded forward's time beside the
    single-device one's."""
    import torch

    import pi3_slam_tpu_torch.parallel.context as context
    from pi3_slam_tpu_torch.ops import uncounted
    from pi3_slam_tpu_torch.ops.compare import compare
    from pi3_slam_tpu_torch.parallel import make_mesh, make_sharded_pi3_step

    dev = torch.device("cuda", 0)
    x = (torch.from_numpy(images).to(dev).float() / 255.0)[None]
    keys = ("points", "local_points", "conf", "camera_poses")
    timed = len(set(devs)) > 1  # forwards over one card time no speed
    with uncounted(), torch.no_grad():
        ref = {k: v.float() for k, v in model(x).items()}
        if timed:
            single_ms = wall_ms(lambda: model(x), 2)
            log(f"  (b) the single-device forward, 100 frames: {single_ms:.1f} ms")

    def held(what, out, against=ref, tol=SHARD_TOL):
        for k in keys:
            c = compare(out[k], against[k], max_rel=float("inf"), l2_rel=tol)
            log(f"  (b) {what:38s} {k:13s} rel L2 {c.rel_l2:.3e} (bound {tol:g}) "
                f"{'ok' if c.ok else 'FAIL'}")
            if not c.ok:
                raise RuntimeError(f"(b) {what} {k}: {c}")

    by = {}
    for name, mesh, want in (("tp 2", make_mesh(1, 2, devs[:2]), MULTI_TP2_LAUNCHES),
                             ("sp 2", make_mesh(1, 1, devs[:2], n_sp=2), MULTI_SP2_LAUNCHES),
                             ("tp 2 x sp 2", make_mesh(1, 2, devs[:4], n_sp=2),
                              MULTI_TP2_SP2_LAUNCHES)):
        step, reps = make_sharded_pi3_step(model, mesh)
        out, by[name] = counted(f"(b) dp 1 x {name} forward over {mesh.size} devices, 100 frames",
                                lambda: step(reps, x), want)
        outs = {k: out[k].float().to(dev) for k in keys}
        held(f"dp 1 x {name} vs single device", outs)
        if name == "sp 2":
            sp2 = outs
        del out, outs
        if timed:
            with uncounted():
                log(f"  (b) dp 1 x {name}: {wall_ms(lambda: step(reps, x), 2):.1f} ms a forward "
                    f"against the single device's {single_ms:.1f} ms")
        del step, reps
    step, reps = make_sharded_pi3_step(model, make_mesh(1, 1, [dev] * 2, n_sp=2))
    threshold = context.LONG_SEQUENCE_THRESHOLD
    context.LONG_SEQUENCE_THRESHOLD = 1 << 30  # the control: no ring
    try:
        with uncounted():
            out = step(reps, x)
    finally:
        context.LONG_SEQUENCE_THRESHOLD = threshold
    held("control: single-device unpacked route", out)
    for k in keys:  # bf16 rounding alone: why ring_share holds the ring in fp32
        log(f"  (b) sp 2 vs the control directly, {k:13s} rel L2 "
            f"{compare(sp2[k], out[k], max_rel=float('inf')).rel_l2:.3e} (read, not held)")
    del out, sp2
    off = compare(ref["points"] * 1.1, ref["points"], max_rel=float("inf"), l2_rel=SHARD_TOL)
    log(f"  (b) a 10%-off pointmap: rel L2 {off.rel_l2:.3e} against {SHARD_TOL:g}: "
        f"{'rejected, ok' if not off.ok else 'PASSES, FAIL'}")
    if off.ok:
        raise RuntimeError("(b) the bound passes a 10%-off output")
    return add(*by.values())


@contextlib.contextmanager
def patched(module, name: str, value):
    """module.name set to value inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def ring_share(model32, images, devs) -> None:
    """(b) the ring's own share, in fp32: the forward over frames 0-19 (T
    12,860, so the global blocks ring) on dp 1 x sp 2 against the control
    (the same mesh with the ring off), and on dp 1 x tp 2 x sp 2 against dp
    1 x tp 2, each within RING_TOL; the same forward with a faulty ring (key
    shard 0 at every step) rejected. In bf16 two routes already sit ~8e-3
    apart, as far as that fault moves the output: only fp32 separates them."""
    import torch

    import pi3_slam_tpu_torch.parallel.context as context
    import pi3_slam_tpu_torch.parallel.ring as ring
    from pi3_slam_tpu_torch.ops import launch_counts, uncounted
    from pi3_slam_tpu_torch.ops.compare import compare
    from pi3_slam_tpu_torch.parallel import make_mesh, make_sharded_pi3_step

    x = (torch.from_numpy(images[:20]).to(devs[0]).float() / 255.0)[None]
    ring_attention = ring.ring_attention
    faulty = lambda q, k, v, n_pad=0: ring_attention(  # noqa: E731
        q, [k[0].to(x.device) for x in q], [v[0].to(x.device) for x in q], n_pad)
    meshes = {"sp 2": make_mesh(1, 1, devs[:2], n_sp=2), "tp 2": make_mesh(1, 2, devs[:2]),
              "tp 2 x sp 2": make_mesh(1, 2, devs[:4], n_sp=2)}
    outs = {}
    for name, mesh, patch in (("sp 2", "sp 2", None), ("tp 2", "tp 2", None),
                              ("tp 2 x sp 2", "tp 2 x sp 2", None),
                              ("control", "sp 2", (context, "LONG_SEQUENCE_THRESHOLD", 1 << 30)),
                              ("faulty ring", "sp 2", (ring, "ring_attention", faulty))):
        step, reps = make_sharded_pi3_step(model32, meshes[mesh])
        with patched(*patch) if patch else contextlib.nullcontext(), uncounted(), torch.no_grad():
            rings = launch_counts()["flash_attention_partial_fp32"]
            out = step(reps, x)
            rings = launch_counts()["flash_attention_partial_fp32"] - rings
        want = 0 if "sp" not in mesh or name == "control" else 4 * 18 * (2 if "tp" in mesh else 1)
        if rings != want:
            raise RuntimeError(f"(b) fp32 {name}: {rings} row-5 fp32 launches, not {want}")
        outs[name] = {k: out[k].to(devs[0]) for k in ("points", "local_points", "conf",
                                                      "camera_poses")}
        del out, step, reps
    for a, b in (("sp 2", "control"), ("tp 2 x sp 2", "tp 2"), ("faulty ring", "control")):
        held = []
        for k, got in outs[a].items():
            c = compare(got, outs[b][k], max_rel=float("inf"), l2_rel=RING_TOL)
            held.append(c.ok)
            log(f"  (b) fp32, 20 frames: {a:11s} vs {b:7s} {k:13s} rel L2 {c.rel_l2:.3e} (bound "
                f"{RING_TOL:g}) {'within' if c.ok else 'outside'}")
        if all(held) != (a != "faulty ring"):
            raise RuntimeError(f"(b) fp32 {a} vs {b}: " + ("the bound passes a faulty ring"
                                                            if all(held) else "outside RING_TOL"))


def ring_and_shard_kernels(devs) -> dict:
    """(c) ring attention alone at (1, 64300, 16, 64), sp 2 and sp 4 over
    devs, against row 6's flash kernel on the same q, k, v, and with its last
    tenth zero-padded keys taken out by their count against row 6 over the
    real keys (the same ring leaving them in must be rejected), with the
    time of one ring step's row-5 launch beside its bound; rows 6 and 7 at the tp 2
    shards' shapes against their plain versions, beside their bounds and
    SDPA. Returns {kernel: sub-row} (uncounted: these are comparisons)."""
    import torch

    from pi3_slam_tpu_torch.ops import uncounted
    from pi3_slam_tpu_torch.ops.compare import ATTENTION, PARTIAL_L, compare
    from pi3_slam_tpu_torch.ops.flash_attention import (
        attention_single_pass, blockwise_attention, flash_attention)
    from pi3_slam_tpu_torch.ops.partial_attention import (
        flash_attention_partial, partial_attention_plain)
    from pi3_slam_tpu_torch.parallel.ring import ring_attention

    g = torch.Generator(device="cuda").manual_seed(14)
    bf16, t, h = torch.bfloat16, N_FRAMES * FRAME_T, 16
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(bf16)

    def row(name, shape, checks, ms, plain_ms, work, library_ms):
        bound_ms, bound_by = bound(*work)
        rows.setdefault(name, {})[shape] = dict(
            max_abs_err=max(c.max_abs_err for c in checks), ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        lib = "" if library_ms is None else f"   SDPA {library_ms:9.3f} ms"
        log(f"  {name:30s} {shape:36s} kernel {ms:9.3f} ms   plain {plain_ms:9.3f} ms   "
            f"bound {bound_ms:8.3f} ms ({bound_by}){lib}")

    with uncounted():
        q, k, v = randn(1, t, h, 64), randn(1, t, h, 64), randn(1, t, h, 64)
        flash = flash_attention(q, k, v)
        flash_ms = time_ms(lambda: flash_attention(q, k, v), 3)
        log(f"  (c) row 6 flash_attention (1, {t}, 16, 64): {flash_ms:.3f} ms, the ring's yardstick")
        n_pad = t // 10  # a share of pads that an uncorrected ring shows
        padded = [torch.cat([x[:, : t - n_pad], torch.zeros_like(x[:, t - n_pad :])], dim=1)
                  for x in (q, k, v)]
        flash_real = flash_attention(*(x[:, : t - n_pad].contiguous() for x in padded))
        for sp in (2, 4):
            ts = t // sp
            shards = [[x[:, s * ts : (s + 1) * ts].to(devs[s]) for s in range(sp)]
                      for x in (q, k, v)]
            out = torch.cat([o.to(flash.device) for o in ring_attention(*shards)], dim=1)
            c = check(f"ring sp {sp}", f"(1, {t}, 16, 64)", out, flash, "vs row 6, bf16 P",
                      **ATTENTION)
            ring_ms = wall_ms(lambda: ring_attention(*shards), 2)
            pads = [[x[:, s * ts : (s + 1) * ts].to(devs[s]) for s in range(sp)] for x in padded]

            def real(n):
                return torch.cat([o.to(flash.device) for o in ring_attention(*pads, n_pad=n)],
                                 dim=1)[:, : t - n_pad]

            c_pad = check(f"ring sp {sp}, {n_pad} padded keys", f"(1, {t - n_pad}, 16, 64)",
                          real(n_pad), flash_real, "vs row 6 over the real keys, bf16 P",
                          **ATTENTION)
            kept = compare(real(0), flash_real, **ATTENTION)
            log(f"  (c) ring sp {sp} leaving its {n_pad} pads in: rel L2 {kept.rel_l2:.3e}: "
                f"{'rejected, ok' if not kept.ok else 'PASSES, FAIL'}")
            if kept.ok:
                raise RuntimeError(f"(c) ring sp {sp}: the bound passes a ring that keeps its pads")
            qs, ks, vs = q[:, :ts], k[:, ts : 2 * ts], v[:, ts : 2 * ts]
            kn = k.float().square().sum(-1).amax(1).sqrt()
            (acc, l), (acc_ref, l_ref) = (flash_attention_partial(qs, ks, vs, kn),
                                          partial_attention_plain(qs, ks, vs, kn))
            checks = [c, c_pad, check("flash_attention_partial ring step acc", f"sp {sp}", acc, acc_ref,
                               "bf16 P", **ATTENTION),
                      check("flash_attention_partial ring step l", f"sp {sp}", l, l_ref,
                            "fp32 sums", **PARTIAL_L)]
            step_ms = time_ms(lambda: flash_attention_partial(qs, ks, vs, kn), 5)
            plain_ms = time_ms(lambda: partial_attention_plain(qs, ks, vs, kn), 1)
            work = (attention_flops(1, h, ts, ts, 64),
                    (qs.numel() + ks.numel() + vs.numel()) * 2 + qs.numel() * 4 + ts * h * 4)
            row("flash_attention_partial", f"ring step sp {sp}: (1, {ts}, 16, 64) x {ts} keys",
                checks, step_ms, plain_ms, work, None)
            log(f"  (c) ring sp {sp} over {devs[:sp]}: {sp * sp} row-5 launches, {ring_ms:.3f} ms "
                f"the whole ring against row 6's {flash_ms:.3f} ms on one card{ONE_CARD[0]}")
            del out, acc, l, acc_ref, l_ref, shards, pads
        del q, k, v, flash, padded, flash_real
        for name, fn, shape in (("flash_attention", flash_attention, (1, t, 8, 64)),
                                ("attention_single_pass", attention_single_pass,
                                 (N_FRAMES, FRAME_T, 8, 64))):
            q, k, v = randn(*shape), randn(*shape), randn(*shape)
            got = fn(q, k, v)
            c = check(name, f"tp 2 shard {shape}", got, blockwise_attention(q, k, v), "bf16 P",
                      **ATTENTION)
            b, tt, hh, d = shape
            row(name, f"tp 2 shard {shape}", [c], time_ms(lambda: fn(q, k, v), 5),
                time_ms(lambda: blockwise_attention(q, k, v), 1),
                (attention_flops(b, hh, tt, tt, d), 4 * q.numel() * 2),
                sdpa_ms(q, k, v, d**-0.5, 5))
            del q, k, v, got
    return rows


def creator_and_online(tmp: str, devs) -> dict:
    """(d) the creator API with data_parallel_chunks=2 and MoGe-2 on devs[:2]
    over phase 4's 130 frames, its chunks bit for bit phase 4's
    single-device chunks; (e) the online API with dp 2 over the same frames,
    SfM on the card."""
    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks
    from pi3_slam_tpu_torch.slam.config import OnlineConfig
    from pi3_slam_tpu_torch.slam.online import Pi3SLAMOnline

    devices = devs[:2]
    frames, moge = os.path.join(tmp, "frames"), os.path.join(tmp, "moge_random.npz")
    out = os.path.join(tmp, "multi_dp2")
    argv = ["--images", frames, "--output", out, "--chunk-length", "100", "--overlap", "20",
            "--max-kp", "400", "--moge-path", moge, "--data-parallel-chunks", "2"]
    log("  (d) create_chunks(" + " ".join(argv) + f", devices={devices})")
    per_chunk = PATH_LAUNCHES["metric_depth"]
    records, counts_d = counted("(d) creator, one dp 2 group of 2 chunks (its Pi3 build included)",
                                lambda: create_chunks(argv, devices=devices),
                                {k: 2 * v for k, v in per_chunk.items()})
    log(f"  (d) the group's records: infer_s {[r['infer_s'] for r in records]}{ONE_CARD[0]}")
    if [r.get("dp_group") for r in records] != [0, 0] or nonzero(records[1]["launches"]):
        raise RuntimeError(f"(d) records {records}")
    for name in sorted(os.listdir(os.path.join(out, "chunks"))):
        with np.load(os.path.join(out, "chunks", name)) as a, \
                np.load(os.path.join(tmp, "metric", "chunks", name)) as b:
            if a.files != b.files or not all(np.array_equal(a[k], b[k]) for k in a.files):
                raise RuntimeError(f"(d) {name} differs from phase 4's single-device chunk")
        log(f"  (d) {name}: {len(b.files)} keys, bit-identical to phase 4's chunk: ok")

    cfg = OnlineConfig(chunk_length=100, overlap=20, max_keypoints=400, moge_checkpoint_path=moge,
                       data_parallel_chunks=2, output_dir=os.path.join(tmp, "multi_online"))
    paths = sorted(glob.glob(os.path.join(frames, "*.png")))

    def run():
        slam = Pi3SLAMOnline(cfg, devices=devices)
        return slam, slam.process_image_paths(paths)

    (slam, result), counts_e = counted("(e) online, dp 2, SfM on the card (its Pi3 build included)",
                                       run, {k: 2 * v for k, v in per_chunk.items()})
    status = slam.queue_status()
    centers = slam._merged_trajectory()[0]
    log(f"  (e) {result}; queue {({k: v for k, v in status.items() if k != 'timing'})}; "
        f"{len(centers)} poses")
    if (result["num_chunks"], status["chunks_consumed"], status["data_parallel_chunks"]) != (2, 2, 2) \
            or len(centers) != 130 or not np.isfinite(centers).all():
        raise RuntimeError("(e) the online dp 2 run")
    return add(counts_d, counts_e)


def sharded_fusion(devs) -> None:
    """(f) phase 11's planted sphere fused with mesh= over dp 4 on devs[:4],
    bit for bit the single-device fusion."""
    from pi3_slam_tpu_torch.mapping import fuse_tsdf
    from pi3_slam_tpu_torch.parallel import make_mesh

    depths, intr, rots, cens, colors, cfg, bounds = planted_sphere_views()
    vols = {}
    for name, mesh in (("single", None), ("dp 4", make_mesh(4, 1, devs[:4]))):
        sync_all()
        t0 = time.perf_counter()
        vols[name] = fuse_tsdf(depths, intr, rots, cens, colors=colors, config=cfg, bounds=bounds,
                               mesh=mesh, device="cuda")
        vols[name].tsdf  # the pull
        log(f"  (f) {name}: {PLANT_FRAMES} views into {vols[name].shape} in "
            f"{time.perf_counter() - t0:.3f}s")
    same = all(np.array_equal(getattr(vols["single"], k), getattr(vols["dp 4"], k))
               for k in ("tsdf", "weight", "color"))
    log(f"  (f) fuse_tsdf(mesh=) over dp 4 on {devs[:4]} bit-identical to single-device fusion: "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise RuntimeError("(f) the voxel-sharded fusion differs from single-device fusion")


def phase_multidevice(tmp: str, devs) -> tuple[dict, dict]:
    """Phase 14 over the four devices devs (cuda:0 four times, or four
    cards). Returns (the path's launch counts, {kernel: sub-rows})."""
    import torch

    from pi3_slam_tpu_torch.models.convert import build_pi3, init_pi3_params, pi3_state_from_jax
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config

    t0 = time.perf_counter()
    state = pi3_state_from_jax(init_pi3_params(0, Pi3Config()))
    model = build_pi3(Pi3Config(), state, torch.device("cuda", 0), torch.bfloat16)
    ONE_CARD[0] = " (every replica on one card: not a speed figure)" if len(set(devs)) == 1 else ""
    log(f"  random full-width Pi3 (seed 0, bf16) in {time.perf_counter() - t0:.1f}s; mesh "
        f"devices {[str(d) for d in devs]}")
    inputs = chunk_inputs(os.path.join(tmp, "frames"))
    counts = dp_step_bits(model, inputs, devs)
    counts = add(counts, sharded_forwards(model, inputs[0][0], devs))
    del model
    model = build_pi3(Pi3Config(), state, torch.device("cuda", 0), torch.float32)
    del state
    ring_share(model, inputs[0][0], devs)
    del model
    torch.cuda.empty_cache()
    rows = ring_and_shard_kernels(devs)
    counts = add(counts, creator_and_online(tmp, devs))
    sharded_fusion(devs)
    return counts, rows


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

    def stamp(msg: str) -> None:  # a phase's header with the script's seconds so far
        log(f"{msg}  [t={time.perf_counter() - t0:.1f}s]")

    stamp("[1] build")
    phase_build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f}s")
    stamp("[2] kernels vs plain, bf16 and the fp32 entries, main-path shapes")
    results = phase_kernels()
    stamp("[3] full-width forwards: Pi3 (4 frames, exact and kv-merge 2, bf16 and fp32), MoGe-2 "
        "(1 frame, fp32), "
        "the cross-attention block (1 and 4 frames), Blocks at head dim 128 and C 320")
    by_path = phase_model()
    by_path.update(phase_blocks())
    with tempfile.TemporaryDirectory() as tmp:
        stamp("[4] main paths: port CLI over 130 frames, with metric depth, with kv-merge 2 and "
            "with --compute-dtype float32")
        by_path.update(phase_cli(tmp))
        stamp("[5] sol: the speed-of-light probe (python -m pi3_slam_tpu_torch.tools.perf_lab sol)")
        by_path["sol"] = phase_sol()
        stamp("[6] reconstruct: the port's reconstructor CLI on the card")
        phase_reconstruct(tmp)
        stamp("[7] online: the port's online CLI, its drive modes, SfM on the card and the host")
        by_path["online"], online_wall = phase_online(tmp)
        stamp("[8] eval: the checkpoint converters and the 7-Scenes / EuRoC eval tool")
        by_path["eval"] = phase_eval(tmp)
        stamp("[9] appearance: ALIKED and its converter, ZNCC refinement, loop closure")
        by_path["appearance"] = phase_appearance(tmp)
        stamp("[10] localization and telemetry: the second camera, georeferencing, COLMAP export")
        by_path["localization"] = phase_localization(tmp)
        stamp("[11] mapping: TSDF fusion, raycast, surface nets and mesh export")
        by_path["mapping"] = phase_mapping(tmp, online_wall)
        stamp("[12] the last single-device modules: MoGe v1 and its converter, the viewer and the "
            "debug projections, the model-shape probes and trace_summary")
        paths12, moge_v1_rows = phase_last_modules(tmp)
        by_path.update(paths12)
        stamp("[13] the repo-root tools: perf_pipeline (offline and --online), perf_online_floor, "
            "import_reference_chunks, smoke_e2e, kv_merge_drift and ablate_observation_fan")
        by_path["tools"] = phase_tools(tmp)
        stamp("[14] multi-device: the dp x tp x sp mesh over [cuda:0] * n, ring attention, the "
              "creator's and the online driver's dp groups, MoGe-2's batch, sharded TSDF fusion")
        by_path["multidevice"], multi_rows = phase_multidevice(tmp, [torch.device("cuda", 0)] * 4)
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        launches = {path: counts.get(name, 0) for path, counts in by_path.items()}
        if not sum(launches.values()):
            raise RuntimeError(f"{name}: no launch on any path ({launches})")
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": sum(launches.values()), "launches_by_path": launches,
                        "max_abs_err": r["max_abs_err"], "rel_l2": r["rel_l2"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], **({"routes": r["routes"]} if r["routes"] else {}),
                        **({"products_ms": r["products_ms"]} if "products_ms" in r else {}),
                        **({"tb_per_s": r["tb_per_s"]} if "tb_per_s" in r else {}),
                        **({"plain_host_ms": r["plain_host_ms"]} if "plain_host_ms" in r else {}),
                        **({"loop": LOOPS[name]} if name in LOOPS else {}),
                        **({"moge_v1": moge_v1_rows[name]} if name in moge_v1_rows else {}),
                        **({"multidevice_shapes": multi_rows[name]} if name in multi_rows else {})})
    stamp("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
