"""Online (streaming) SLAM: chunked inference with incremental alignment.

Port of ``pi3_slam_tpu/slam/online.py`` (``Pi3SLAMOnline``):

* each chunk's step (the Pi3 forward, masks, intrinsics, keypoint sampling)
  and MoGe-2 on its first frame are enqueued on the device and stay in
  flight while the host consumes the previous chunk; the device-to-host
  pull at consume time is the synchronisation point;
* consuming a chunk is two stages: build (pull, metric scale, dense stash,
  chunk reconstruction with its BA; independent of every other chunk) and
  finish (Sim3 alignment against the previous chunk, append; strictly in
  order);
* with ``async_sfm`` the whole SfM chain runs off the drive thread: finish
  on an ``sfm-consumer`` thread fed by a bounded in-order queue, build one
  chunk ahead on a one-worker ``sfm-build`` executor, so the steady chunk
  period is max(forward + pull, build, finish) rather than their sum;
* BA and the Sim3 fits run on the model's device by default
  (``sfm_backend``). On the card each consumer thread enqueues its work on a
  CUDA stream of its own, at high priority, so a chunk's BA is not ordered
  behind the next chunk's forward in one stream; the consumer's stream
  waits on an event recorded after the chunk's step. (The GPU does not
  preempt the forward's running blocks, so beside a forward BA's chain of
  small kernels still takes about the forward's length: PERF.md §6, PR 15.)

With ``keypoint_type='aliked'`` ALIKED runs on the device at dispatch, before
the step, and the chunk carries ``keypoint_valid`` and descriptors; with
``refine_observations`` the step returns the ZNCC-refined observation fan
(``slam/chunk_creator.py``), which the chunk reconstruction uses; and
``apply_loop_closure`` closes loops over the chain after processing
(``sfm/loops.py``, on the SfM device), and ``apply_telemetry`` then
georeferences and refines it with gravity and GPS priors (``sfm/priors.py``).

Dense mapping (``mapping/``): with ``save_dense``, ``export_mesh`` or
``live_mesh_every`` each chunk stashes its strided dense maps under
``<output>/dense/``; ``export_mesh`` fuses them on the device under the final
poses (after loop closure and telemetry) into ``fused_mesh.ply``; every
``live_mesh_every``-th chunk a daemon thread re-fuses the stashes on the host
CPU under the current poses (128^3 voxels at most, printing ``live mesh: N
verts``), so that the preview never contends with the forward on the card.

With ``visualize`` each chunk, once in the chain, goes to the online viewer
(``viz/visualizer.py``: a viser scene, or one ``[viz]`` line a chunk without
viser) with its last frame and that frame's keypoints, and the live and final
meshes follow it; with ``save_debug_projections`` each chunk writes a GIF of
its observations against their reprojections under
``<output>/debug_projections/`` (``sfm/serialization.py``; the errors on the
SfM device). The frame and keypoints the viewer gets are host arrays (the
loader's batch and the detector's host copy), so the consumer thread reads
no device tensor for it. A failure of either is printed and skipped.

On a device mesh (``data_parallel_chunks``, ``tensor_parallel``,
``sequence_parallel``; ``parallel/``, as the offline creator sets it up) the
step is ``chunk_creator.make_sharded_chunk_step``. With dp > 1 the drive
thread takes the chunks dp at a time (:meth:`Pi3SLAMOnline._dispatch_group`,
the group padded to dp by repeating its last chunk, one chunk on each dp
replica's device, MoGe-2 on each first frame there) and pulls a group
(:meth:`Pi3SLAMOnline._finish_group`) one group behind, so group k + 1
computes while group k is consumed; the group's chunks are then consumed in
order as single chunks are.

An error in the consumer stops it and reaches the caller from the drive
thread; no chunk is consumed twice. The JAX class's backend-reset recovery
(and the redo of a group after ``UNAVAILABLE`` / ``crashed``) is not ported:
a CUDA fault is sticky to its context.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import ChunkDataset, PrefetchLoader, calculate_target_size
from ..data.undistortion import create_undistorter
from ..device import select_device
from ..io.npz import save_npz
from ..io.ply import write_ply
from ..io.tum import write_tum_trajectory
from ..models.pi3 import Pi3Config
from ..ops import launch_counts
from ..parallel import mesh_devices
from ..sfm.alignment import align_chunks
from ..sfm.reconstruction import ChunkReconstruction, build_chunk_reconstruction
from ..sfm.serialization import render_debug_projections, save_reconstruction
from ..utils.timing import TimingStats
from .chunk_creator import (
    _store_dense_maps,
    group_compatible,
    host_outputs,
    load_models,
    make_chunk_step,
    make_keypoint_extractor,
    make_sharded_chunk_step,
    metric_scale,
    prepare_chunk,
    refine_settings,
    setup_mesh,
    slice_tail,
)
from .config import OnlineConfig


def _host(x):
    """A step output on the host (already there when the dispatch pulled it)."""
    if x is None or isinstance(x, np.ndarray):
        return x
    return x.cpu().numpy()  # blocking: the device tensor can be dropped after it


def _load_npz(path: str) -> Dict:
    with np.load(path) as z:
        return dict(z)


_DONE = object()


class Pi3SLAMOnline:
    def __init__(self, config: OnlineConfig, pi3_config: Pi3Config | None = None,
                 devices: list | None = None):
        """``devices``: the device list a mesh is laid over (None: every
        visible card on ``cuda``, the one device on ``cpu``); used only when
        the config asks for dp, tp or sp above 1."""
        if config.sfm_backend not in ("auto", "default", "cpu"):
            raise ValueError(f"sfm_backend {config.sfm_backend!r}: use 'auto', 'default' or 'cpu'")
        self.config = config
        self.device = select_device(config.device)
        self.model, self.pi3_config, self.moge = load_models(config, pi3_config, self.device)
        # 'auto' and 'default': the model's device ('cpu' is the host mode)
        self.sfm_device = torch.device("cpu") if config.sfm_backend == "cpu" else self.device
        self.undistorter = create_undistorter(config.cam_dist_path) if config.cam_dist_path else None
        self.keypoint_extractor = make_keypoint_extractor(config, self.device)
        self.mesh = setup_mesh(config, mesh_devices(self.device) if devices is None else devices,
                               "online device mesh")
        if self.mesh is not None and self.moge is not None:
            self.moge.shard_params(self.mesh)
        self._make_steps()
        self.reconstructions: List[ChunkReconstruction] = []
        self.alignment_results = []
        self.timing = TimingStats()
        # kernel launches of each dispatched chunk's step and MoGe, by wrapper
        self.chunk_launches: List[Dict[str, int]] = []
        self._produced = 0
        self._consumed = 0
        self._live_mesh_thread: Optional[threading.Thread] = None
        self.visualizer = None
        if config.visualize:
            from ..viz.visualizer import OnlineVisualizer

            self.visualizer = OnlineVisualizer(port=config.viz_port)

    def _make_steps(self) -> None:
        """The chunk step: the single-device one, or on a mesh the sharded
        step (``_group_step``) with ``step`` running one chunk through it."""
        cfg = self.config
        kw = dict(conf_threshold=cfg.conf_threshold, edge_rtol=cfg.depth_edge_rtol,
                  estimate_intrinsics=cfg.estimate_camera_params, return_dense=self._dense_on(),
                  dense_stride=cfg.dense_stride, refine_obs=refine_settings(cfg))
        self._group_step = None
        if self.mesh is None:
            self.step = make_chunk_step(self.model, **kw)
            return
        self._group_step = make_sharded_chunk_step(self.model, mesh=self.mesh, **kw)
        self.step = self._group_step.one

    def _dense_on(self) -> bool:
        """Whether chunks stash their dense maps (mesh export needs them)."""
        cfg = self.config
        return cfg.save_dense or cfg.export_mesh or cfg.live_mesh_every > 0

    # ----- per-chunk stages -----

    def _dispatch_device(self, batch: Dict) -> Dict:
        """Enqueue the chunk step and MoGe-2 behind it on the device. With
        ``overlap_device_host`` the outputs stay device tensors (the forward
        in flight while the host consumes the previous chunk) and an event
        marks their end; without it they are pulled here."""
        launches0 = launch_counts()
        with self.timing.track("dispatch", chunk=batch["chunk_idx"]):
            prep = prepare_chunk(self.config, self.keypoint_extractor, self.device,
                                 batch["images"], self.device)
            dev = self.step(prep["imgs"], prep["kps_dev"], prep["cand"])
            # the first frame is sliced from the uploaded chunk
            moge_depth = (self.moge.infer_depth_async(prep["imgs"][0])
                          if self.moge is not None else None)
            ready = None
            if not self.config.overlap_device_host:
                dev = host_outputs(dev)
                moge_depth = _host(moge_depth)
            elif self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record()
        self.chunk_launches.append({k: v - launches0[k] for k, v in launch_counts().items()})
        self._produced += 1
        return {"dev": dev, "moge_depth": moge_depth, "ready": ready, "kps": prep["kps"],
                "det": prep["det"], "batch": batch}

    def _dispatch_group(self, group: List[Dict], dp: int) -> Dict:
        """Enqueue one dp group: ``group`` padded to dp by repeating its last
        chunk, each chunk uploaded to its replica's device, the sharded step,
        and MoGe-2 on the first frames behind it. The group's kernel launches
        are recorded on its first chunk (its other chunks record none)."""
        n_real = len(group)
        padded = group + [group[-1]] * (dp - n_real)
        launches0 = launch_counts()
        with self.timing.track("dispatch", chunk=tuple(b["chunk_idx"] for b in group)):
            preps = [prepare_chunk(self.config, self.keypoint_extractor, self.device,
                                   b["images"], self._group_step.device_of(i, dp))
                     for i, b in enumerate(padded)]
            cand = None if preps[0]["cand"] is None else [p["cand"] for p in preps]
            devs = self._group_step([p["imgs"] for p in preps], [p["kps_dev"] for p in preps],
                                    cand)
            moge = (self.moge.infer_depth_batch_async([p["imgs"][0] for p in preps])
                    if self.moge is not None else None)
        launches = {k: v - launches0[k] for k, v in launch_counts().items()}
        self.chunk_launches += [launches] + [dict.fromkeys(launches, 0)] * (n_real - 1)
        self._produced += n_real
        return {"devs": devs, "moge": moge, "preps": preps, "group": list(group), "n_real": n_real}

    def _finish_group(self, pending: Dict) -> List[Dict]:
        """Pull a dispatched group (the synchronisation point) into consume
        items of its real chunks, in order."""
        n = pending["n_real"]
        with self.timing.track("materialize",
                               chunk=tuple(b["chunk_idx"] for b in pending["group"])):
            hosts = [host_outputs(d) for d in pending["devs"][:n]]
            moge = ([_host(d) for d in pending["moge"][:n]] if pending["moge"] is not None
                    else [None] * n)
        return [{"dev": hosts[b], "moge_depth": moge[b], "ready": None,
                 "kps": pending["preps"][b]["kps"], "det": pending["preps"][b]["det"],
                 "batch": pending["group"][b]} for b in range(n)]

    def _group_items(self, loader, dp: int, depth: int):
        """Consume items of dp groups in chunk order: a group is dispatched
        when it holds dp chunks, when the next chunk does not fit it
        (``group_compatible``) or at the end, and pulled once more than
        ``depth`` groups are in flight."""
        group: List[Dict] = []
        pending: List[Dict] = []
        for batch in loader:
            if not group_compatible(group, batch, self.config.pad_tail_chunks):
                pending.append(self._dispatch_group(group, dp))
                group = []
            group.append(batch)
            if len(group) == dp:
                pending.append(self._dispatch_group(group, dp))
                group = []
            while len(pending) > depth:
                yield from self._finish_group(pending.pop(0))
        if group:
            pending.append(self._dispatch_group(group, dp))
        while pending:
            yield from self._finish_group(pending.pop(0))

    def _consume(self, pending: Dict) -> ChunkReconstruction:
        """Build and finish one chunk on the calling thread."""
        return self._consume_finish(self._consume_build(pending))

    def _consume_build(self, pending: Dict, idx: int | None = None) -> Dict:
        """Stage 1: pull the step's outputs, metric scale, dense stash, the
        chunk reconstruction and its BA. Independent of every other chunk, so
        the async consumer runs build(k+1) beside finish(k). ``idx`` is the
        chunk's index for the dense stash (None: the consumed count)."""
        batch = pending["batch"]
        cid = batch["chunk_idx"]
        with self.timing.track("materialize", chunk=cid):
            if pending["ready"] is not None:
                # this thread's stream waits for the drive thread's step; the
                # pull blocks, so the step's tensors are free to drop after it
                torch.cuda.current_stream(self.device).wait_event(pending["ready"])
            host = host_outputs(pending["dev"])
            moge_depth = _host(pending["moge_depth"])
        pending["dev"] = pending["moge_depth"] = None
        n_frames = batch["images"].shape[0]
        host = slice_tail(host, n_frames)  # drop padded tail frames, if any

        poses = host["camera_poses"].astype(np.float64)
        points_kp = host["points_kp"].astype(np.float64)
        with self.timing.track("metric_scale", chunk=cid):
            scale_factor = metric_scale(moge_depth, host)
            if scale_factor is not None:
                points_kp *= scale_factor
                poses[:, :3, 3] *= scale_factor

        chunk = {
            "keypoints": pending["kps"],
            "points": points_kp,
            "colors": host["colors_kp"],
            "camera_poses": poses,
            "image_paths": batch["paths"],
            "original_width": batch["images"].shape[3],
            "original_height": batch["images"].shape[2],
        }
        if "intrinsics" in host:
            chunk["intrinsics"] = host["intrinsics"].astype(np.float64)
        if "obs_frame" in host:
            # the refined fan from the step; observations in padded frames go
            of = host["obs_frame"]
            chunk["obs_frame"] = of
            chunk["obs_uv"] = host["obs_uv"]
            chunk["obs_valid"] = host["obs_valid"] & (of < n_frames)
        det = pending.get("det")
        if det is not None:
            # ALIKED: sub-threshold slots spawn no live track; descriptors
            # add matches to the cross-chunk alignment and feed loop closure
            chunk["keypoint_valid"] = det["valid"].astype(bool)
            chunk["descriptors"] = det["descriptors"].astype(np.float32)
        if "local_points_dense" in host:
            self._stash_dense(host, poses, chunk, scale_factor,
                              self._consumed if idx is None else idx, batch["images"], cid)

        with self.timing.track("reconstruction", chunk=cid):
            recon = build_chunk_reconstruction(
                chunk,
                max_observations_per_track=self.config.max_observations_per_track,
                ba_iterations=self.config.ba_iterations,
                use_inverse_depth=self.config.use_inverse_depth,
                device=self.sfm_device,
            )
        return {"recon": recon, "pending": pending, "host": host}

    def _consume_finish(self, ctx: Dict) -> ChunkReconstruction:
        """Stage 2, strictly in order: Sim3-align against the previous chunk,
        append to the chain, then the debug artifacts."""
        recon = ctx["recon"]
        with self.timing.track("alignment", chunk=ctx["pending"]["batch"]["chunk_idx"]):
            res = None
            if self.reconstructions:
                res = align_chunks(
                    self.reconstructions[-1], recon,
                    refine=self.config.align_refine,
                    refine_iterations=self.config.align_refine_iterations,
                    device=self.sfm_device,
                )
                self.alignment_results.append(res)
        if self.config.debug_overlap and self.reconstructions:
            try:
                self._dump_overlap_debug(self.reconstructions[-1], recon, res, ctx["host"])
            except Exception as e:  # a debug artifact must never end the run
                print(f"overlap debug dump failed: {e}")
        self.reconstructions.append(recon)
        self._consumed += 1
        # Below this line the chunk is in the chain: a failing side effect is
        # printed and skipped, never raised, so no caller consumes the chunk
        # a second time (its frames twice in the merged trajectory).
        if self.config.save_debug_recons:
            try:
                save_reconstruction(recon, os.path.join(
                    self.config.output_dir, "debug_recons", f"recon_{self._consumed - 1:06d}.npz"))
            except Exception as e:
                print(f"debug recon save failed: {e}")
        batch = ctx["pending"]["batch"]
        if self.config.save_debug_projections:
            imgs = batch["images"]
            if imgs.dtype == np.uint8:
                imgs = imgs.astype(np.float32) / 255.0
            dbg_dir = os.path.join(self.config.output_dir, "debug_projections")
            os.makedirs(dbg_dir, exist_ok=True)
            try:
                render_debug_projections(recon, imgs, os.path.join(
                    dbg_dir, f"chunk_{self._consumed - 1:06d}.gif"), device=self.sfm_device)
            except Exception as e:
                print(f"debug projections failed: {e}")
        if self.visualizer is not None:
            try:
                frame = batch["images"][-1].transpose(1, 2, 0)
                if frame.dtype != np.uint8:
                    frame = (frame * 255.0).clip(0, 255).astype(np.uint8)
                self.visualizer.update(recon, frame=frame, keypoints=ctx["pending"]["kps"][-1])
            except Exception as e:
                print(f"viewer update failed: {e}")
        if self.config.live_mesh_every > 0 and self._consumed % self.config.live_mesh_every == 0:
            try:
                self._live_mesh_tick()
            except Exception as e:
                print(f"live mesh tick failed: {e}")
        return recon

    def _dump_overlap_debug(self, prev, recon, res, host) -> None:
        """Overlap diagnostic at alignment time (overlap frame names on both
        sides, common-track counts, point and confidence statistics): printed
        and appended as one JSON line to <output_dir>/overlap_debug.jsonl."""
        common = set(prev.frame_names) & set(recon.frame_names)
        entry = {
            "chunk": self._consumed,
            "prev_overlap_frames": [n for n in prev.frame_names if n in common],
            "cur_overlap_frames": [n for n in recon.frame_names if n in common],
            "num_common_frames": len(common),
            "num_common_tracks": int(res.num_common_tracks) if res else 0,
            "num_used_tracks": int(res.num_used_tracks) if res else 0,
            "alignment_success": bool(res.success) if res else False,
            "num_keypoints_per_frame": int(recon.num_tracks // max(1, recon.num_frames)),
            "num_points": int(recon.num_tracks),
            "num_live_points": int((recon.track_valid > 0).sum()),
            "mean_conf": float(np.asarray(host["conf_kp"]).mean()),
            "overlap": int(self.config.overlap),
            "chunk_length": int(self.config.chunk_length),
        }
        print(
            f"CHUNK OVERLAP DEBUG: chunk {entry['chunk']} | common frames "
            f"{entry['num_common_frames']} {entry['cur_overlap_frames']} | "
            f"common tracks {entry['num_common_tracks']} "
            f"(used {entry['num_used_tracks']}, "
            f"{'ok' if entry['alignment_success'] else 'FAILED'}) | "
            f"points {entry['num_live_points']}/{entry['num_points']} | "
            f"mean conf {entry['mean_conf']:.3f}"
        )
        os.makedirs(self.config.output_dir, exist_ok=True)
        with open(os.path.join(self.config.output_dir, "overlap_debug.jsonl"), "a") as f:
            f.write(json.dumps(entry) + "\n")

    def _stash_dense(self, host, poses, chunk, scale_factor, idx, images, chunk_idx) -> None:
        """Write the chunk's strided dense maps to <output>/dense/dense_<idx>.npz
        (the offline ``--save-dense`` layout), with the pre-alignment,
        metric-scaled poses the reconstruction was built from."""
        with self.timing.track("dense_stash", chunk=chunk_idx):
            dense = {
                "camera_poses": poses.astype(np.float32),
                "original_height": chunk["original_height"],
                "original_width": chunk["original_width"],
            }
            if "intrinsics" in chunk:
                dense["intrinsics"] = chunk["intrinsics"].astype(np.float32)
            _store_dense_maps(dense, host, scale_factor, self.config.dense_stride, images)
            ddir = os.path.join(self.config.output_dir, "dense")
            os.makedirs(ddir, exist_ok=True)
            save_npz(os.path.join(ddir, f"dense_{idx:06d}.npz"), self.config.chunk_compression,
                     **dense)

    def apply_loop_closure(self):
        """Loop closure over the accumulated chunk reconstructions
        (``sfm/loops.close_loops`` on the SfM device): revisits found by
        descriptor matching, the drift spread by the Sim3 pose graph. Call
        after processing; needs ALIKED chunks. None when ``loop_closure`` is
        off or fewer than two chunks exist."""
        if not self.config.loop_closure or len(self.reconstructions) < 2:
            return None
        from ..sfm.loops import close_loops

        stats = close_loops(self.reconstructions, min_inliers=self.config.loop_min_inliers,
                            min_cosine=self.config.loop_min_cosine, device=self.sfm_device)
        if stats["num_loop_edges"]:
            print(f"loop closure: {stats['num_loop_edges']} edge(s), pose-graph "
                  f"cost {stats['initial_cost']:.4f} -> {stats['final_cost']:.4f}")
        else:
            has_desc = any(r.track_desc is not None for r in self.reconstructions)
            why = "" if has_desc else " (grid chunks carry no descriptors — use --keypoints aliked)"
            print(f"loop closure: no verified loop edges{why}")
        return stats

    def apply_telemetry(self):
        """Gravity + GPS constrained finalization over the accumulated chunk
        reconstructions (``sfm/priors.constrain_with_telemetry`` on the SfM
        device). Call after processing and loop closure, before the exports;
        georeferences everything into the GPS ENU frame. None without
        ``telemetry_path`` or chunks."""
        if not self.config.telemetry_path or not self.reconstructions:
            return None
        from ..sfm.priors import constrain_with_telemetry
        from ..utils.telemetry import load_telemetry

        stats = constrain_with_telemetry(
            self.reconstructions, load_telemetry(self.config.telemetry_path),
            gps_sigma=self.config.gps_sigma, gravity_sigma=self.config.gravity_sigma,
            refine_iterations=self.config.telemetry_refine_iterations, device=self.sfm_device)
        print(f"telemetry: gps={stats['gps']} gravity={stats['gravity']} "
              f"refined {stats['refined_chunks']} chunks"
              + (f", GPS RMS {stats['gps_rms_m']:.2f} m" if stats["gps"] else ""))
        return stats

    # ----- dense mapping (mapping/) -----

    def _dense_files(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.config.output_dir, "dense", "dense_*.npz")))

    def _mesh_config(self, max_voxels: int):
        from ..mapping.tsdf import TSDFConfig

        return TSDFConfig(voxel_size=self.config.mesh_voxel_size, max_voxels=max_voxels,
                          conf_threshold=self.config.mesh_conf_threshold)

    def _live_mesh_tick(self) -> None:
        """Kick a background live-mesh refresh (non-blocking; drops the tick
        when the previous refresh is still running)."""
        if self._live_mesh_thread is not None and self._live_mesh_thread.is_alive():
            return
        files = self._dense_files()
        n = min(len(files), len(self.reconstructions))
        if n == 0:
            return
        self._live_mesh_thread = threading.Thread(
            target=self._live_mesh_fuse, args=(files[:n], list(self.reconstructions[:n])),
            name="live-mesh", daemon=True)
        self._live_mesh_thread.start()

    def _live_mesh_fuse(self, files: List[str], recons: List[ChunkReconstruction]) -> None:
        """Re-fuse the stashes under the CURRENT aligned poses on the host
        CPU (never contends with the forward in flight on the device) and
        print the surface's size. Re-fusing from scratch keeps the preview
        consistent with alignment and drift corrections; a coarser voxel cap
        keeps each refresh cheap. Pose changes racing a refresh can only skew
        the preview: the authoritative mesh comes from ``export_mesh``.
        Degenerate geometry (no confident depth to bound or fuse; the
        ValueErrors of ``fuse_chunks``) prints ``live mesh skipped``, as
        ``export_fused_mesh`` prints ``mesh export skipped``, where the JAX
        class prints it as a failed refresh."""
        from ..mapping.fuse import fuse_chunks

        try:
            volume = fuse_chunks([lambda p=p: _load_npz(p) for p in files], recons,
                                 config=self._mesh_config(min(self.config.mesh_max_voxels,
                                                              128**3)),
                                 overlap=self.config.overlap, device="cpu")
            verts, faces, vcols = volume.extract_mesh(min_weight=self.config.mesh_min_weight)
            if self.visualizer is not None and len(verts):
                self.visualizer.show_mesh(verts, faces, vcols)
            print(f"live mesh: {len(verts)} verts from {len(files)} chunks")
        except ValueError as e:
            print(f"live mesh skipped: {e}")
        except Exception as e:  # a preview failure must never end the run
            print(f"live mesh refresh failed: {e}")

    def export_mesh(self, path: Optional[str] = None) -> Optional[str]:
        """TSDF-fuse the stashed dense maps under the FINAL chunk poses on the
        device and write a surface-nets mesh. Call after apply_loop_closure /
        apply_telemetry: the reconstructions' poses at call time define the
        mesh frame. Returns the mesh path (None when skipped)."""
        from ..mapping.fuse import export_fused_mesh

        files = self._dense_files()
        if not files:
            print("mesh export skipped: no stashed dense maps — run with "
                  "export_mesh/save_dense enabled (--export-mesh)")
            return None
        if len(files) != len(self.reconstructions):
            print(f"mesh export skipped: {len(files)} dense chunks vs "
                  f"{len(self.reconstructions)} reconstructions (stale dense/ "
                  "directory from a previous run?)")
            return None
        cfg = self.config
        result = export_fused_mesh(
            [lambda p=p: _load_npz(p) for p in files], self.reconstructions,
            path or os.path.join(cfg.output_dir, "fused_mesh.ply"),
            config=self._mesh_config(cfg.mesh_max_voxels), overlap=cfg.overlap,
            min_weight=cfg.mesh_min_weight,
            volume_path=(os.path.join(cfg.output_dir, "fused_volume.npz")
                         if cfg.save_volume else None),
            device=self.device)
        if result is None:
            return None
        if self.visualizer is not None and len(result["vertices"]):
            self.visualizer.show_mesh(result["vertices"], result["faces"], result["colors"])
        return result["path"]

    # ----- drive loops -----

    def process_image_paths_sync(self, image_paths: List) -> Dict:
        """Each chunk fully processed before the next is dispatched."""
        return self.process_image_paths(image_paths, pipelined=False)

    def queue_status(self) -> Dict:
        """Produced / consumed / in-flight chunk counts, alignment counts and
        the stage timings (``online.queue_wait``: the SfM consumer's waits on
        its queue, with ``async_sfm``)."""
        return {
            "chunks_produced": self._produced,
            "chunks_consumed": self._consumed,
            "chunks_inflight": self._produced - self._consumed,
            "data_parallel_chunks": self.mesh.axis_size("dp") if self.mesh is not None else 1,
            "overlap_device_host": self.config.overlap_device_host,
            "alignments": len(self.alignment_results),
            "alignment_failures": sum(1 for r in self.alignment_results if not r.success),
            "timing": self.timing.statistics(),
        }

    def process_image_paths(self, image_paths: List, pipelined: bool = True) -> Dict:
        """Stream the frames through the chunk pipeline. ``pipelined``: chunk
        k+1's step is in flight while chunk k is consumed, on the consumer
        thread with ``async_sfm`` (and ``overlap_device_host``), else on this
        thread one chunk behind; ``pipelined=False`` processes strictly one
        chunk at a time. Returns num_chunks, num_frames (overlap frames
        counted in each chunk) and fps."""
        cfg = self.config
        if self._dense_on() and self._consumed == 0:
            # stale stashes of an earlier run; a later call on the same
            # instance continues the chain and keeps its own
            for p in glob.glob(os.path.join(cfg.output_dir, "dense", "dense_*.npz")):
                os.remove(p)
        target = calculate_target_size(image_paths[0], cfg.pixel_limit)
        print(f"Target size: {target}")
        dataset = ChunkDataset(image_paths, cfg.chunk_length, cfg.overlap, target,
                               undistorter=self.undistorter)
        loader = PrefetchLoader(dataset, num_workers=cfg.num_loader_workers)

        t_start = time.time()
        dp = cfg.data_parallel_chunks if self.mesh is not None else 1
        if dp > 1:
            # dp groups pipeline one group deep (with overlap_device_host)
            # inside the generator; their items are pulled already
            items = self._group_items(loader, dp, 1 if pipelined and cfg.overlap_device_host else 0)
            depth = 0
        else:
            items = (self._dispatch_device(batch) for batch in loader)
            depth = 1 if pipelined else 0
        if pipelined and cfg.overlap_device_host and cfg.async_sfm:
            frames_done = self._drive_async(items)
        else:
            frames_done = 0
            pending: List[Dict] = []  # dispatched, not yet consumed (in order)
            for item in items:
                pending.append(item)
                while len(pending) > depth:
                    item = pending.pop(0)
                    self._consume(item)
                    frames_done += item["batch"]["images"].shape[0]
            for item in pending:
                self._consume(item)
                frames_done += item["batch"]["images"].shape[0]

        wall = time.time() - t_start
        fps = frames_done / wall if wall > 0 else 0.0
        print(f"Online: {frames_done} frames in {wall:.2f}s -> {fps:.2f} FPS")
        self.timing.print_statistics()
        return {"num_chunks": len(self.reconstructions), "num_frames": frames_done, "fps": fps}

    def _sfm_stream(self):
        """A CUDA stream for one consumer thread (None off the card). High
        priority: the block scheduler gives BA's small kernels the SMs that
        the forward's blocks free ahead of the forward's pending blocks."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.Stream(self.device, priority=-1)

    def _drive_async(self, items) -> int:
        """The drive thread dispatches (draws ``items``, the dispatched
        chunks); an ``sfm-consumer`` thread finishes chunks in order while a
        one-worker ``sfm-build`` executor builds the next one. The queue holds at most two dispatched chunks. On an error
        the consumer waits for its lookahead build and exits; the drive thread
        re-raises the error at its next enqueue or at the drain, and no chunk
        is consumed again. Returns the frames consumed."""
        done = {"frames": 0}
        park = {"exc": None}
        stop = threading.Event()
        cq: queue.Queue = queue.Queue(maxsize=2)
        build_stream, finish_stream = self._sfm_stream(), self._sfm_stream()

        def enter_build_stream():
            if build_stream is not None:
                torch.cuda.set_stream(build_stream)  # the current stream is per thread

        def consumer_loop():
            ex = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="sfm-build",
                                                       initializer=enter_build_stream)
            prev_item = prev_fut = None
            next_idx = self._consumed  # the dense stash's chunk index
            try:
                with torch.cuda.stream(finish_stream):
                    while True:
                        with self.timing.track("online.queue_wait") as wait:
                            it = cq.get()
                            wait.chunk = (it["batch"]["chunk_idx"] if isinstance(it, dict)
                                          else None)
                        if stop.is_set():  # the drive thread gave up
                            it = _DONE
                        nxt_fut = None
                        if it is not _DONE:
                            nxt_fut = ex.submit(self._consume_build, it, next_idx)
                            next_idx += 1
                        if prev_fut is not None:
                            try:
                                self._consume_finish(prev_fut.result())
                                done["frames"] += prev_item["batch"]["images"].shape[0]
                            except BaseException as e:
                                if nxt_fut is not None:
                                    # settle the lookahead build: none of its
                                    # device work outlives the park
                                    concurrent.futures.wait([nxt_fut])
                                park["exc"] = e
                                return
                        if it is _DONE:
                            return
                        prev_item, prev_fut = it, nxt_fut
            finally:
                ex.shutdown(wait=True)

        consumer = threading.Thread(target=consumer_loop, name="sfm-consumer", daemon=True)
        consumer.start()

        def service():
            if park["exc"] is not None:
                consumer.join()
                raise park["exc"]

        def enqueue(item):
            while True:
                service()
                try:
                    cq.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        try:
            for item in items:
                enqueue(item)
            enqueue(_DONE)
            consumer.join()
            service()
        except BaseException:
            # stop the consumer after the chunk it is on; a bounded wait, so
            # a consumer stuck in a device call cannot hold the error back
            stop.set()
            try:
                cq.put_nowait(_DONE)
            except queue.Full:
                pass  # the consumer's next get sees the stop
            consumer.join(timeout=60.0)
            raise
        return done["frames"]

    # ----- exports -----

    def _merged_trajectory(self, return_names: bool = False):
        """Camera centers and camera-to-world rotations of every frame, the
        first chunk's view of a frame winning."""
        seen = set()
        centers, rotations, names = [], [], []
        for r in self.reconstructions:
            for j, nm in enumerate(r.frame_names):
                if nm in seen:
                    continue
                seen.add(nm)
                centers.append(r.centers[j])
                rotations.append(r.rotations[j].T)
                names.append(nm)
        if return_names:
            return np.asarray(centers), np.asarray(rotations), names
        return np.asarray(centers), np.asarray(rotations)

    def save_final_result(self, path: str, max_points: Optional[int] = None) -> None:
        clouds = [r.points[r.track_valid > 0] for r in self.reconstructions]
        colors = [r.colors[r.track_valid > 0] for r in self.reconstructions]
        cloud = np.concatenate(clouds) if clouds else np.zeros((0, 3))
        color = np.concatenate(colors) if colors else np.zeros((0, 3))
        write_ply(cloud, color, path, max_points=max_points)
        print(f"Saved {cloud.shape[0]} points -> {path}")

    def save_trajectory_tum(self, path: str, timestamps=None, name_to_timestamp=None) -> None:
        centers, rotations, names = self._merged_trajectory(return_names=True)
        if timestamps is None and name_to_timestamp:
            timestamps = [name_to_timestamp.get(nm, i) for i, nm in enumerate(names)]
        write_tum_trajectory(path, centers, rotations, timestamps=timestamps)
        print(f"Saved trajectory ({len(centers)} poses) -> {path}")
