"""The offline entry: ``OfflineChunkCreator.process_and_save`` over the
cell's sequence, as ``create_offline_chunks`` runs it.

A chunk's completion is stamped after ``OfflineChunkCreator._finish_chunk``
(the host copy of its outputs and the storage dict built, as the port's
``tools/perf_pipeline`` stamps it); the chunk's npz is written after the
stamp, so the interval between two stamps holds everything the creator does
between two chunks. The chunk counts its new frames: all of the first
chunk's, then the chunk length less the overlap, so each frame of the
sequence counts once. Once the window has closed and its last chunk is on
disk, the run leaves ``process_and_save`` by ``WindowClosed``.

In a traced run the creator's stages are timed as host spans around the
calls into them (``portbench.loader_wait``, ``portbench.dispatch``,
``portbench.finish``, ``portbench.save_npz``), on the host clock into
``ctx.spans``; the harness lays them onto the trace's timeline.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


class WindowClosed(Exception):
    """Raised out of the program once the window's last chunk is stored."""


@contextlib.contextmanager
def _span(spans: list | None, name: str):
    """Time the block as a host span (name, start, end) into ``spans``."""
    if spans is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        spans.append((name, t0, time.perf_counter()))


def run(ctx, window, hook=None) -> dict:
    """Drive the creator over ``ctx.paths`` until ``window`` closes. Returns
    the pieces the check needs: the output directory and, per chunk index
    after warm-up, MoGe's outputs on the chunk's first frame (host copies of
    its points, mask and metric scale, 2 MB a chunk, taken after the chunk's
    host sync); the frame size ``hw``; and the creator, held until the
    harness frees the program's state."""
    from pi3_slam_tpu_torch.slam import chunk_creator
    from pi3_slam_tpu_torch.slam.config import OfflineCreatorConfig

    cfg, tr = ctx.config, ctx.traffic
    out_dir = os.path.join(ctx.workdir, "chunks_out")
    models = ctx.family.build_program(cfg, ctx.seed, ctx.device)
    load_models = chunk_creator.load_models
    creator_cfg = OfflineCreatorConfig(
        output_dir=out_dir, chunk_length=tr["chunk_length"], overlap=tr["overlap"],
        pixel_limit=tr["pixel_limit"], device=ctx.device.type,
        compute_dtype=cfg["compute_dtype"], global_kv_merge=cfg["model"]["global_kv_merge"],
        use_metric_depth=cfg.get("metric_depth") is not None,
        max_keypoints=tr["max_keypoints"], keypoint_type=tr["keypoints"],
        num_loader_workers=tr["loader_workers"], chunk_compression=tr["chunk_compression"],
        conf_threshold=cfg["step"]["conf_threshold"],
        depth_edge_rtol=cfg["step"]["depth_edge_rtol"])
    chunk_creator.load_models = lambda config, pi3_config, device: models
    try:
        creator = chunk_creator.OfflineChunkCreator(creator_cfg)
    finally:
        chunk_creator.load_models = load_models
    del models
    if hook is not None:
        hook(creator)

    spans = ctx.spans
    moge = {}
    finish, dispatch = creator._finish_chunk, creator._dispatch_chunk
    save_npz, loader = chunk_creator.save_npz, chunk_creator.PrefetchLoader

    def dispatch_spanned(images, paths):
        with _span(spans, "portbench.dispatch"):
            return dispatch(images, paths)

    def finish_and_stamp(pending):
        with _span(spans, "portbench.finish"):
            r = finish(pending)
        t = time.perf_counter()
        k = window.done
        n = r["_metrics"]["num_frames"]
        if creator.moge is not None and k >= window.warmup:
            out = creator.moge.last_out  # this chunk's MoGe forward, done
            moge[k] = {"points": out["points"][0].cpu().numpy(),
                       "mask": out["mask"][0].cpu().numpy(),
                       "metric_scale": out["metric_scale"][0].cpu().numpy()}
        window.completed(t, {"index": k, "t": t, "t0": pending["t0"],
                             "infer_s": r["_metrics"]["infer_s"],
                             "frames": n if k == 0 else n - tr["overlap"],
                             "paths": list(pending["paths"])})
        return r

    def save_and_close(path, compression="default", **arrays):
        with _span(spans, "portbench.save_npz"):
            save_npz(path, compression, **arrays)
        if window.closed:
            raise WindowClosed

    class SpannedLoader(loader):
        def __iter__(self):
            it = super().__iter__()
            while True:
                with _span(spans, "portbench.loader_wait"):
                    item = next(it, None)
                if item is None:
                    return
                yield item

    creator._dispatch_chunk = dispatch_spanned
    creator._finish_chunk = finish_and_stamp
    chunk_creator.save_npz = save_and_close
    chunk_creator.PrefetchLoader = SpannedLoader
    try:
        creator.process_and_save(ctx.paths)
    except WindowClosed:
        pass
    else:
        raise RuntimeError(f"the sequence ended before the window closed ({window.done} "
                           "chunks): the traffic mix needs more sequence_chunks")
    finally:
        chunk_creator.save_npz, chunk_creator.PrefetchLoader = save_npz, loader
    return {"out_dir": os.path.join(out_dir, "chunks"), "moge": moge,
            "hw": creator.target_size, "creator": creator}


def program_chunk(pieces: dict, index: int) -> dict:
    """The program's stored arrays of chunk ``index`` read back from its npz,
    with MoGe's outputs on its first frame where it ran."""
    with np.load(os.path.join(pieces["out_dir"], f"chunk_{index:06d}.npz")) as z:
        out = {k: z[k] for k in ("points", "local_points", "conf", "camera_poses")}
        out["metric_scale"] = float(z["metric_scale"]) if "metric_scale" in z.files else None
    out["moge"] = pieces["moge"].get(index)
    return out


def chunk_frames(traffic: dict, n_chunks: int) -> int:
    """Frames of a sequence of n_chunks full chunks."""
    return traffic["chunk_length"] + (n_chunks - 1) * (traffic["chunk_length"]
                                                       - traffic["overlap"])
