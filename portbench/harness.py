"""One run of one cell: set-up, the measured window, the metrics, the check.

``run_cell`` is the whole run after the look for a chip; ``run.py`` is the
command line around it. Set-up is everything from the process's start to the
window's start: importing the program, the cell's frames and sequence, the
weights drawn on the card from the seed, the models built, the kernels
loaded (built once into the checkout's ``pi3_slam_tpu_torch/_build/``) and
the warm-up chunks. The window then holds whole chunks (``window.py``). Once
it has closed, the peak memory is read, the program's state is freed, and a
chunk of the window drawn from the seed is worked out again by the plain
reference and compared with what the program stored (``families/``).
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from . import frames, manifest, trace
from .window import Window

# top-level module names a run may not hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pi3_slam_tpu")
# the size of the host-to-device copy that marks the traced slice's start on
# both clocks (a prime no other copy of a run has)
MARK_BYTES = 7919


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), each compared whole: ``pi3_slam_tpu_torch`` is not
    ``pi3_slam_tpu``."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(root, ".portbench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}


def workdir(traffic_name: str) -> str:
    """This cell's scratch directory under ``TMPDIR`` (a fixed name there)."""
    base = os.environ.get("TMPDIR") or "/tmp"
    return os.path.join(base, "portbench", traffic_name)


class Run(SimpleNamespace):
    """What a metric's reader gets: the cell (``config``, ``traffic``,
    ``workload``), the window (``window.chunks`` with each chunk's stamp
    ``t``, dispatch time ``t0``, the creator's ``infer_s`` span and its new
    ``frames``; ``window.t_open``, ``window.window_s``), ``setup_s``, the
    configuration's ``flops_per_chunk``, the frame size ``hw``, and in a
    traced run ``events`` (the trace's events), ``timeline`` and
    ``traced_chunks``."""

    def kernel_seconds(self, operation: str) -> tuple[float, int]:
        """(device seconds, launches) in the traced slice of the kernels listed
        under ``kernels/<operation>/``."""
        return trace.kernel_seconds(self.events, manifest.kernel_specs(operation))


def run_cell(workload_name: str, seed: int, seconds: float, traced: bool, *, device=None,
             bench: dict | None = None, config: dict | None = None,
             traffic: dict | None = None, limits: dict | None = None, hook=None,
             t_start: float | None = None, keep: dict | None = None) -> dict:
    """One run; returns the result dict (the last stdout line). ``config``,
    ``traffic`` and ``limits`` replace the cell's files (tests run the whole
    harness at a tiny size on the CPU); ``hook(program)`` is called on the
    program's object before the window (tests plant faults with it);
    ``keep`` receives the checked chunks' records, program arrays and
    reference arrays."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or manifest.load_benchmark()
    cell = manifest.workload(bench, workload_name)
    config = config or manifest.config(cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    limits = limits or manifest.limits(workload_name)
    device = torch.device("cuda") if device is None else torch.device(device)
    cuda = device.type == "cuda"
    family = manifest.family(config["family"])
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")

    from pi3_slam_tpu_torch.device import select_device

    select_device(device.type)
    log(f"program imported at {time.perf_counter() - t_start:.3f} s")
    work = workdir(cell["traffic"])
    os.makedirs(work, exist_ok=True)
    frame_set = frames.make_frames(
        os.path.join(work, f"frames_{traffic['frame_height']}x{traffic['frame_width']}"),
        traffic["distinct_frames"], traffic["frame_height"], traffic["frame_width"])
    n_frames = entry.chunk_frames(traffic, traffic["sequence_chunks"])
    paths = frames.make_sequence(os.path.join(work, "sequence"), frame_set,
                                 frames.sequence_order(seed, len(frame_set), n_frames))
    log(f"frames and sequence ready at {time.perf_counter() - t_start:.3f} s")
    out_dir = os.path.join(work, "chunks_out")
    if os.path.isdir(out_dir):
        import shutil

        shutil.rmtree(out_dir)

    prof = {}

    def start_trace():
        # device activity only: recording every host op slows the creator's
        # dispatch by ~0.25 s a chunk; its stages are timed as host spans
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        with profile(activities=acts):  # the tracer's own first start, off the slice
            torch.ones(1, device=device).add_(1)
        prof["p"] = profile(activities=acts)
        prof["p"].start()
        mark = torch.zeros(MARK_BYTES, dtype=torch.uint8)
        prof["t"] = time.perf_counter()
        mark.to(device)

    def stop_trace():
        if cuda:
            torch.cuda.synchronize()
        prof["p"].stop()
        prof["slice_s"] = time.perf_counter() - prof["t"]

    window = Window(seconds, traffic["warmup_chunks"],
                    traffic["trace_chunks"] if traced else 0, start_trace, stop_trace)
    spans = [] if traced else None
    ctx = SimpleNamespace(config=config, traffic=traffic, family=family, seed=seed,
                          device=device, workdir=work, paths=paths, spans=spans)
    pieces = entry.run(ctx, window, hook)
    if cuda:
        torch.cuda.synchronize()
    log(f"set-up ended at {window.setup_end - t_start:.3f} s; window {window.window_s:.3f} s, "
        f"{len(window.chunks)} chunks; intervals "
        + " ".join(f"{b['t'] - a['t']:.3f}" for a, b in zip(window.chunks, window.chunks[1:])))
    memory_peak = max((torch.cuda.max_memory_allocated(i)
                       for i in range(torch.cuda.device_count())), default=0) if cuda else 0

    run = Run(config=config, traffic=traffic, workload=cell, window=window,
              setup_s=window.setup_end - t_start, hw=pieces["hw"],
              flops_per_chunk=family.chunk_flops(config, traffic, *pieces["hw"]), events=None)
    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                     "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if traced:
        path = os.path.join(work, "trace.json")
        prof["p"].export_chrome_trace(path)
        run.events = trace.load_events(path)
        run.timeline = trace.device_timeline(run.events)
        run.events += trace.host_span_events(run.events, spans, prof["t"], MARK_BYTES)
        run.traced_chunks = len(window.traced)
        result_device.update(busy_s=run.timeline["busy_s"], window_s=run.timeline["window_s"])
        log(f"traced slice {prof['slice_s']:.3f} s over {run.traced_chunks} chunks; trace "
            f"window {run.timeline['window_s']:.3f} s, busy {run.timeline['busy_s']:.3f} s, "
            f"{len(run.events)} events")
        breakdown = {"device_ops": trace.top_device_ops(run.events),
                     "idle_gaps": trace.idle_gaps(run.events)}
        del prof["p"]
    metrics = {}
    for m in manifest.cell_metrics(bench, workload_name, traced):
        value = manifest.metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run.events = None

    # the check, once the window has closed and the program's state is freed
    rng = np.random.default_rng([abs(seed), int(seed < 0), 29])
    picks = sorted(rng.choice(len(window.chunks), size=min(traffic["check_chunks"],
                                                          len(window.chunks)), replace=False))
    programs = [(window.chunks[i], entry.program_chunk(pieces, window.chunks[i]["index"]))
                for i in picks]
    del pieces
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = {}, 0
    for record, program in programs:
        t_ref = time.perf_counter()
        ref = family.reference_chunk(config, traffic, seed, record["paths"], device)
        log(f"reference of chunk {record['index']}: {time.perf_counter() - t_ref:.3f} s")
        if keep is not None:
            keep.setdefault("checked", []).append((record, program, ref))
        numbers = family.compare(program, ref)
        ok = True
        for name, limit in limits.items():
            value = numbers[name]
            ok = ok and bool(np.isfinite(value)) and value <= limit
            prev = checks.get(name)
            if prev is None or value > prev["value"]:
                checks[name] = {"value": value, "limit": limit}
        failed += 0 if ok else 1
        if cuda:
            torch.cuda.empty_cache()
    result = {"correct": failed == 0 and len(programs) > 0,
              "attempted": len(window.chunks), "failed": failed,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main_result_lines(result: dict) -> tuple[str, str]:
    """(stderr lines of the numbers compared, the stdout result line)."""
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}"
             for k, v in result["checks"].items()]
    return "\n".join(lines), json.dumps(result)
