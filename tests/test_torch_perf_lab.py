"""The port's probes (``tools/perf_lab.py``) and trace reader
(``tools/trace_summary.py``) on the CPU.

Every probe needs the card: without one each raises a GPU error, through its
function and through the entry point, and a name that is no probe exits 2.
``trace_summary`` reads a torch.profiler trace made here on the CPU (host
slices only), and a small synthetic trace with kernel, memcpy and memset
events, on which it prints what the JAX package's ``tools/trace_summary.py``
prints for the same events on a device lane.
"""

import gzip
import json
import os
import runpy
import sys
from collections import deque

import pytest
import torch

from pi3_slam_tpu_torch.tools import perf_lab, trace_summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROBES = ("global", "frame", "block", "packed", "stages", "mlp-sweep", "forward", "refine",
              "kv-accuracy", "all")


@pytest.mark.parametrize("name", [*perf_lab.PROBES, "unknown"])
def test_every_probe_needs_a_gpu(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "unknown":
        with pytest.raises(SystemExit) as exc:
            perf_lab.probe([name])
        assert exc.value.code == 2 and "unknown probe 'unknown'" in capsys.readouterr().err
        return
    with pytest.raises(RuntimeError, match="GPU"):
        perf_lab.PROBES[name]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf_lab.probe([name])


def test_the_jax_probes_are_all_there_and_all_is_the_default(monkeypatch, capsys):
    import pi3_slam_tpu_torch.device as device

    assert set(JAX_PROBES) <= set(perf_lab.PROBES)
    assert perf_lab.ALL == ("global", "frame", "block", "packed", "stages", "mlp", "forward")
    assert ((1, 2452), 1024, 4096, "block_mlp", ("float32",)) in perf_lab.MLP_SWEEP  # MoGe v1
    monkeypatch.setattr(device, "select_device", lambda name: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=0: "a card")
    monkeypatch.setitem(perf_lab.PROBES, "all", lambda: "all ran")
    assert perf_lab.probe([]) == "all ran"
    assert capsys.readouterr().out == "device: a card\n"


def test_trace_summary_reads_a_cpu_profile(tmp_path, capsys, monkeypatch):
    """A torch.profiler trace of a CPU run: no device event, host slices;
    the program's spans merged into it (as ``--profile-dir`` merges them)
    give the by-span table."""
    from torch.profiler import ProfilerActivity, profile

    from pi3_slam_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "_buffer", deque(maxlen=timing.MAX_SPANS))
    x = torch.rand(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timing.span("step.post"):
                x = torch.relu(x @ x)
    prof.export_chrome_trace(str(tmp_path / "chunk_trace.json"))
    assert timing.add_spans_to_trace(str(tmp_path / "chunk_trace.json")) == 3
    assert trace_summary.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"trace: {tmp_path / 'chunk_trace.json'}"
    assert out[1].startswith("device leaf total: 0.0 ms   host slices total: ")
    s = trace_summary.summarize(str(tmp_path / "chunk_trace.json"))
    assert s["device_total_us"] == 0 and s["host_total_us"] > 0
    row = s["by_span"]["step.post"]
    assert row["count"] == 3 and row["host_us"] > 0 and row["device_us"] == 0
    assert out[-2].split() == ["span", "host", "s", "x", "device", "s"]
    assert out[-1].split()[0] == "step.post" and out[-1].split()[2] == "3"


def test_trace_summary_charges_device_time_to_the_launching_span():
    """A kernel counts for every span around its launch call on the
    launching thread (by correlation id), never for a span on another
    thread or one the launch lies outside."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "creator.dispatch", "ts": 0.0,
         "dur": 100.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pi3.encoder", "ts": 10.0, "dur": 20.0,
         "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "loader.decode", "ts": 0.0, "dur": 100.0,
         "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 15.0, "dur": 2.0,
         "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 50.0, "dur": 2.0,
         "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 150.0, "dur": 2.0,
         "tid": 1, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "gemm_kernel<0>", "ts": 400.0, "dur": 300.0,
         "tid": 7, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "packed_attention_kernel", "ts": 700.0,
         "dur": 500.0, "tid": 7, "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1200.0, "dur": 40.0,
         "tid": 7, "args": {"correlation": 9}},
    ]
    table = trace_summary.by_span(events)
    assert table["creator.dispatch"] == {"host_us": 100.0, "count": 1, "device_us": 800.0}
    assert table["pi3.encoder"]["device_us"] == 300.0
    assert table["loader.decode"]["device_us"] == 0.0


def test_trace_summary_matches_launches_on_either_lane_of_the_thread():
    """A merged span lists its thread's native and pthread ids: launches on
    either lane count for it and for a span of the other lane, driver
    launches (``cuda_driver``) as runtime ones; another thread's do not."""
    native, pthread, other = 616, 1174846720, 617
    span = {"ph": "X", "cat": "user_annotation"}
    launch = {"ph": "X", "dur": 1.0}
    events = [
        {**span, "name": "chunk", "ts": 0.0, "dur": 100.0, "tid": native,
         "args": {"span_id": 1, "threads": [native, pthread]}},
        {**span, "name": "pi3.decoder", "ts": 10.0, "dur": 50.0, "tid": native,
         "args": {"span_id": 2, "threads": [native, pthread]}},
        {**span, "name": "record_function", "ts": 0.0, "dur": 100.0, "tid": pthread},
        {**span, "name": "loader.decode", "ts": 0.0, "dur": 100.0, "tid": other,
         "args": {"span_id": 3, "threads": [other, 99]}},
        {**launch, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20.0, "tid": pthread,
         "args": {"correlation": 1}},
        {**launch, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30.0, "tid": native,
         "args": {"correlation": 2}},
        {**launch, "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 70.0, "tid": pthread,
         "args": {"correlation": 3}},
        {**launch, "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 40.0, "tid": 99,
         "args": {"correlation": 4}},
    ]
    for c, (name, us) in enumerate([("packed_attention_kernel", 500.0), ("gemm_kernel<0>", 70.0),
                                    ("triton_k", 9.0), ("copy", 2.0)], 1):
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": 1000.0 * c, "dur": us,
                       "tid": 7, "args": {"correlation": c}})
    table = trace_summary.by_span(events)
    assert table["chunk"]["device_us"] == 579.0
    assert table["pi3.decoder"]["device_us"] == 570.0
    assert table["record_function"]["device_us"] == 579.0
    assert table["loader.decode"]["device_us"] == 2.0


def _synthetic_events():
    """Kernel, memcpy and memset events on pid 1 and host slices on pid 2,
    labelled both ways: the torch.profiler categories the port reads and
    the device lane name and hlo_category the JAX tool reads."""
    events = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:GPU:0"}},
              {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "python host"}}]
    device = [("gemm_kernel<0>", "kernel", 820.0, 3), ("packed_attention_kernel", "kernel",
                                                       6990.0, 2),
              ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 150.0, 2),
              ("Memset (Device)", "gpu_memset", 4.0, 5), ("elementwise_kernel<128, 2>", "kernel",
                                                          3.4, 40)]
    ts = 0.0
    for name, cat, dur, n in device:
        for _ in range(n):
            events.append({"ph": "X", "pid": 1, "tid": 7, "ts": ts, "dur": dur, "name": name,
                           "cat": cat,
                           "args": {"hlo_category": {"gpu_memcpy": "memcpy",
                                                     "gpu_memset": "memset"}.get(cat, cat)}})
            ts += dur
    for name, dur in (("aten::mm", 50.0), ("cudaLaunchKernel", 4.0), ("aten::relu", 7.5)):
        events.append({"ph": "X", "pid": 2, "tid": 1, "ts": 0.0, "dur": dur, "name": name,
                       "cat": "cpu_op"})
    return events


def test_trace_summary_prints_the_jax_tools_table(tmp_path, capsys, monkeypatch):
    events = _synthetic_events()
    path = tmp_path / "plugins" / "profile" / "trace.json.gz"
    path.parent.mkdir(parents=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert trace_summary.main([str(tmp_path), "4"]) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["trace_summary.py", str(tmp_path), "4"])
    runpy.run_path(os.path.join(REPO, "tools", "trace_summary.py"), run_name="__main__")
    assert got == capsys.readouterr().out
    s = trace_summary.summarize(str(path))
    assert s["by_category"] == pytest.approx(
        {"kernel": 3 * 820.0 + 2 * 6990.0 + 40 * 3.4, "memcpy": 300.0, "memset": 20.0})
    assert s["host_total_us"] == 61.5 and s["device_count"]["elementwise_kernel<128, 2>"] == 40
    lines = got.splitlines()
    assert lines[lines.index("by category:") + 1].split()[0] == "kernel"
    assert lines[-4].startswith("packed_attention_kernel") and len(lines[-4:]) == 4


def test_one_yardstick_for_the_probes_and_chip_smoke():
    """chip_smoke.py and the probes read the bounds from ops/roofline: the
    larger of the operations at the peak and the bytes over 3.35 TB/s."""
    from pi3_slam_tpu_torch.ops import roofline

    sys.path.insert(0, REPO)
    import chip_smoke

    for name in ("bound", "attention_flops", "mlp_work", "exp2_ms", "PEAK_BF16", "PEAK_3XTF32"):
        assert getattr(chip_smoke, name) is getattr(roofline, name)
    assert roofline.bound(989e9, 1.0) == pytest.approx((1.0, "operations"))
    assert roofline.bound(1.0, 3.35e9) == pytest.approx((1.0, "bytes"))
    assert roofline.bound(495e9 / 3, 0.0, roofline.PEAK_3XTF32)[0] == pytest.approx(1.0)
    assert roofline.exp2_ms(3.9e9) == pytest.approx(1.0)
    # the global attention: 4 b h t^2 d flops, q, k, v and out once in bf16
    assert roofline.attention_work(1, 66000, 16, 64, 2) == (4.0 * 16 * 66000**2 * 64,
                                                             4 * 66000 * 16 * 64 * 2)
    x, w1 = torch.zeros(1, 2452, 1024), torch.zeros(4096, 1024)
    flops, nbytes = roofline.mlp_work(x, w1)
    assert flops == 4.0 * 2452 * 1024 * 4096
    assert nbytes == 2 * 2452 * 1024 * 4 + 2 * 4096 * 1024 * 4 + (4096 + 4 * 1024) * 4


@pytest.mark.parametrize("entry", ["block_mlp", "mlp"])
def test_probes_hold_each_kernel_before_timing_it(entry, capsys):
    """``_held`` passes the kernel's own output, raises on one 10% off, and
    leaves the launch counts as they were (a check is no launch of the
    probe): shown on the CPU, where the wrappers run their plain version."""
    from pi3_slam_tpu_torch import ops
    from pi3_slam_tpu_torch.ops.block_mlp import block_mlp, block_mlp_plain
    from pi3_slam_tpu_torch.ops.compare import MLP, block_mlp_bounds
    from pi3_slam_tpu_torch.ops.mlp import mlp, mlp_plain

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 40, 128, generator=g).bfloat16()
    w1, b1 = (torch.randn(512, 128, generator=g) * 0.05).bfloat16(), torch.zeros(512).bfloat16()
    w2, b2 = (torch.randn(128, 512, generator=g) * 0.05).bfloat16(), torch.zeros(128).bfloat16()
    norm = (torch.ones(128), torch.zeros(128))
    if entry == "block_mlp":
        run = lambda: block_mlp(x, *norm, w1, b1, w2, b2)  # noqa: E731
        plain = lambda: block_mlp_plain(x, *norm, w1, b1, w2, b2)  # noqa: E731
        bounds = block_mlp_bounds(x, plain())
        off = lambda: x + 1.1 * (plain() - x)  # noqa: E731
    else:
        run, plain, bounds = (lambda: mlp(x, w1, b1, w2, b2)), (
            lambda: mlp_plain(x, w1, b1, w2, b2)), MLP
        off = lambda: 1.1 * plain()  # noqa: E731
    fn = ops.KERNEL_WRAPPERS[entry]
    before = fn.launches
    try:
        fn.launches = 7
        perf_lab._held(entry, "(1, 40, 128)", run, plain, "the plain version", **bounds)
        assert " ok" in capsys.readouterr().out
        with pytest.raises(RuntimeError, match="disagrees with its plain version"):
            perf_lab._held(entry, "(1, 40, 128)", off, plain, "10% off", **bounds)
        with ops.uncounted():
            fn.launches += 3
        assert fn.launches == 7
    finally:
        fn.launches = before
