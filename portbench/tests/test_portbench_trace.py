"""The trace readers on a fabricated Chrome trace."""

import gzip
import json

import pytest

from portbench import trace


def _trace():
    k = {"cat": "kernel", "ph": "X"}
    return [
        {**k, "name": "void pi3::packed_attention_kernel(x)", "ts": 0, "dur": 100,
         "args": {"grid": [503, 16, 1]}},
        {**k, "name": "void pi3::packed_attention_kernel(x)", "ts": 150, "dur": 10,
         "args": {"grid": [6, 16, 100]}},
        {**k, "name": "void pi3::gemm_kernel<0>(x)", "ts": 160, "dur": 40, "args": {}},
        {**k, "name": "void pi3::gemm_f32_kernel<0, 4>(x)", "ts": 190, "dur": 20, "args": {}},
        {"cat": "gpu_memcpy", "ph": "X", "name": "Memcpy DtoH", "ts": 400, "dur": 50},
        {"cat": "user_annotation", "ph": "X", "name": "portbench.finish", "ts": -10, "dur": 460},
        {"cat": "user_annotation", "ph": "X", "name": "portbench.save_npz", "ts": 210, "dur": 150},
        {"cat": "cpu_op", "ph": "X", "name": "aten::mm", "ts": 500, "dur": 100},
        {"ph": "i", "name": "marker", "ts": 700},
    ]


def test_device_timeline_unions_device_intervals_over_every_timed_event():
    t = trace.device_timeline(_trace())
    # busy: [0, 100] + [150, 210] + [400, 450] = 210 us; window -10 .. 600
    assert t["busy_s"] == pytest.approx(210e-6)
    assert t["window_s"] == pytest.approx(610e-6)
    assert t["idle_share"] == pytest.approx(1 - 210 / 610)
    assert trace.device_timeline([])["idle_share"] == 1.0


def test_kernel_seconds_by_name_and_grid():
    ev = _trace()
    got = trace.kernel_seconds(ev, [{"name": r"\bpacked_attention_kernel\b", "grid": [None, None, 1]}])
    assert got == (pytest.approx(100e-6), 1)
    got = trace.kernel_seconds(ev, [{"name": r"\bgemm_kernel<"}, {"name": r"\bpacked_attention_kernel\b"}])
    assert got == (pytest.approx(150e-6), 3)  # the fp32 GEMM is not matched
    assert trace.kernel_seconds(ev, [{"name": "nothing"}]) == (0.0, 0)


def test_summaries_and_idle_gaps(tmp_path):
    ev = _trace()
    top = trace.top_device_ops(ev, 2)
    assert top[0][0] == "void pi3::packed_attention_kernel(x)"
    assert top[0][1] == pytest.approx(110e-6)
    gaps = trace.idle_gaps(ev)
    # [100, 150] under finish only; [210, 400] under save_npz (the innermost)
    assert gaps[0][0] == "portbench.save_npz" and gaps[0][1] == pytest.approx(190e-6)
    assert gaps[1][0] == "portbench.finish" and gaps[1][1] == pytest.approx(50e-6)
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    assert trace.load_events(str(path)) == ev


def test_host_spans_are_laid_onto_the_trace_by_the_marker():
    ev = [{"cat": "gpu_memcpy", "ph": "X", "name": "Memcpy HtoD", "ts": 5000, "dur": 2,
           "args": {"bytes": 7919, "correlation": 42}},
          {"cat": "gpu_memcpy", "ph": "X", "name": "Memcpy HtoD", "ts": 100, "dur": 2,
           "args": {"bytes": 64, "correlation": 7}},
          {"cat": "cuda_runtime", "ph": "X", "name": "cudaMemcpyAsync", "ts": 4990, "dur": 9,
           "args": {"correlation": 42}}]
    spans = [("portbench.dispatch", 10.0, 10.5), ("portbench.finish", 10.5, 11.0)]
    got = trace.host_span_events(ev, spans, t_mark=10.0, mark_bytes=7919)
    assert [g["name"] for g in got] == ["portbench.dispatch", "portbench.finish"]
    assert got[0]["ts"] == pytest.approx(4990) and got[0]["dur"] == pytest.approx(5e5)
    assert got[1]["ts"] == pytest.approx(4990 + 5e5)
    assert trace.host_span_events(ev[1:], spans, 10.0, 7919) == []
