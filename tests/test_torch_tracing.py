"""The port's span recorder (``utils/timing.py``) on the CPU.

Off, it keeps nothing and ``TimingStats`` keeps its totals; on, each span
carries its parent's id and its chunk's id, loader threads included, and the
buffer stays bounded. It is on inside a ``torch.profiler`` session and off
after it, and its spans, laid onto the session's Chrome trace through the
clock anchor, land on the ``cpu_op`` events they enclose. A tiny creator run
under the profiler gives every stage span of a chunk, in order, under the
chunk's id, and each record's ``infer_s`` is its ``creator.dispatch`` start
to its ``creator.sync`` end. The online driver's stages carry chunk ids, its
SfM consumer's queue wait is tracked, and both reach a trace of the
operator's own profiler session and ``trace_summary``'s by-span table. Each
span maps through the clock pair read at its own open, so a later session
does not reuse an earlier one's.
"""

import json
import sys
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from pi3_slam_tpu_torch import create_offline_chunks as torch_cli
from pi3_slam_tpu_torch.data import ChunkDataset, PrefetchLoader
from pi3_slam_tpu_torch.utils import timing
from test_torch_chunk_creator import _tiny_moge_npz
from test_torch_cli import _tiny_checkpoint_and_frames


@pytest.fixture(autouse=True)
def _fresh_recorder(monkeypatch):
    """Each test starts with the recorder off and a buffer of its own."""
    timing.enable_spans(False)
    monkeypatch.setattr(timing, "_buffer", deque(maxlen=timing.MAX_SPANS))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    timing.enable_spans(False)


def _by(spans, key="name"):
    out = {}
    for s in spans:
        out.setdefault(s[key], []).append(s)
    return out


def test_off_records_nothing_and_keeps_the_totals():
    stats = timing.TimingStats()
    assert not timing.spans_on()
    with stats.track("a", chunk=1) as s:
        with timing.span("b") as inner:
            time.sleep(0.002)
    assert inner is None and s.id is None
    assert s.seconds >= 0.002 and stats.totals["a"] == s.seconds and stats.counts["a"] == 1
    assert timing.recorded_spans() == []


def test_parent_and_chunk_ids_on_the_main_thread():
    stats = timing.TimingStats()
    timing.enable_spans(True)
    with stats.track("chunk", chunk=3) as root:
        with timing.span("creator.dispatch") as d:
            with timing.span("pi3.encoder"):
                pass
        with timing.span("other", chunk=7):
            pass
    with timing.span("loose"):
        pass
    got = _by(timing.recorded_spans())
    assert [s["name"] for s in timing.recorded_spans()] == [
        "chunk", "creator.dispatch", "pi3.encoder", "other", "loose"]
    assert got["chunk"][0]["id"] == root.id and got["chunk"][0]["parent"] is None
    assert got["creator.dispatch"][0]["parent"] == root.id
    assert got["pi3.encoder"][0]["parent"] == d.id
    assert {got[n][0]["chunk"] for n in ("chunk", "creator.dispatch", "pi3.encoder")} == {3}
    assert got["other"][0]["chunk"] == 7 and got["other"][0]["parent"] == root.id
    assert got["loose"][0]["chunk"] is None and got["loose"][0]["parent"] is None
    assert stats.counts["chunk"] == 1
    assert {s["thread"] for s in timing.recorded_spans()} == {threading.get_native_id()}
    for s in timing.recorded_spans():
        assert s["end_ns"] >= s["start_ns"]


def test_loader_threads_record_their_chunk(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(7):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)).save(paths[-1])
    timing.enable_spans(True)
    ds = ChunkDataset(paths, 3, 1, (14, 28))
    got = [b["chunk_idx"] for b in PrefetchLoader(ds, num_workers=2)]
    assert got == [0, 1, 2]
    decode = _by(timing.recorded_spans())["loader.decode"]
    assert sorted(s["chunk"] for s in decode) == [0, 1, 2]
    assert all(s["parent"] is None for s in decode)
    assert threading.get_native_id() not in {s["thread"] for s in decode}


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(timing, "_buffer", deque(maxlen=8))
    timing.enable_spans(True)
    for i in range(20):
        with timing.span("s", chunk=i):
            pass
    spans = timing.recorded_spans()
    assert len(spans) == 8 and [s["chunk"] for s in spans] == list(range(12, 20))


def test_threads_record_every_span_with_unique_ids():
    """More threads than cores, a short switch interval: no span is lost and
    each thread's parents are its own."""
    timing.enable_spans(True)
    interval = sys.getswitchinterval()
    n_threads, n_spans = 16, 200

    def work(k):
        for i in range(n_spans):
            with timing.span("outer", chunk=k):
                with timing.span("inner"):
                    pass

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = timing.recorded_spans()
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s["id"] for s in spans}) == len(spans)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "inner":
            parent = by_id[s["parent"]]
            assert parent["name"] == "outer" and parent["thread"] == s["thread"]
            assert parent["chunk"] == s["chunk"]


def test_on_inside_a_profiler_session_and_off_after_it():
    with timing.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.spans_on()
        with timing.span("inside"):
            pass
    assert not timing.spans_on()
    with timing.span("after"):
        pass
    assert [s["name"] for s in timing.recorded_spans()] == ["inside"]
    assert timing.clock_anchor() is not None


def test_spans_land_on_the_cpu_ops_they_enclose(tmp_path):
    """Spans mapped through the anchor fall within 1 ms of the ``cpu_op``
    events of the same blocks in the session's trace; the default base is
    the trace's own."""
    a = torch.rand(96, 96)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(4):
            with timing.span("block", chunk=i):
                torch.mm(a, a)
            time.sleep(0.005)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    anchor = timing.clock_anchor()
    base = trace["baseTimeNanoseconds"]
    spans = timing.recorded_spans()
    assert timing.trace_us(spans[0]["start_ns"], anchor) == timing.trace_us(
        spans[0]["start_ns"], anchor, base)
    ops = sorted((e for e in trace["traceEvents"]
                  if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"),
                 key=lambda e: float(e["ts"]))
    assert len(ops) == len(spans) == 4
    for s, op in zip(spans, ops):
        t0, t1 = timing.trace_us(s["start_ns"], anchor), timing.trace_us(s["end_ns"], anchor)
        op0, op1 = float(op["ts"]), float(op["ts"]) + float(op["dur"])
        assert abs(op0 - t0) < 1000 and abs(t1 - op1) < 1000
        assert t0 - 1000 <= op0 and op1 <= t1 + 1000


STAGES = ["creator.loader_wait", "chunk", "creator.dispatch", "creator.upload",
          "creator.keypoints", "creator.upload", "pi3.encoder", "pi3.decoder", "pi3.heads",
          "step.post", "moge.forward", "creator.finish", "creator.sync", "creator.result",
          "creator.save"]


def test_a_creator_run_under_the_profiler_gives_every_stage_span(tmp_path):
    argv = _tiny_checkpoint_and_frames(tmp_path, metric_depth=True) + [
        "--moge-path", _tiny_moge_npz(str(tmp_path / "moge.npz"))]
    with profile(activities=[ProfilerActivity.CPU]):
        records = torch_cli.create_chunks(argv)
    assert len(records) == 3
    spans = timing.recorded_spans()
    main = threading.get_native_id()
    by_id = {s["id"]: s for s in spans}
    for k, rec in enumerate(records):
        mine = [s for s in spans if s["chunk"] == k and s["thread"] == main]
        assert [s["name"] for s in mine] == STAGES
        named = _by(mine)
        root, disp = named["chunk"][0], named["creator.dispatch"][0]
        finish, sync = named["creator.finish"][0], named["creator.sync"][0]
        assert root["parent"] is None and named["creator.loader_wait"][0]["parent"] is None
        for n in ("creator.dispatch", "creator.finish", "creator.save"):
            assert named[n][0]["parent"] == root["id"]
        for n in ("creator.upload", "creator.keypoints", "pi3.encoder", "pi3.decoder",
                  "pi3.heads", "step.post", "moge.forward"):
            assert all(s["parent"] == disp["id"] for s in named[n])
        assert sync["parent"] == finish["id"] and named["creator.result"][0]["parent"] == \
            finish["id"]
        assert rec["infer_s"] == pytest.approx((sync["end_ns"] - disp["start_ns"]) / 1e9,
                                               rel=1e-9, abs=1e-9)
        assert rec["aliked_s"] is None
        decode = [s for s in spans if s["name"] == "loader.decode" and s["chunk"] == k]
        assert len(decode) == 1 and decode[0]["thread"] != main
    assert all(by_id.get(s["parent"]) is not None for s in spans if s["parent"] is not None)


def test_profile_dir_merges_the_spans_into_the_trace(tmp_path):
    """--profile-dir records the spans of chunk 1 and writes them into its
    trace as user_annotation events inside the traced window."""
    prof = tmp_path / "prof"
    rc = torch_cli.main(_tiny_checkpoint_and_frames(tmp_path) + ["--profile-dir", str(prof)])
    assert rc == 0 and not timing.spans_on()
    with open(prof / "chunk_trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in spans}
    assert {"chunk", "creator.dispatch", "creator.sync", "creator.save", "pi3.encoder",
            "step.post"} <= names
    assert {e["args"]["chunk"] for e in spans if e["name"] != "loader.decode"} == {1}
    timed = [e for e in events if "dur" in e and e.get("cat") != "user_annotation"]
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e-3 for e in spans)


def test_online_stages_carry_chunk_ids_and_the_queue_wait_is_tracked(tmp_path):
    from pi3_slam_tpu_torch.slam.config import OnlineConfig
    from pi3_slam_tpu_torch.slam.online import Pi3SLAMOnline

    argv = _tiny_checkpoint_and_frames(tmp_path)
    frames = tmp_path / "frames"
    slam = Pi3SLAMOnline(OnlineConfig(
        output_dir=str(tmp_path / "online"), device="cpu",
        checkpoint_path=argv[argv.index("--model-path") + 1], chunk_length=3, overlap=1,
        pixel_limit=800, use_metric_depth=False, max_keypoints=20, compute_dtype="float32",
        async_sfm=True))
    timing.enable_spans(True)
    r = slam.process_image_paths(sorted(str(p) for p in frames.glob("*.png")))
    assert r["num_chunks"] == 3
    stats = slam.queue_status()["timing"]
    assert stats["online.queue_wait"]["count"] == 4  # three chunks and the end
    got = _by(timing.recorded_spans())
    for name in ("dispatch", "materialize", "metric_scale", "reconstruction", "alignment"):
        assert sorted(s["chunk"] for s in got[name]) == [0, 1, 2], name
    assert sorted(s["chunk"] for s in got["online.queue_wait"] if s["chunk"] is not None) == [
        0, 1, 2]
    consumer = {s["thread"] for s in got["online.queue_wait"]}
    assert len(consumer) == 1 and consumer != {threading.get_native_id()}


def test_merged_spans_take_the_thread_id_the_trace_gives_their_cuda_calls(tmp_path):
    """A thread the profiler knows only by its pthread id (its CUDA runtime
    events carry the id's low 32 bits) gets its spans in that lane, so the
    by-span table can match their launches; a thread named by its native id
    keeps it."""
    timing.enable_spans(True)
    ids = {}

    def worker():
        ids["pthread"] = threading.get_ident() & 0xFFFFFFFF
        with timing.span("moge.forward"):
            time.sleep(0.001)

    with timing.span("creator.dispatch"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    timing.enable_spans(False)
    spans = timing.recorded_spans()
    lo = min(timing.trace_us(s["start_ns"], timing.clock_anchor()) for s in spans) - 10
    hi = max(timing.trace_us(s["end_ns"], timing.clock_anchor()) for s in spans) + 10
    main = threading.get_native_id()
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": lo,
               "dur": 1.0, "pid": 1, "tid": main},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": hi,
               "dur": 1.0, "pid": 1, "tid": ids["pthread"]}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert timing.add_spans_to_trace(str(path)) == 2
    merged = {e["name"]: e["tid"] for e in json.loads(path.read_text())["traceEvents"]
              if e["cat"] == "user_annotation"}
    assert merged == {"creator.dispatch": main, "moge.forward": ids["pthread"]}


def test_each_session_maps_its_spans_through_its_own_anchor(tmp_path, monkeypatch):
    """Spans of a later session, read under a wall clock 5 s on, keep that
    clock: each span carries the pair read at its open, the merge maps each
    through its own, and a span of the earlier session falls outside the
    later trace's window."""
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("first"):
            pass
    first = timing.clock_anchor()
    shifted = type("Clock", (), {"perf_counter_ns": staticmethod(time.perf_counter_ns),
                                 "time_ns": staticmethod(lambda: time.time_ns() + 5 * 10**9)})
    monkeypatch.setattr(timing, "time", shifted)
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("second"):
            time.sleep(0.001)
    spans = _by(timing.recorded_spans())
    a1, a2 = spans["first"][0]["anchor"], spans["second"][0]["anchor"]
    assert a1 == first and timing.clock_anchor() == a2
    assert (a2[1] - a2[0]) - (a1[1] - a1[0]) == pytest.approx(5e9, abs=1e7)
    s = spans["second"][0]
    t0, t1 = timing.trace_us(s["start_ns"], a2), timing.trace_us(s["end_ns"], a2)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "op", "ts": t0 - 100, "dur": t1 - t0 + 200,
         "pid": 1, "tid": 1}]}))
    assert timing.add_spans_to_trace(str(path)) == 1
    merged = [e for e in json.loads(path.read_text())["traceEvents"]
              if e["cat"] == "user_annotation"]
    assert [e["name"] for e in merged] == ["second"]
    assert merged[0]["ts"] == pytest.approx(t0) and merged[0]["dur"] == pytest.approx(t1 - t0)


def test_the_online_driver_s_spans_reach_a_profile_and_its_by_span_table(tmp_path):
    """The operator's view of the online driver: a torch.profiler session
    around ``process_image_paths``, the spans merged into its trace, and
    ``trace_summary``'s by-span table, each stage under its chunk's id."""
    from pi3_slam_tpu_torch.slam.config import OnlineConfig
    from pi3_slam_tpu_torch.slam.online import Pi3SLAMOnline
    from pi3_slam_tpu_torch.tools import trace_summary

    argv = _tiny_checkpoint_and_frames(tmp_path)
    slam = Pi3SLAMOnline(OnlineConfig(
        output_dir=str(tmp_path / "online"), device="cpu",
        checkpoint_path=argv[argv.index("--model-path") + 1], chunk_length=3, overlap=1,
        pixel_limit=800, use_metric_depth=False, max_keypoints=20, compute_dtype="float32",
        async_sfm=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = slam.process_image_paths(sorted(str(p) for p in (tmp_path / "frames").glob("*.png")))
    assert r["num_chunks"] == 3
    path = str(tmp_path / "online_trace.json")
    prof.export_chrome_trace(path)
    assert timing.add_spans_to_trace(path) > 0
    with open(path) as f:
        merged = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"
                  and "span_id" in (e.get("args") or {})]
    table = trace_summary.summarize(path)["by_span"]
    for name in ("dispatch", "materialize", "metric_scale", "reconstruction", "alignment",
                 "online.queue_wait"):
        assert table[name]["count"] >= 3 and table[name]["host_us"] > 0, name
    for name in ("dispatch", "materialize", "reconstruction", "alignment"):
        assert sorted(e["args"]["chunk"] for e in merged if e["name"] == name) == [0, 1, 2]

