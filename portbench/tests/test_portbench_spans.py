"""The split of the traced slice's idle time by the creator's stage
(``spans.py``) and its six readers, on a fabricated trace and spans."""

from collections import deque
from types import SimpleNamespace

import pytest

from portbench import manifest, spans, trace

READERS = {"loader_wait": "idle_in_loader_wait.offline", "upload": "idle_in_upload.offline",
           "launch": "idle_in_launch.offline", "finish": "idle_in_finish.offline",
           "save": "idle_in_save.offline", "unattributed": "idle_unattributed.offline"}
# a Unix time 5 ms after a base of the trace, and the perf_counter_ns beside it
ANCHOR = (10**9, 2500 * spans.BASE_INTERVAL_NS + 5_000_000)
CREATOR, LOADER = 11, 12


def _ns(us):
    """The perf_counter_ns that lands at trace time ``us``."""
    return ANCHOR[0] - 5_000_000 + int(us * 1e3)


def _span(i, name, t0, t1, parent=None, thread=CREATOR):
    return {"name": name, "start_ns": _ns(t0), "end_ns": _ns(t1), "id": i, "parent": parent,
            "chunk": 0, "thread": thread}


def _spans():
    return [
        _span(1, "chunk", 50, 950),
        _span(2, "creator.dispatch", 100, 400, 1),
        _span(3, "creator.upload", 120, 200, 2),
        _span(4, "pi3.encoder", 250, 300, 2),
        _span(5, "creator.save", 600, 800, 1),
        _span(6, "loader.decode", 100, 900, thread=LOADER),
        _span(7, "creator.loader_wait", -500, -100),  # outside the window
    ]


def _events():
    k = {"cat": "kernel", "ph": "X", "name": "k", "pid": 1, "tid": 7}
    return [{**k, "ts": 0, "dur": 100}, {**k, "ts": 150, "dur": 0},
            {**k, "ts": 900, "dur": 100},
            # the harness's own span, laid on after its timeline: not the window
            {"cat": "user_annotation", "ph": "X", "name": "portbench.dispatch", "ts": -300,
             "dur": 2000}]


def test_spans_are_laid_onto_the_trace_through_the_anchor():
    s = spans.on_trace(_spans(), ANCHOR)
    assert s[1]["ts"] == pytest.approx(100.0) and s[1]["end"] == pytest.approx(400.0)
    # a given base moves them by the difference
    s = spans.on_trace(_spans(), ANCHOR, base_ns=ANCHOR[1] - 5_000_000 - 1000)
    assert s[1]["ts"] == pytest.approx(101.0)


def test_a_span_with_its_own_anchor_maps_through_it():
    """A span read under a later wall clock (its own anchor 2 ms on) lands
    2 ms later; the others keep the run's anchor."""
    own = (ANCHOR[0], ANCHOR[1] + 2_000_000)
    got = spans.on_trace([{**_spans()[1], "anchor": own}, _spans()[4]], ANCHOR)
    assert got[0]["ts"] == pytest.approx(2100.0) and got[0]["end"] == pytest.approx(2400.0)
    assert got[1]["ts"] == pytest.approx(600.0)


def test_idle_time_goes_to_the_innermost_creator_span():
    """Idle [100, 900] us: the upload's 80, the dispatch's other 220 (its
    pi3.encoder child included) as the launch, the save's 200, and 300 under
    the chunk alone or no span; the loader thread's span charges nothing."""
    split = spans.idle_by_stage(_events(), _spans(), ANCHOR)
    assert split["window_s"] == pytest.approx(1000e-6)
    want = {"loader_wait": 0.0, "upload": 80e-6, "launch": 220e-6, "finish": 0.0,
            "save": 200e-6, "unattributed": 300e-6}
    assert split["idle_s"] == pytest.approx(want)


def test_nested_finish_stages_roll_up():
    s = [_span(1, "creator.finish", 100, 900), _span(2, "creator.sync", 100, 300, 1),
         _span(3, "creator.result", 300, 500, 1), _span(4, "unknown", 500, 600, 1)]
    split = spans.idle_by_stage(_events(), s, ANCHOR)
    assert split["idle_s"]["finish"] == pytest.approx(800e-6)


def _run(events):
    return SimpleNamespace(events=events, timeline=trace.device_timeline(events))


def test_the_six_readers_sum_to_the_idle_share(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: (_spans(), ANCHOR))
    events = _events()
    run = _run(events[:-1])
    shares = {b: manifest.metric_module(n).read(run) for b, n in READERS.items()}
    assert shares["upload"] == pytest.approx(8.0) and shares["save"] == pytest.approx(20.0)
    assert sum(shares.values()) == pytest.approx(100 * run.timeline["idle_share"])
    # the harness's spans appended after the timeline leave the split as it is
    events_with = _run(events[:-1])
    events_with.events.append(events[-1])
    again = {b: manifest.metric_module(n).read(events_with) for b, n in READERS.items()}
    assert again == pytest.approx(shares)
    for name in READERS.values():
        mod = manifest.metric_module(name)
        assert mod.NAME == name and mod.UNIT == "%"


def test_no_span_or_no_trace_reads_none(monkeypatch):
    for name in READERS.values():
        mod = manifest.metric_module(name)
        monkeypatch.setattr(spans, "program_spans", lambda: None)
        assert mod.read(_run(_events())) is None
        monkeypatch.setattr(spans, "program_spans", lambda: ([_spans()[-1]], ANCHOR))
        assert mod.read(_run(_events())) is None  # no span in the window
        assert mod.read(SimpleNamespace(events=None)) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """A program whose timing module keeps no spans reads None, with no error."""
    from pi3_slam_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "recorded_spans")
    assert spans.program_spans() is None


def test_the_program_recorder_is_read(monkeypatch):
    from pi3_slam_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "_buffer", deque(maxlen=timing.MAX_SPANS))
    timing.enable_spans(True)
    try:
        with timing.span("creator.save", chunk=4):
            pass
    finally:
        timing.enable_spans(False)
    got, anchor = spans.program_spans()
    assert [s["name"] for s in got] == ["creator.save"] and anchor == timing.clock_anchor()


def test_a_traced_run_splits_its_idle_share(tmpdir_env):
    """The whole harness at the tiny size on the CPU: the six shares are
    reported and sum to the idle share (all of the window, with no device)."""
    from portbench import harness
    from portbench.tests import tiny

    r = harness.run_cell("pi3-offline-7scenes", 2**31 + 11, 1.0, True, device="cpu",
                         bench=tiny.bench(), config=tiny.config("pi3-moge2"),
                         traffic=tiny.traffic())
    assert r["correct"]
    split = [r["metrics"][n]["value"] for n in READERS.values()]
    assert sum(split) == pytest.approx(r["metrics"]["idle_share.offline"]["value"], abs=1e-6)
