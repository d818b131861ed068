"""The port's online SLAM (``pi3_slam_tpu_torch.slam.online``, its CLI, video
input and timestamps) against the JAX package's, on the CPU.

The model is ``tests/test_pi3_model.py``'s ``TINY`` with ``make_tiny_params``
(one checkpoint written by the JAX package's ``save_pi3_checkpoint``, read by
both packages; the port converts it with ``pi3_state_from_jax``), over the
8-frame generator of ``tests/test_pipeline.py``, in fp32 on both sides.

* Dispatch side: per chunk, a padded 2-frame tail included, the pulled step
  outputs (after the tail is sliced back) and the chunk dict given to
  ``build_chunk_reconstruction``, key by key: fp32 forwards of the same
  weights in two frameworks, held to rtol 1e-5 / atol 1e-5 (measured
  <= 1.1e-6); masks, keypoints and paths exactly; fx / fy only for
  shape and finiteness (the focal solve is ill-posed on random-weight maps,
  ``tests/test_torch_chunk_creator.py``'s ``_check_intrinsics``).
* Consume side, on well-posed geometry: the quick synthetic system of
  ``tests/test_system_ape.py`` fed through both classes' ``_consume_build``
  / ``_consume_finish`` in place of the forward: the same alignments,
  trajectories within 1e-3 (the fp32 BA of two packages,
  ``tests/test_torch_reconstructor.py``), TUM stamps exactly.
* Drive modes within 1e-5 of each other (the JAX test's bound), chunk
  counts, the post-append and consumer error paths, the CLI, video input
  and timestamps.
* The CLI's viewer and debug flags on the same quick system: the JAX CLI's
  ``[viz]`` lines, its debug-projection frames and titles (matplotlib's
  figures recorded), ``--keep-viz-open`` until Ctrl-C.
"""

import contextlib
import glob
import io
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pi3_slam_online as jax_cli  # noqa: E402
from test_pi3_model import TINY, make_tiny_params  # noqa: E402
from test_system_ape import write_synthetic_chunks  # noqa: E402
from test_torch_viz import _recording_figures  # noqa: E402

from pi3_slam_tpu.data import image_io as jax_io  # noqa: E402
from pi3_slam_tpu.data.datasets import ChunkDataset as JaxChunkDataset  # noqa: E402
from pi3_slam_tpu.io.tum import read_tum_trajectory as jax_read_tum  # noqa: E402
from pi3_slam_tpu.models.convert import save_pi3_checkpoint  # noqa: E402
from pi3_slam_tpu.slam import online as jax_online  # noqa: E402
from pi3_slam_tpu.utils.timestamps import (  # noqa: E402
    extract_timestamps_from_paths as jax_timestamps,
)
from pi3_slam_tpu.viz import visualizer as jax_viz  # noqa: E402

from pi3_slam_tpu_torch import pi3_slam_online as cli  # noqa: E402
from pi3_slam_tpu_torch.data import image_io  # noqa: E402
from pi3_slam_tpu_torch.data.datasets import ChunkDataset  # noqa: E402
from pi3_slam_tpu_torch.io.tum import read_tum_trajectory  # noqa: E402
from pi3_slam_tpu_torch.models.pi3 import Pi3Config  # noqa: E402
from pi3_slam_tpu_torch.slam import online  # noqa: E402
from pi3_slam_tpu_torch.slam.config import OnlineConfig  # noqa: E402
from pi3_slam_tpu_torch.utils.timestamps import extract_timestamps_from_paths  # noqa: E402
from pi3_slam_tpu_torch.viz import visualizer as viz  # noqa: E402

PORT_TINY = Pi3Config.from_json(TINY.to_json())
# fp32 forwards of the same weights in two frameworks
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """tests/test_pipeline.py's 8 frames: one random image moving right."""
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(5)
    base = rng.integers(30, 220, (64, 84, 3)).astype(np.uint8)
    for i in range(8):
        Image.fromarray(np.roll(base, shift=3 * i, axis=1)).save(d / f"frame_{i:04d}.png")
    return str(d)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_pi3_checkpoint(path, make_tiny_params(), TINY)
    return path


def _kw(ckpt, **extra):
    return {**dict(chunk_length=4, overlap=2, pixel_limit=4000, use_metric_depth=False,
                   max_keypoints=30, compute_dtype="float32", checkpoint_path=ckpt), **extra}


def _port(tmp_path, ckpt, **extra):
    return online.Pi3SLAMOnline(
        OnlineConfig(output_dir=str(tmp_path / "port"), device="cpu", **_kw(ckpt, **extra)),
        pi3_config=PORT_TINY)


def _jax(tmp_path, ckpt, **extra):
    return jax_online.Pi3SLAMOnline(
        jax_online.OnlineConfig(output_dir=str(tmp_path / "jax"), **_kw(ckpt, **extra)),
        pi3_config=TINY)


def _paths(image_dir, n=8):
    return sorted(glob.glob(os.path.join(image_dir, "*.png")))[:n]


def _check_intrinsics(a, b):
    """cx, cy and the fixed entries exactly; fx, fy finite (module docstring)."""
    fixed = np.ones(a.shape[1:], bool)
    fixed[0, 0] = fixed[1, 1] = False
    np.testing.assert_array_equal(b[:, fixed], a[:, fixed])
    assert np.isfinite(b).all()


def _capture(slam, module, monkeypatch):
    """Record each chunk's pulled step outputs and the chunk dict given to
    build_chunk_reconstruction (``module``'s name for it)."""
    hosts, chunks = [], []
    build = slam._consume_build

    def spy_build(item, idx=None):
        ctx = build(item, idx)
        hosts.append(ctx["host"])
        return ctx

    real = module.build_chunk_reconstruction

    def spy_chunk(chunk, **kw):
        chunks.append(chunk)
        return real(chunk, **kw)

    slam._consume_build = spy_build
    monkeypatch.setattr(module, "build_chunk_reconstruction", spy_chunk)
    return hosts, chunks


def _same(key, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    if key == "intrinsics":
        _check_intrinsics(want, got)
    elif want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=key, **STEP_TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_dispatch_side_matches_jax(image_dir, ckpt, tmp_path, monkeypatch):
    """Windows (0, 4), (3, 7), (6, 8): the 2-frame tail is padded to 4 on
    both sides and sliced back."""
    port, jax = _port(tmp_path, ckpt, overlap=1), _jax(tmp_path, ckpt, overlap=1)
    got = _capture(port, online, monkeypatch)
    want = _capture(jax, jax_online, monkeypatch)
    port.process_image_paths(_paths(image_dir))
    jax.process_image_paths(_paths(image_dir))
    assert [len(x) for x in got + want] == [3] * 4
    for g, w in zip(got[0] + got[1], want[0] + want[1]):  # step outputs, then chunk dicts
        # the JAX step also returns the focal solve's raw focal and shift,
        # which no consumer reads; the port's step does not
        assert set(g) == set(w) - {"focal", "shift"}
        for key in g:
            if key in ("original_width", "original_height"):
                assert g[key] == w[key]
            else:
                _same(key, g[key], w[key])
    assert [c["camera_poses"].shape[0] for c in got[1]] == [4, 4, 2]


def _stub_dispatch(slam, chunks_dir, H, W, with_ready):
    """Serve the synthetic chunk files in place of the device step (as
    tests/test_system_ape.py's eval-scale online test does)."""
    by_name = {}
    for f in sorted(glob.glob(os.path.join(chunks_dir, "chunk_*.npz"))):
        with np.load(f) as z:
            by_name[str(z["image_paths"][0])] = {k: z[k] for k in z.files}

    def dispatch(batch):
        d = by_name[os.path.basename(batch["paths"][0])]
        assert batch["images"].shape == (d["camera_poses"].shape[0], 3, H, W)
        slam._produced += 1
        item = {"dev": {"camera_poses": d["camera_poses"], "points_kp": d["points"],
                        "colors_kp": d["colors"], "intrinsics": d["intrinsics"]},
                "moge_depth": None, "kps": d["keypoints"].astype(np.float32), "batch": batch}
        item.update({"ready": None} if with_ready else {"det": None})
        return item

    slam._dispatch_device = dispatch


def test_consume_side_matches_jax_on_the_quick_system(tmp_path, rng, ckpt):
    """14 frames, chunks of 6 with overlap 2 (a 2-frame tail), through both
    classes' build and finish stages; the port's BA on the CPU."""
    W, H = 644, 476  # multiples of 14: the loader's resize is the identity
    gt = write_synthetic_chunks(tmp_path, rng, width=W, height=H)
    frames = tmp_path / "frames"
    frames.mkdir()
    im = Image.fromarray(np.full((H, W, 3), 127, np.uint8))
    paths = []
    for i in range(len(gt)):
        paths.append(str(frames / f"frame_{i:04d}.png"))
        im.save(paths[-1])
    kw = _kw(ckpt, chunk_length=6, overlap=2, pixel_limit=W * H, max_keypoints=120,
             max_observations_per_track=8)
    kw.pop("checkpoint_path")
    port = online.Pi3SLAMOnline(OnlineConfig(output_dir=str(tmp_path / "p"), device="cpu", **kw),
                                pi3_config=PORT_TINY)
    jax = jax_online.Pi3SLAMOnline(jax_online.OnlineConfig(output_dir=str(tmp_path / "j"), **kw),
                                   pi3_config=TINY)
    _stub_dispatch(port, tmp_path / "chunks", H, W, with_ready=True)
    _stub_dispatch(jax, tmp_path / "chunks", H, W, with_ready=False)
    got, want = port.process_image_paths(paths), jax.process_image_paths(paths)
    assert got["num_chunks"] == want["num_chunks"] == 4
    assert got["num_frames"] == want["num_frames"]
    assert [(a.method, a.num_common_tracks, a.success) for a in port.alignment_results] == [
        (a.method, a.num_common_tracks, a.success) for a in jax.alignment_results]
    np.testing.assert_allclose(port._merged_trajectory()[0], jax._merged_trajectory()[0],
                               atol=1e-3)
    np.testing.assert_allclose(port._merged_trajectory()[1], jax._merged_trajectory()[1],
                               atol=1e-3)
    stamps = {os.path.basename(p): 1.5 + 0.25 * i for i, p in enumerate(paths)}
    for kw in ({}, {"name_to_timestamp": stamps}):
        port.save_trajectory_tum(str(tmp_path / "p.txt"), **kw)
        jax.save_trajectory_tum(str(tmp_path / "j.txt"), **kw)
        a, b = read_tum_trajectory(str(tmp_path / "p.txt")), jax_read_tum(str(tmp_path / "j.txt"))
        np.testing.assert_array_equal(a["timestamps"], b["timestamps"])
        assert a["positions"].shape == (len(gt), 3)


def _served(cls, chunks_dir, H, W, with_ready):
    """``cls.__init__`` followed by ``_stub_dispatch``: the synthetic chunks
    in place of the forward."""
    init = cls.__init__

    def __init__(self, *a, **kw):
        init(self, *a, **kw)
        _stub_dispatch(self, chunks_dir, H, W, with_ready=with_ready)
    return __init__


@pytest.fixture(scope="module")
def viewer_run(tmp_path_factory, ckpt):
    """Both online CLIs with --visualize --save-debug-projections over the
    quick synthetic system of the consume-side test (the same chunks and
    settings, so the JAX CLI reuses its compilations), served in place of
    the forward, so the reconstructions are well posed: their stdout lines
    and debug figures (matplotlib's figures recorded)."""
    tmp = tmp_path_factory.mktemp("viz_cli")
    W, H = 644, 476  # multiples of 14: the loader's resize is the identity
    n = len(write_synthetic_chunks(tmp, np.random.default_rng(0), width=W, height=H))
    frames = tmp / "frames"
    frames.mkdir()
    im = Image.fromarray(np.full((H, W, 3), 127, np.uint8))
    for i in range(n):
        im.save(frames / f"frame_{i:04d}.png")
    argv = ["--images", str(frames), "--model-path", ckpt, "--chunk-length", "6", "--overlap",
            "2", "--max-kp", "120", "--pixel-limit", str(W * H), "--device", "cpu",
            "--compute-dtype", "float32", "--no-metric-depth", "--tum-integer-timestamps",
            "--max-observations-per-track", "8"]
    runs = {}
    made = []

    class Recorded(jax_viz.OnlineVisualizer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, _recording_figures() as figures, \
                contextlib.redirect_stdout(out):
            mp.setattr(jax_viz, "OnlineVisualizer", Recorded)
            mp.setattr(jax_viz, "_HAS_VISER", False)
            mp.setattr(viz, "_HAS_VISER", False)
            mp.setattr(online.Pi3SLAMOnline, "__init__",
                       _served(online.Pi3SLAMOnline, tmp / "chunks", H, W, True))
            mp.setattr(jax_online.Pi3SLAMOnline, "__init__",
                       _served(jax_online.Pi3SLAMOnline, tmp / "chunks", H, W, False))
            assert main(argv + ["--visualize", "--save-debug-projections", "--output",
                                str(tmp / name)]) == 0
            for vis in made:  # the JAX CLI returns without flushing its viewer
                vis.flush()
                vis.close()
        runs[name] = {"lines": out.getvalue().splitlines(), "figures": figures,
                      "out": tmp / name}
    runs["argv"], runs["served"] = argv, (tmp / "chunks", H, W)
    return runs


def _viz_lines(lines):
    return [line for line in lines if line.startswith("[viz]")]


@pytest.mark.parametrize("flag", ["--visualize", "--keep-viz-open", "--save-debug-projections"])
def test_cli_runs_the_viewer_flags(viewer_run, flag, tmp_path, monkeypatch, capsys):
    """--visualize: the JAX CLI's [viz] lines, one a chunk. --keep-viz-open:
    the CLI waits until Ctrl-C, then writes its outputs. --save-debug-projections:
    one GIF a chunk, as many frames as the chunk, the JAX CLI's titles."""
    port, jax = viewer_run["port"], viewer_run["jax"]
    if flag == "--visualize":
        assert _viz_lines(port["lines"]) == _viz_lines(jax["lines"])
        assert sum(line.startswith("[viz] chunk") for line in port["lines"]) == 4
    elif flag == "--keep-viz-open":
        def ctrl_c(seconds):
            raise KeyboardInterrupt

        monkeypatch.setattr(viz, "_HAS_VISER", False)
        monkeypatch.setattr(cli, "time", types.SimpleNamespace(sleep=ctrl_c))
        monkeypatch.setattr(online.Pi3SLAMOnline, "__init__",
                            _served(online.Pi3SLAMOnline, *viewer_run["served"], True))
        assert cli.main(viewer_run["argv"] + ["--visualize", "--keep-viz-open", "--output",
                                            str(tmp_path / "k")]) == 0
        out = capsys.readouterr().out
        assert "visualization server on port 8080; Ctrl-C to exit" in out
        assert os.path.exists(tmp_path / "k" / "trajectory_tum.txt")
    else:
        gifs = sorted(os.listdir(port["out"] / "debug_projections"))
        assert gifs == sorted(os.listdir(jax["out"] / "debug_projections")) == [
            f"chunk_{i:06d}.gif" for i in range(4)]
        titles = [[c[1][0] for c in fig if c[0] == "set_title"] for fig in port["figures"]]
        assert [len(t) for t in titles] == [1] * (6 + 6 + 6 + 2)  # a figure a frame
        assert titles == [[c[1][0] for c in fig if c[0] == "set_title"]
                          for fig in jax["figures"]]


def _threads_named(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


def test_drive_modes_agree(image_dir, ckpt, tmp_path):
    """Sync, pipelined (depth 1 on the calling thread) and async (build on
    the sfm-build executor, finish on the sfm-consumer thread) give one
    trajectory and the same queue counts."""
    runs = {}
    for mode in ("sync", "pipelined", "async"):
        slam = _port(tmp_path / mode, ckpt, chunk_length=3, overlap=1, max_keypoints=20,
                     async_sfm=mode == "async")
        threads = {"build": set(), "finish": set()}
        build, finish = slam._consume_build, slam._consume_finish

        def spy_build(item, idx=None, _b=build, _t=threads):
            _t["build"].add(threading.current_thread().name.split("_")[0])
            return _b(item, idx)

        def spy_finish(ctx, _f=finish, _t=threads):
            _t["finish"].add(threading.current_thread().name)
            return _f(ctx)

        slam._consume_build, slam._consume_finish = spy_build, spy_finish
        r = slam.process_image_paths(_paths(image_dir, 6), pipelined=mode != "sync")
        status = slam.queue_status()
        runs[mode] = (r, slam._merged_trajectory()[0], threads,
                      {k: status[k] for k in ("chunks_produced", "chunks_consumed",
                                              "chunks_inflight", "alignments")})
    assert runs["async"][2] == {"build": {"sfm-build"}, "finish": {"sfm-consumer"}}
    assert runs["sync"][2] == runs["pipelined"][2] == {"build": {"MainThread"},
                                                       "finish": {"MainThread"}}
    for mode in ("pipelined", "async"):
        assert runs[mode][0]["num_chunks"] == runs["sync"][0]["num_chunks"] == 3
        assert runs[mode][3] == runs["sync"][3] == {
            "chunks_produced": 3, "chunks_consumed": 3, "chunks_inflight": 0, "alignments": 2}
        np.testing.assert_allclose(runs[mode][1], runs["sync"][1], atol=1e-5)
    assert not _threads_named("sfm-")


def test_chunk_counts_match_the_jax_online_test(image_dir, ckpt, tmp_path):
    """tests/test_pipeline.py test_online_mode: windows (0, 4), (2, 6),
    (4, 8), (6, 8) are 4 chunks and 14 frames; the padded tail keeps its 2
    real frames."""
    slam = _port(tmp_path, ckpt)
    r = slam.process_image_paths(_paths(image_dir))
    assert (r["num_chunks"], r["num_frames"]) == (4, 14)
    assert [rec.num_frames for rec in slam.reconstructions] == [4, 4, 4, 2]
    assert slam._merged_trajectory()[0].shape == (8, 3)


def test_post_append_failure_leaves_no_duplicate_chunk(image_dir, ckpt, tmp_path, monkeypatch):
    """A failing side effect after the chunk joined the chain (the debug
    reconstruction dump) is printed and skipped: every chunk is appended
    exactly once and each frame appears once in the merged trajectory."""
    calls = {"n": 0}

    def explode(recon, path):
        calls["n"] += 1
        raise OSError("disk full")

    monkeypatch.setattr(online, "save_reconstruction", explode)
    slam = _port(tmp_path, ckpt, save_debug_recons=True)
    r = slam.process_image_paths(_paths(image_dir))
    assert calls["n"] == 4
    assert r["num_chunks"] == len(slam.reconstructions) == 4
    names = [n for rec in slam.reconstructions for n in rec.frame_names]
    assert max(names.count(n) for n in set(names)) <= 2
    _, _, merged = slam._merged_trajectory(return_names=True)
    assert len(merged) == len(set(merged)) == 8


def test_consumer_error_reaches_the_caller(image_dir, ckpt, tmp_path):
    """An error in the async consumer's finish stage reaches the caller of
    process_image_paths; the chunk is not consumed again, and neither the
    sfm-consumer thread nor its sfm-build worker outlives the call."""
    slam = _port(tmp_path, ckpt)
    finish = slam._consume_finish
    calls = {"n": 0}

    def flaky(ctx):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return finish(ctx)

    slam._consume_finish = flaky
    with pytest.raises(RuntimeError, match="illegal memory access"):
        slam.process_image_paths(_paths(image_dir))
    assert calls["n"] == 2 and len(slam.reconstructions) == 1
    assert not _threads_named("sfm-")


def test_sfm_backend_and_unported_parts_are_refused(ckpt, tmp_path, capsys):
    """A bad sfm_backend and the multi-device parts are refused; the viewer
    is made (console lines without viser, as the JAX class does)."""
    with pytest.raises(ValueError, match="sfm_backend"):
        online.Pi3SLAMOnline(OnlineConfig(device="cpu", sfm_backend="tpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1: multi-device"):
        _port(tmp_path, ckpt, data_parallel_chunks=2)
    slam = _port(tmp_path, ckpt, visualize=True, viz_port=8123)
    assert slam.visualizer is not None
    if not viz._HAS_VISER:
        assert "console visualizer active (port 8123 unused)" in capsys.readouterr().out
    slam.visualizer.close()


# ----- the CLI -----


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_cli_has_every_jax_option_with_its_default():
    assert _options(jax_cli.build_parser()) <= _options(cli.build_parser())
    want = vars(jax_cli.build_parser().parse_args(["--images", "x"]))
    got = vars(cli.build_parser().parse_args(["--images", "x"]))
    assert got.pop("device") == "cuda"
    want.pop("device")
    assert got == want


@pytest.mark.parametrize("flags,entry", [
    (["--data-parallel-chunks", "2"], "multi-device"),
    (["--tensor-parallel", "2"], "multi-device"),
    (["--sequence-parallel", "2"], "multi-device"),
])
def test_cli_refuses_unported_flags(tmp_path, capsys, flags, entry):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--images", str(tmp_path), "--output", str(tmp_path / "out"),
                  "--device", "cpu"] + flags)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err and "ROADMAP.md" in err and entry in err
    assert not (tmp_path / "out").exists()


def test_cli_no_visualization_wins_and_input_is_required(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:  # --visualize turned off, then no input
        cli.main(["--visualize", "--no-visualization", "--output", str(tmp_path)])
    assert exc.value.code == 2
    assert "exactly one of --images / --video" in capsys.readouterr().err


def test_cli_default_device_without_a_gpu_raises(image_dir, ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--images", image_dir, "--model-path", ckpt, "--output", str(tmp_path)])


@pytest.mark.parametrize("integer", [False, True])
def test_cli_writes_the_jax_clis_stamps(tmp_path, ckpt, integer):
    """Frames named by 19-digit nanosecond stamps; both CLIs write the same
    TUM stamps (seconds from the names, or with --tum-integer-timestamps the
    frame indices) and the same files."""
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(2)
    for i in range(6):
        img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        Image.fromarray(img).save(frames / f"{1_600_000_000_000_000_000 + i * 33_333_333}.png")
    common = ["--images", str(frames), "--model-path", ckpt, "--chunk-length", "4",
              "--overlap", "2", "--max-kp", "20", "--pixel-limit", "3000", "--device", "cpu",
              "--compute-dtype", "float32", "--no-metric-depth", "--save-tum"]
    common += ["--tum-integer-timestamps"] if integer else []
    assert jax_cli.main(common + ["--output", str(tmp_path / "j")]) == 0
    result = cli.run_online(common + ["--output", str(tmp_path / "p")])
    assert result["num_chunks"] == 3 and result["queue_status"]["chunks_inflight"] == 0
    for name in ("trajectory_tum.txt", "trajectory.tum"):
        a = read_tum_trajectory(str(tmp_path / "p" / name))
        b = jax_read_tum(str(tmp_path / "j" / name))
        np.testing.assert_array_equal(a["timestamps"], b["timestamps"])
        assert a["positions"].shape == (6, 3) and np.isfinite(a["positions"]).all()
    stamps = read_tum_trajectory(str(tmp_path / "p" / "trajectory_tum.txt"))["timestamps"]
    want = np.arange(6.0) if integer else 1.6e9 + np.arange(6) * 0.033333333
    np.testing.assert_allclose(stamps, want, rtol=0, atol=1e-6)
    assert os.path.exists(tmp_path / "p" / "final_points.ply")


# ----- video input and timestamps -----


@pytest.fixture(scope="module")
def video_path(tmp_path_factory):
    """tests/test_video_io.py's MJPG clip: frame i has intensity 2 i."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("vid") / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    assert w.isOpened()
    for i in range(120):
        w.write(np.full((48, 64, 3), min(i * 2, 255), np.uint8))
    w.release()
    return path


def test_video_frames_match_jax(video_path):
    for kw in ({}, {"skip_start": 3, "skip_end": 5, "stride": 2}):
        assert image_io.list_video_frames(video_path, **kw) == jax_io.list_video_frames(
            video_path, **kw)
    idx = [40, 10, 30, 20]
    for dtype in ("float32", "uint8"):
        got = image_io.load_video_frames_bulk(video_path, idx, (42, 56), dtype=dtype)
        want = jax_io.load_video_frames_bulk(video_path, idx, (42, 56), dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    image_io._thread_videos.cache = {}
    n0 = image_io.VIDEO_OPEN_COUNT["n"]
    for i in range(0, 40, 4):
        image_io.read_video_frame(video_path, i)
    assert image_io.VIDEO_OPEN_COUNT["n"] - n0 == 1  # one persistent decoder


def test_video_chunk_dataset_matches_jax(video_path):
    frames = image_io.list_video_frames(video_path, stride=2)
    target = image_io.calculate_target_size(frames[0], 2000)
    assert target == jax_io.calculate_target_size(frames[0], 2000)
    got, want = ChunkDataset(frames, 10, 2, target), JaxChunkDataset(frames, 10, 2, target)
    assert len(got) == len(want)
    for i in (0, len(want) - 1):
        g, w = got[i], want[i]
        assert g["paths"] == w["paths"] and g["paths"][0] == f"{video_path}#{frames[8 * i][1]}"
        assert g["images"].dtype == w["images"].dtype == np.uint8
        np.testing.assert_array_equal(g["images"], w["images"])


@pytest.mark.parametrize("digits", range(10, 20))
def test_filename_timestamps_match_jax(tmp_path, digits):
    """10-19 digit stamps in the name (14 and 15 digits fall back to the
    file's mtime; a missing file to its index)."""
    names = [str(tmp_path / f"img_{'7' * digits}_{i}.png") for i in range(3)]
    for n in names[:2]:
        open(n, "w").close()
    assert extract_timestamps_from_paths(names) == jax_timestamps(names)


def test_video_timestamps_match_jax(video_path):
    frames = image_io.list_video_frames(video_path, stride=7)
    got = extract_timestamps_from_paths(frames)
    assert got == jax_timestamps(frames)
    assert got[1] == int(7 / 30 * 1e9)
