"""The port's online viewer (``viz/visualizer.py``) and reprojection-debug
GIFs (``sfm/serialization.render_debug_projections``) against the JAX
package's, on the CPU.

* The viewer is a host-numpy copy: the same update sequence goes through
  both packages' ``SceneState`` and ``OnlineVisualizer(threaded=False)``,
  without viser (console lines equal) and with a recording stub module named
  ``viser`` (every GUI, scene and client-camera call equal, with its
  arguments; the one deliberate difference is the GUI's title line).
* The debug projections: on one reconstruction, the tracks picked, the
  observed and reprojected pixels drawn and the titles, through a recording
  stand-in for matplotlib's figure, within 1e-4 px (the errors in fp32 from
  two packages' ``reprojection_errors``); a real matplotlib GIF.

The online CLI with ``--visualize --save-debug-projections`` is held to the
JAX CLI in ``tests/test_torch_online.py`` (it shares that file's JAX
compilations of the quick synthetic system).
"""

import contextlib
import io
import os
import sys
import types

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


from pi3_slam_tpu.sfm import serialization as jax_ser  # noqa: E402
from pi3_slam_tpu.sfm.reconstruction import ChunkReconstruction as JaxRecon  # noqa: E402
from pi3_slam_tpu.viz import visualizer as jax_viz  # noqa: E402

from pi3_slam_tpu_torch.sfm import serialization as ser  # noqa: E402
from pi3_slam_tpu_torch.sfm.reconstruction import ChunkReconstruction  # noqa: E402
from pi3_slam_tpu_torch.viz import visualizer as viz  # noqa: E402

JAX_TITLE = "# Pi3SLAM (TPU) — live reconstruction"
PORT_TITLE = "# Pi3SLAM — live reconstruction"
PX_TOL = 1e-4  # drawn pixels: fp32 reprojection in two packages


def _norm(x):
    """A call argument as plain, comparable Python values."""
    if isinstance(x, np.ndarray) or np.isscalar(x) and isinstance(x, np.generic):
        return np.asarray(x).tolist()
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in sorted(x.items())}
    return x


class _Handle:
    def __init__(self, log, label, value):
        object.__setattr__(self, "_log", log)
        object.__setattr__(self, "label", label)
        object.__setattr__(self, "value", value)
        object.__setattr__(self, "callbacks", {})

    def on_click(self, fn):
        self.callbacks["click"] = fn
        return fn

    def on_update(self, fn):
        self.callbacks["update"] = fn
        return fn

    def __setattr__(self, name, value):
        self._log.append(("set", self.label, name, _norm(value)))
        object.__setattr__(self, name, value)


class _Recorder:
    """Logs every call on it as (prefix.name, args, kwargs)."""

    def __init__(self, log, prefix):
        self._log, self._prefix = log, prefix

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self._log.append((f"{self._prefix}.{name}", _norm(args), _norm(kwargs)))
        return call


class _Gui:
    def __init__(self, log):
        self._log, self.handles = log, {}

    def _add(self, kind, label, **kw):
        self._log.append((f"gui.{kind}", label, _norm(kw)))
        h = self.handles[label] = _Handle(self._log, label, kw.get("initial_value"))
        return h

    def add_markdown(self, text):
        self._log.append(("gui.add_markdown", text))

    def add_folder(self, label):
        self._log.append(("gui.add_folder", label))
        return contextlib.nullcontext()

    def add_checkbox(self, label, **kw):
        return self._add("checkbox", label, **kw)

    def add_slider(self, label, **kw):
        return self._add("slider", label, **kw)

    def add_text(self, label, **kw):
        return self._add("text", label, **kw)

    def add_button(self, label, **kw):
        return self._add("button", label, **kw)

    def add_image(self, label, **kw):
        return self._add("image", label, **kw)


def _viser_stub(log):
    """A module named ``viser`` that records what the viewer asks of it."""
    mod = types.ModuleType("viser")

    class ViserServer:
        def __init__(self, port, verbose=True):
            log.append(("ViserServer", port, verbose))
            self.gui, self.scene = _Gui(log), _Recorder(log, "scene")
            self.connect = self.disconnect = None
            mod.servers.append(self)

        def on_client_connect(self, fn):
            self.connect = fn
            return fn

        def on_client_disconnect(self, fn):
            self.disconnect = fn
            return fn

        def stop(self):
            log.append(("stop",))

    class SO3:
        def __init__(self, m):
            self.wxyz = tuple(np.asarray(m, np.float64).ravel()[:4])

        @classmethod
        def from_matrix(cls, m):
            return cls(m)

    mod.ViserServer, mod.servers = ViserServer, []
    mod.transforms = types.ModuleType("viser.transforms")
    mod.transforms.SO3 = SO3
    return mod


class _Client:
    def __init__(self, log):
        self.camera = _Handle(log, "client camera", None)


def _recon(rng, n_tracks, n_frames=4):
    """The viewer's view of a reconstruction: points, colors (0-255),
    track_valid, centers, rotations (world -> camera)."""
    q, _ = np.linalg.qr(rng.normal(size=(n_frames, 3, 3)))
    return types.SimpleNamespace(
        points=rng.normal(size=(n_tracks, 3)).astype(np.float32),
        colors=rng.integers(0, 256, (n_tracks, 3)).astype(np.float32),
        track_valid=(rng.random(n_tracks) > 0.2).astype(np.float32),
        centers=rng.normal(size=(n_frames, 3)).astype(np.float32),
        rotations=q.astype(np.float32))


def _drive(module, log, monkeypatch, with_viser):
    """The same update sequence through ``module``'s viewer; returns the
    state and the stdout lines."""
    rng = np.random.default_rng(3)
    if with_viser:
        stub = _viser_stub(log)
        monkeypatch.setitem(sys.modules, "viser", stub)
        monkeypatch.setitem(sys.modules, "viser.transforms", stub.transforms)
    monkeypatch.setattr(module, "_HAS_VISER", with_viser)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        vis = module.OnlineVisualizer(port=1234, max_current_points=60, max_history_points=150,
                                      threaded=False)
        client = _Client(log)
        if with_viser:
            server = stub.servers[-1]
            server.connect(client)
        frame = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
        for i in range(4):
            kps = rng.uniform(-2, 34, (10, 2)).astype(np.float32)
            vis.update(_recon(rng, 40 + 30 * i), frame=frame if i % 2 else None, keypoints=kps)
            if with_viser and i == 1:
                follow = server.gui.handles["Auto Follow"]
                follow.value = True
                follow.callbacks["update"](None)
                server.gui.handles["Reset View"].callbacks["click"](None)
                server.gui.handles["Follow Latest Camera"].callbacks["click"](None)
            if with_viser and i == 2:
                server.gui.handles["Show Point Cloud"].value = False
                server.gui.handles["Show Camera Poses"].value = False
        vis.show_mesh(rng.normal(size=(9, 3)), np.arange(9).reshape(3, 3),
                      rng.random((9, 3)))
        vis.close()
        if with_viser:
            server.disconnect(client)
    return vis.state, out.getvalue().splitlines()


def _same_state(a, b):
    for name in ("current_points", "current_colors", "history_points", "history_colors"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    np.testing.assert_array_equal(np.asarray(a.trajectory), np.asarray(b.trajectory))
    np.testing.assert_array_equal(np.asarray(a.cam_rotations), np.asarray(b.cam_rotations))
    np.testing.assert_array_equal(a.trajectory_segments(), b.trajectory_segments())
    assert _norm(a.camera_frustums()) == _norm(b.camera_frustums())
    assert a.chunk_count == b.chunk_count and a.total_points == b.total_points
    for x, y in zip(a.latest_camera(), b.latest_camera()):
        np.testing.assert_array_equal(x, y)
    assert _norm(a.mesh) == _norm(b.mesh)


def test_console_viewer_matches_jax(monkeypatch):
    """Without viser: the same state and the same console lines (one per
    chunk and one for the mesh)."""
    jstate, jlines = _drive(jax_viz, [], monkeypatch, with_viser=False)
    pstate, plines = _drive(viz, [], monkeypatch, with_viser=False)
    _same_state(pstate, jstate)
    assert plines == jlines
    assert sum(line.startswith("[viz] chunk") for line in plines) == 4
    assert plines[0] == "viser not available - console visualizer active (port 1234 unused)"
    np.testing.assert_array_equal(
        viz.follow_camera_pose(*pstate.latest_camera(), 0.8, 0.3)[0],
        jax_viz.follow_camera_pose(*jstate.latest_camera(), 0.8, 0.3)[0])


def test_viser_calls_match_jax(monkeypatch):
    """With a recording ``viser``: the same GUI, scene and client-camera
    calls with the same arguments (frustums, point layers, trajectory, mesh,
    keypoint image, statistics, follow-cam), the title line apart."""
    jlog, plog = [], []
    jstate, _ = _drive(jax_viz, jlog, monkeypatch, with_viser=True)
    pstate, _ = _drive(viz, plog, monkeypatch, with_viser=True)
    _same_state(pstate, jstate)
    assert ("gui.add_markdown", PORT_TITLE) in plog and len(plog) > 100
    assert plog == [("gui.add_markdown", PORT_TITLE) if e == ("gui.add_markdown", JAX_TITLE)
                    else e for e in jlog]
    kinds = {e[0] for e in plog}
    assert {"scene.add_point_cloud", "scene.add_camera_frustum", "scene.add_line_segments",
            "scene.add_mesh_simple", "scene.remove", "set", "stop"} <= kinds


# ----- debug projections -----


def _projection_recon(rng, n_frames=3, n_tracks=260, m=3, w=96, h=72):
    """A reconstruction whose tracks are seen from every frame (some
    observations invalid, some tracks dead), its cameras looking down +z."""
    rot = np.stack([np.eye(3)] * n_frames).astype(np.float32)
    centers = np.stack([[0.1 * i, 0.0, 0.0] for i in range(n_frames)]).astype(np.float32)
    intr = np.tile([80.0, 80.0, w / 2, h / 2], (n_frames, 1)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-1, 1, (n_tracks, 2)), rng.uniform(3, 6, (n_tracks, 1))],
                         axis=1).astype(np.float32)
    obs_frame = np.stack([rng.permutation(n_frames)[:m] for _ in range(n_tracks)]).astype(np.int32)
    uv = 80 * (pts[:, None, :2] - centers[obs_frame][..., :2]) / pts[:, None, 2:] + [w / 2, h / 2]
    arrays = dict(
        frame_names=[f"f{i}.png" for i in range(n_frames)], rotations=rot, centers=centers,
        intrinsics=intr, points=pts, colors=rng.random((n_tracks, 3)).astype(np.float32),
        track_frame=obs_frame[:, 0].copy(), track_kp=np.arange(n_tracks, dtype=np.int32),
        track_uv=uv[:, 0].astype(np.float32), track_valid=(rng.random(n_tracks) > 0.1).astype(np.float32),
        obs_frame=obs_frame, obs_uv=(uv + rng.normal(0, 1.5, uv.shape)).astype(np.float32),
        obs_valid=(rng.random((n_tracks, m)) > 0.15).astype(np.float32), image_width=w,
        image_height=h)
    return ChunkReconstruction(**arrays), JaxRecon(**arrays)


class _Figure:
    def savefig(self, buf, format):
        Image.new("RGB", (4, 3)).save(buf, format=format)


class _Axes:
    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self._log.append((name, [np.asarray(a) if isinstance(a, (np.ndarray, list)) else a
                                     for a in args], kwargs))
        return call


@contextlib.contextmanager
def _recording_figures():
    """matplotlib's figures replaced by recorders: yields the list of the
    axes' call logs, one per figure."""
    import matplotlib.pyplot as plt

    figures = []

    def subplots(*args, **kwargs):
        figures.append([])
        return _Figure(), _Axes(figures[-1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plt, "subplots", subplots)
        mp.setattr(plt, "close", lambda fig: None)
        yield figures


def _same_figures(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [c[0] for c in g] == [c[0] for c in w]
        for (name, gargs, gkw), (_, wargs, wkw) in zip(g, w):
            if name == "set_title":
                assert gargs == wargs
            elif name in ("scatter", "plot"):
                for a, b in zip(gargs, wargs):
                    np.testing.assert_allclose(a, b, rtol=0, atol=PX_TOL)
                assert gkw == wkw
            elif name == "imshow":
                np.testing.assert_array_equal(gargs[0], wargs[0])


def test_debug_projections_match_jax(tmp_path):
    """200 of 234 live tracks picked by default_rng(0) as JAX picks them; per
    frame the observed and reprojected pixels and the error segments within
    1e-4 px, and the titles with their mean errors, equal; the numeric part
    alone gives the JAX errors (1e-4 px)."""
    from pi3_slam_tpu.sfm.ba import reprojection_errors as jax_errors

    import jax as jax_lib

    port, jax = _projection_recon(np.random.default_rng(4))
    images = np.random.default_rng(5).random((3, 3, 72, 96)).astype(np.float32)
    with _recording_figures() as want, pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ser, "reprojection_errors", jax_lib.jit(jax_errors))  # one compile
        jax_ser.render_debug_projections(jax, images, str(tmp_path / "j.gif"))
    with _recording_figures() as got:
        ser.render_debug_projections(port, images, str(tmp_path / "p.gif"), device="cpu")
    _same_figures(got, want)
    assert os.path.exists(tmp_path / "p.gif")
    data = ser.debug_projection_data(port, 3, device="cpu")
    err = np.asarray(jax_errors(jax.to_problem()))
    picked = set()
    for d in data:
        np.testing.assert_allclose(d["errors"], err[d["rows"], d["cols"]], rtol=0, atol=PX_TOL)
        picked |= set(d["rows"].tolist())
    assert 150 < len(picked) <= 200 and (port.track_valid[list(picked)] > 0).all()


def test_debug_projections_write_a_gif(tmp_path):
    """With matplotlib's Agg backend: one GIF frame per image."""
    port, _ = _projection_recon(np.random.default_rng(4))
    images = np.random.default_rng(5).random((3, 3, 72, 96)).astype(np.float32)
    ser.render_debug_projections(port, images, str(tmp_path / "d" / "p.gif"), device="cpu")
    with Image.open(tmp_path / "d" / "p.gif") as gif:
        assert gif.n_frames == 3


def test_debug_projections_run_on_the_card_unless_told(tmp_path, monkeypatch):
    """Both functions take the card by default, as the port's entry points
    do: without one each raises, and only ``device="cpu"`` runs on the
    host."""
    import torch

    port, _ = _projection_recon(np.random.default_rng(4))
    images = np.random.default_rng(5).random((3, 3, 72, 96)).astype(np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ser.debug_projection_data(port, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ser.render_debug_projections(port, images, str(tmp_path / "p.gif"))
    assert not os.path.exists(tmp_path / "p.gif")
    assert len(ser.debug_projection_data(port, 3, device="cpu")) == 3
