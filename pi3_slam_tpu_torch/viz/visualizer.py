"""Online visualization: a viser scene with its GUI, camera frustums,
follow-cam and the latest frame with its keypoints; console lines when
``viser`` is not installed.

Port of ``pi3_slam_tpu/viz/visualizer.py``, whole and with its names: the
module is host numpy (``Pi3SLAMOnline`` hands it host arrays), so it is a
copy that imports nothing of the JAX package.

* ``SceneState`` accumulates the layers (current and history points with
  cap-based stride decimation, the trajectory, the last 20 frustums, the
  fused mesh) and the follow-cam math; it needs no viser.
* ``OnlineVisualizer`` takes non-blocking updates (``put_nowait`` on a
  bounded queue, dropped when the consumer is backed up), applies them on a
  ~10 Hz consumer thread, and renders the state through viser, or prints one
  ``[viz]`` line per chunk and mesh without it. ``show_mesh`` waits at most
  5 s for room in the queue, then applies the mesh inline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

try:
    import viser  # noqa: F401

    _HAS_VISER = True
except ImportError:
    _HAS_VISER = False


def render_keypoints_on_image(
    image: np.ndarray,
    keypoints: Optional[np.ndarray],
    point_radius: int = 4,
    line_thickness: int = 2,
    color: tuple = (0, 255, 0),
) -> np.ndarray:
    """Draw keypoint circles on an (H, W, 3) uint8 image
    (visualization/visualizer.py:22-52)."""
    if image is None or keypoints is None or len(keypoints) == 0:
        return image
    try:
        import cv2
    except ImportError:
        return image
    out = image.copy()
    kps = np.asarray(keypoints)
    if kps.ndim == 3:
        kps = kps.reshape(-1, kps.shape[-1])
    h, w = image.shape[:2]
    for x, y in kps[:, :2].astype(np.int32):
        if 0 <= x < w and 0 <= y < h:
            cv2.circle(out, (int(x), int(y)), point_radius, color, line_thickness)
    return out


def _decimate(points: np.ndarray, colors: Optional[np.ndarray], cap: int):
    """Stride decimation to <= cap points (reference :407-412)."""
    if points is None or len(points) <= cap:
        return points, colors
    step = max(1, len(points) // cap)
    idx = np.arange(0, len(points), step)[:cap]
    return points[idx], (colors[idx] if colors is not None and len(colors) else colors)


def follow_camera_pose(
    cam_pos: np.ndarray,
    cam_forward: np.ndarray,
    distance: float = 0.6,
    height: float = 0.2,
):
    """(viewer_position, look_at) behind and above the latest camera
    (visualization/visualizer.py:536-557)."""
    fwd = np.asarray(cam_forward, np.float64)
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    up = np.array([0.0, 0.0, 1.0])
    pos = np.asarray(cam_pos, np.float64) - fwd * float(distance) + up * float(height)
    return pos, np.asarray(cam_pos, np.float64)


@dataclass
class SceneState:
    """Accumulated visualization state: pure numpy, renderer-agnostic."""

    max_current_points: int = 200_000
    max_history_points: int = 1_000_000
    max_cameras_shown: int = 20

    current_points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    current_colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    history_points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    history_colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    trajectory: List[np.ndarray] = field(default_factory=list)
    cam_rotations: List[np.ndarray] = field(default_factory=list)  # world-from-camera R
    chunk_count: int = 0
    latest_frame: Optional[np.ndarray] = None
    latest_keypoints: Optional[np.ndarray] = None
    # fused TSDF mesh layer (mapping/; set once at finalization or
    # periodically) — dict with vertices (V,3), faces (F,3), colors (V,3)|None
    mesh: Optional[Dict] = None

    def set_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        colors: Optional[np.ndarray] = None,
    ) -> None:
        self.mesh = {
            "vertices": np.asarray(vertices, np.float32).reshape(-1, 3),
            "faces": np.asarray(faces, np.int32).reshape(-1, 3),
            "colors": None if colors is None else np.asarray(colors, np.float32).reshape(-1, 3),
        }

    def add_chunk(
        self,
        points: np.ndarray,
        colors: np.ndarray,
        centers: np.ndarray,
        rotations: Optional[np.ndarray] = None,
        frame: Optional[np.ndarray] = None,
        keypoints: Optional[np.ndarray] = None,
    ) -> None:
        """Fold one chunk's results in: previous current layer moves to
        history (with cap decimation), new points become current."""
        if len(self.current_points):
            self.history_points = np.concatenate([self.history_points, self.current_points])
            self.history_colors = np.concatenate([self.history_colors, self.current_colors])
            self.history_points, self.history_colors = _decimate(
                self.history_points, self.history_colors, self.max_history_points
            )
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        cols = np.asarray(colors, np.float32).reshape(-1, 3) if colors is not None else np.zeros_like(pts)
        self.current_points, self.current_colors = _decimate(pts, cols, self.max_current_points)
        self.trajectory.extend(np.asarray(centers, np.float32))
        if rotations is not None:
            self.cam_rotations.extend(np.asarray(rotations, np.float32))
        else:
            self.cam_rotations.extend([np.eye(3, dtype=np.float32)] * len(centers))
        self.chunk_count += 1
        if frame is not None:
            self.latest_frame = frame
            self.latest_keypoints = keypoints

    @property
    def total_points(self) -> int:
        return len(self.current_points) + len(self.history_points)

    def trajectory_segments(self) -> np.ndarray:
        """(S, 2, 3) consecutive-position line segments (reference :427-445)."""
        t = np.asarray(self.trajectory, np.float32)
        if len(t) < 2:
            return np.zeros((0, 2, 3), np.float32)
        return np.stack([t[:-1], t[1:]], axis=1)

    def camera_frustums(self):
        """Last-N frustum descriptors: (position, R_wc, color, is_latest)
        (reference :457-481: gold latest, red history)."""
        n = len(self.trajectory)
        start = max(0, n - self.max_cameras_shown)
        out = []
        for i in range(start, n):
            latest = i == n - 1
            out.append(
                {
                    "position": np.asarray(self.trajectory[i], np.float32),
                    "rotation": np.asarray(self.cam_rotations[i], np.float32),
                    "color": (1.0, 0.8, 0.0) if latest else (0.8, 0.2, 0.2),
                    "is_latest": latest,
                }
            )
        return out

    def latest_camera(self):
        """(position, forward) of the newest pose; forward = R[:, 2]."""
        if not self.trajectory:
            return None, None
        return (
            np.asarray(self.trajectory[-1], np.float64),
            np.asarray(self.cam_rotations[-1], np.float64)[:, 2],
        )


class OnlineVisualizer:
    """Incremental visualizer: non-blocking update() + ~10 Hz consumer thread
    rendering SceneState through viser (or console prints)."""

    def __init__(
        self,
        port: int = 8080,
        max_current_points: int = 200_000,
        max_history_points: int = 1_000_000,
        threaded: bool = True,
    ):
        import queue
        import threading

        self.port = port
        self.state = SceneState(
            max_current_points=max_current_points,
            max_history_points=max_history_points,
        )
        self._server = None
        self._gui: Dict[str, object] = {}
        self._clients = set()
        self.auto_follow = False
        self.follow_distance = 0.6
        self.follow_height = 0.2
        self._drawn_cameras = 0
        if _HAS_VISER:
            self._start_server()
        else:
            print(f"viser not available - console visualizer active (port {port} unused)")
        self._queue = queue.Queue(maxsize=4) if threaded else None
        self._stop = threading.Event()
        self._thread = None
        if threaded:
            self._thread = threading.Thread(target=self._consume_loop, daemon=True)
            self._thread.start()

    # ----- server / GUI ----------------------------------------------------

    def _start_server(self):
        import viser

        self._server = viser.ViserServer(port=self.port, verbose=False)
        gui = self._server.gui
        g = self._gui
        gui.add_markdown("# Pi3SLAM — live reconstruction")
        with gui.add_folder("Visualization Controls"):
            g["show_point_cloud"] = gui.add_checkbox("Show Point Cloud", initial_value=True)
            g["show_trajectory"] = gui.add_checkbox("Show Camera Trajectory", initial_value=True)
            g["show_cameras"] = gui.add_checkbox("Show Camera Poses", initial_value=True)
            g["show_mesh"] = gui.add_checkbox("Show Fused Mesh", initial_value=True)
            g["point_size"] = gui.add_slider("Point Size", min=0.001, max=0.05, step=0.001, initial_value=0.01)
            g["camera_size"] = gui.add_slider("Camera Size", min=0.01, max=0.2, step=0.01, initial_value=0.05)
        with gui.add_folder("SLAM Statistics"):
            g["stats_points"] = gui.add_text("Total Points", initial_value="0", disabled=True)
            g["stats_cameras"] = gui.add_text("Camera Poses", initial_value="0", disabled=True)
            g["stats_chunks"] = gui.add_text("Chunks Processed", initial_value="0", disabled=True)
        with gui.add_folder("Camera Controls"):
            reset_btn = gui.add_button("Reset View")
            follow_btn = gui.add_button("Follow Latest Camera")
            g["follow_toggle"] = gui.add_checkbox("Auto Follow", initial_value=False)
            g["follow_distance"] = gui.add_slider("Follow Distance (m)", min=0.1, max=2.0, step=0.05, initial_value=0.6)
            g["follow_height"] = gui.add_slider("Follow Height (m)", min=0.0, max=1.0, step=0.05, initial_value=0.2)

            @reset_btn.on_click
            def _(_):
                self._reset_view()

            @follow_btn.on_click
            def _(_):
                self._follow_latest()

            @g["follow_toggle"].on_update
            def _(_):
                self.auto_follow = g["follow_toggle"].value
        with gui.add_folder("Images"):
            g["show_latest_image"] = gui.add_checkbox("Show Latest Frame", initial_value=True)
            try:
                g["latest_image"] = gui.add_image("Latest Frame")
            except Exception:
                g["latest_image"] = None

        @self._server.on_client_connect
        def _on_connect(client):
            self._clients.add(client)
            try:
                client.camera.position = (5.0, 5.0, 3.0)
                client.camera.look_at = (0.0, 0.0, 0.0)
            except Exception:
                pass

        @self._server.on_client_disconnect
        def _on_disconnect(client):
            self._clients.discard(client)

    # ----- update path ------------------------------------------------------

    def update(self, recon, frame: Optional[np.ndarray] = None,
               keypoints: Optional[np.ndarray] = None) -> None:
        """Non-blocking: drop the update when the consumer is backed up
        (reference put_nowait semantics, online_reconstructor.py:1618-1622)."""
        payload = (
            recon.points[recon.track_valid > 0].copy(),
            recon.colors[recon.track_valid > 0].copy(),
            recon.centers.copy(),
            np.transpose(recon.rotations, (0, 2, 1)).copy(),  # R_cw -> R_wc
            frame,
            keypoints,
        )
        if self._queue is not None:
            try:
                self._queue.put_nowait(("chunk", payload))
            except Exception:
                pass  # queue full: drop, never stall the SLAM loop
            return
        self._apply_update(*payload)

    def show_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        colors: Optional[np.ndarray] = None,
    ) -> None:
        """Display a fused triangle mesh (mapping/ TSDF output) as its own
        scene layer. Bounded-blocking put — the mesh is a one-shot final
        artifact and should not be dropped like throttled chunk updates,
        but a dead/stopped consumer must not hang the SLAM process."""
        if self._queue is not None:
            import queue as _q

            try:
                self._queue.put(("mesh", (vertices, faces, colors)), timeout=5.0)
            except _q.Full:
                print("visualizer backed up; applying mesh inline")
                self._apply_mesh(vertices, faces, colors)
            return
        self._apply_mesh(vertices, faces, colors)

    def _apply_mesh(self, vertices, faces, colors) -> None:
        self.state.set_mesh(vertices, faces, colors)
        if self._server is not None:
            self._render()
        else:
            print(
                f"[viz] fused mesh: {len(self.state.mesh['vertices']):,} verts / "
                f"{len(self.state.mesh['faces']):,} faces"
            )

    def _consume_loop(self):
        import queue as _q
        import time as _t

        while not self._stop.is_set():
            try:
                kind, payload = self._queue.get(timeout=0.1)
            except _q.Empty:
                continue
            try:
                if kind == "mesh":
                    self._apply_mesh(*payload)
                else:
                    self._apply_update(*payload)
            except Exception as e:  # a render error must not kill the consumer
                print(f"visualizer update failed: {e}")
            _t.sleep(0.1)  # ~10 Hz throttle like the reference consumer

    def _apply_update(self, pts, cols, centers, rotations, frame, keypoints) -> None:
        self.state.add_chunk(pts, cols, centers, rotations, frame, keypoints)
        if self._server is not None:
            self._render()
        else:
            print(
                f"[viz] chunk {self.state.chunk_count}: +{pts.shape[0]} pts "
                f"(total {self.state.total_points:,}), "
                f"trajectory {len(self.state.trajectory)} poses"
            )

    # ----- rendering (viser only) -------------------------------------------

    def _gval(self, name, default):
        w = self._gui.get(name)
        try:
            return w.value if w is not None else default
        except Exception:
            return default

    def _render(self):
        s = self.state
        scene = self._server.scene
        point_size = float(self._gval("point_size", 0.01))
        cam_size = float(self._gval("camera_size", 0.05))

        if self._gval("show_point_cloud", True):
            for name, pts, cols in (
                ("/points/history", s.history_points, s.history_colors),
                ("/points/current", s.current_points, s.current_colors),
            ):
                if len(pts) == 0:
                    continue
                c = cols
                if c is not None and len(c) and c.max() > 1.0:
                    c = c.astype(np.float32) / 255.0
                scene.add_point_cloud(name, points=pts, colors=c, point_size=point_size)
        else:
            for name in ("/points/history", "/points/current"):
                self._try_remove(name)

        if s.mesh is not None and len(s.mesh["vertices"]) and self._gval("show_mesh", True):
            m = s.mesh
            try:
                # vertex colors when the viser build supports them
                self._server.scene.add_mesh_simple(
                    "/mesh", vertices=m["vertices"], faces=m["faces"],
                    vertex_colors=m["colors"],
                )
            except TypeError:
                col = (
                    tuple(np.median(m["colors"], axis=0))
                    if m["colors"] is not None
                    else (0.7, 0.7, 0.75)
                )
                self._server.scene.add_mesh_simple(
                    "/mesh", vertices=m["vertices"], faces=m["faces"], color=col
                )
        elif s.mesh is not None:
            self._try_remove("/mesh")

        if self._gval("show_trajectory", True):
            segs = s.trajectory_segments()
            if len(segs):
                colors = np.full_like(segs, (1.0, 0.2, 0.2), dtype=np.float32)
                scene.add_line_segments(
                    "/trajectory", points=segs, colors=colors, line_width=3.0
                )
        else:
            self._try_remove("/trajectory")

        if self._gval("show_cameras", True):
            import viser.transforms as vtf

            for i in range(self._drawn_cameras):
                self._try_remove(f"/cameras/{i}")
            frustums = s.camera_frustums()
            for i, f in enumerate(frustums):
                scene.add_camera_frustum(
                    f"/cameras/{i}",
                    fov=np.radians(60.0),
                    aspect=16 / 9,
                    scale=cam_size,
                    wxyz=vtf.SO3.from_matrix(f["rotation"]).wxyz,
                    position=f["position"],
                    color=f["color"],
                )
            self._drawn_cameras = len(frustums)
        else:
            for i in range(self._drawn_cameras):
                self._try_remove(f"/cameras/{i}")
            self._drawn_cameras = 0

        # statistics
        try:
            self._gui["stats_points"].value = f"{s.total_points:,}"
            self._gui["stats_cameras"].value = str(len(s.trajectory))
            self._gui["stats_chunks"].value = str(s.chunk_count)
        except Exception:
            pass

        # image panel with keypoint overlay
        if self._gval("show_latest_image", True) and self._gui.get("latest_image") is not None:
            if s.latest_frame is not None:
                try:
                    self._gui["latest_image"].image = render_keypoints_on_image(
                        s.latest_frame, s.latest_keypoints
                    )
                except Exception:
                    pass

        # auto-follow
        if self.auto_follow:
            self.follow_distance = float(self._gval("follow_distance", self.follow_distance))
            self.follow_height = float(self._gval("follow_height", self.follow_height))
            self._follow_latest()

    def _try_remove(self, name):
        try:
            self._server.scene.remove(name)
        except Exception:
            pass

    def _reset_view(self):
        for client in list(self._clients):
            try:
                client.camera.position = (5.0, 5.0, 3.0)
                client.camera.look_at = (0.0, 0.0, 0.0)
            except Exception:
                continue

    def _follow_latest(self):
        pos, fwd = self.state.latest_camera()
        if pos is None:
            return self._reset_view()
        vp, target = follow_camera_pose(pos, fwd, self.follow_distance, self.follow_height)
        for client in list(self._clients):
            try:
                client.camera.position = tuple(vp)
                client.camera.look_at = tuple(target)
            except Exception:
                continue

    # ----- lifecycle ---------------------------------------------------------

    def flush(self, timeout: float = 5.0) -> None:
        """Block until queued updates are applied (for tests/shutdown)."""
        import time as _t

        if self._queue is None:
            return
        t0 = _t.time()
        while not self._queue.empty() and _t.time() - t0 < timeout:
            _t.sleep(0.05)
        _t.sleep(0.15)  # let the in-flight item finish

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._server is not None:
            self._server.stop()
