"""Telemetry-derived BA priors: gravity directions and GPS position priors.

Port of ``pi3_slam_tpu/sfm/priors.py``. The reference lists gravity and GPS
residuals as roadmap items and ships telemetry importers
(``telemetry_converter.py``) that never reach its BA. Here the streams
become per-camera constraints for ``sfm/ba.py``:

  * gravity: the measured unit gravity direction in each camera frame is
    pulled toward R_cw @ g_world (BAProblem.gravity_dirs/_weight/_world) —
    a 2-DoF orientation constraint that removes the global roll/pitch
    gauge freedom and fights long-sequence orientation drift.
  * GPS: lat/lon/alt fixes interpolated at the frame timestamps, converted
    to a local ENU frame, and (after a Sim3 fit reconstruction -> ENU)
    applied as per-camera position priors (BAProblem.prior_centers/
    prior_pos_weight) — bounding translation drift and fixing metric scale
    against the geodetic track.

All builders are numpy-level (host-side, once per reconstruction). The GPS
Sim3 fit (``geometry/sim3.umeyama``) and the per-chunk refine BA run in fp32
on ``device`` (TF32 off: ``device.select_device``).
"""

from __future__ import annotations

import numpy as np
import torch

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)


def geodetic_to_enu(lat_lon_alt: np.ndarray, origin: np.ndarray | None = None):
    """(N, 3) [lat deg, lon deg, alt m] -> local ENU meters.

    Linearized about ``origin`` (default: the first fix) with the WGS84
    meridian/prime-vertical radii — centimeter-exact over the few-km extent
    a SLAM sequence covers. Returns (enu (N, 3), origin (3,)).
    """
    lla = np.asarray(lat_lon_alt, np.float64).reshape(-1, 3)
    if origin is None:
        origin = lla[0]
    lat0, lon0, alt0 = origin
    s = np.sin(np.radians(lat0))
    rn = _A / np.sqrt(1.0 - _E2 * s * s)  # prime vertical
    rm = _A * (1.0 - _E2) / (1.0 - _E2 * s * s) ** 1.5  # meridian
    east = np.radians(lla[:, 1] - lon0) * rn * np.cos(np.radians(lat0))
    north = np.radians(lla[:, 0] - lat0) * rm
    up = lla[:, 2] - alt0
    return np.stack([east, north, up], axis=1), np.asarray(origin, np.float64)


def gravity_priors(importer, frame_times: np.ndarray, sigma: float = 0.05):
    """Per-frame camera-frame unit gravity directions + 1/sigma^2 weights.

    ``importer``: utils/telemetry.TelemetryImporter with a gravity stream.
    Frames outside the telemetry time range get weight 0.
    """
    frame_times = np.asarray(frame_times, np.float64)
    g = importer.gravity_at_times(frame_times)  # (N, 3)
    norms = np.linalg.norm(g, axis=1)
    ok = norms > 1e-6
    t = importer.telemetry
    in_range = (frame_times >= t.grav_t[0]) & (frame_times <= t.grav_t[-1])
    ok &= in_range
    dirs = np.where(ok[:, None], g / np.maximum(norms, 1e-6)[:, None], 0.0)
    weights = np.where(ok, 1.0 / sigma**2, 0.0)
    return dirs.astype(np.float32), weights.astype(np.float32)


def estimate_world_gravity(rotations: np.ndarray, gravity_dirs: np.ndarray,
                           weights: np.ndarray | None = None) -> np.ndarray:
    """Consensus world-frame gravity from current poses and measurements.

    g_w ~ normalize(sum_n w_n R_cw_n^T g_cam_n). The reconstruction world
    frame is gravity-agnostic (first-camera gauge), so the world gravity
    axis must be estimated before the residuals can act. NOTE: a residual
    built against this consensus is gauge-INVARIANT (rotating the whole
    world rotates the consensus with it) — to constrain absolute roll/pitch
    the caller must first level the world frame onto the consensus
    (``constrain_with_telemetry`` does) and then hold g_world fixed at -z.
    """
    R = np.asarray(rotations, np.float64)
    g = np.asarray(gravity_dirs, np.float64)
    w = np.ones(len(R)) if weights is None else np.asarray(weights, np.float64)
    acc = np.einsum("nji,nj->i", R, w[:, None] * g)  # sum R^T g
    n = np.linalg.norm(acc)
    if n < 1e-9:
        return np.array([0.0, 0.0, -1.0], np.float32)
    return (acc / n).astype(np.float32)


def rotation_aligning(v_from: np.ndarray, v_to: np.ndarray) -> np.ndarray:
    """Minimal rotation R with R @ v_from = v_to (unit vectors, Rodrigues).

    Antiparallel inputs get a 180-degree rotation about an arbitrary
    orthogonal axis.
    """
    a = np.asarray(v_from, np.float64)
    a = a / np.linalg.norm(a)
    b = np.asarray(v_to, np.float64)
    b = b / np.linalg.norm(b)
    c = np.cross(a, b)
    d = float(np.dot(a, b))
    if d > 1.0 - 1e-12:
        return np.eye(3)
    if d < -1.0 + 1e-12:
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    K = np.array([[0, -c[2], c[1]], [c[2], 0, -c[0]], [-c[1], c[0], 0]])
    return np.eye(3) + K + K @ K / (1.0 + d)


def gps_priors(importer, frame_times: np.ndarray, sigma: float = 2.0,
               origin: np.ndarray | None = None):
    """Per-frame ENU position priors + 1/sigma^2 weights from the GPS stream.

    Frames outside the GPS time range get weight 0. Returns
    (centers_enu (N, 3) f32, weights (N,) f32, origin (3,) geodetic).
    """
    frame_times = np.asarray(frame_times, np.float64)
    lla = importer.gps_at_times(frame_times)
    enu, origin = geodetic_to_enu(lla, origin)
    t = importer.telemetry
    ok = (frame_times >= t.gps_t[0]) & (frame_times <= t.gps_t[-1])
    weights = np.where(ok, 1.0 / sigma**2, 0.0)
    return enu.astype(np.float32), weights.astype(np.float32), origin


def fit_sim3_to_gps(centers: np.ndarray, gps_enu: np.ndarray,
                    weights: np.ndarray | None = None,
                    min_gps_span_m: float = 1.0, device="cuda"):
    """Sim3 taking reconstruction-frame camera centers onto the ENU GPS track
    (geometry/sim3.umeyama in float32 on ``device``; weight-0 frames
    excluded).

    Returns the Sim3, or None when the fit would be degenerate: fewer than
    3 constrained frames, a point-like camera track, or a GPS track shorter
    than ``min_gps_span_m`` (a near-stationary GPS fit drives the scale
    toward 0 and would collapse the reconstruction).
    """
    from ..geometry.sim3 import umeyama

    c = np.asarray(centers, np.float64)
    g = np.asarray(gps_enu, np.float64)
    if weights is not None:
        keep = np.asarray(weights) > 0
        c, g = c[keep], g[keep]
    if len(c) < 3:
        return None
    if np.linalg.norm(c - c.mean(0), axis=1).max() < 1e-6:
        return None
    if np.linalg.norm(g - g.mean(0), axis=1).max() < min_gps_span_m:
        return None
    dev = torch.device(device)
    return umeyama(torch.as_tensor(c, dtype=torch.float32, device=dev),
                   torch.as_tensor(g, dtype=torch.float32, device=dev))


_VIDEO_FRAME = None  # compiled lazily


def frame_times_from_names(frame_names, importer) -> np.ndarray | None:
    """Second-based frame times for a reconstruction's frame names.

    Image-folder names carry filename timestamps
    (utils/timestamps.extract_timestamps_from_paths). Video-derived frames
    are named ``<video-stem>#<frame_idx>`` (data/image_io.list_video_frames)
    and map to idx / camera_fps using the telemetry's own fps (GPMF MVHD /
    the generic-JSON ``camera_fps`` field). Returns None (caller must skip
    telemetry) when video frames are present but no fps is known — silently
    treating frame indices as timestamps would pin every measurement to t=0.
    """
    global _VIDEO_FRAME
    import re

    from ..utils.timestamps import _filename_timestamp_ns

    if _VIDEO_FRAME is None:
        _VIDEO_FRAME = re.compile(r"^(.*)#(\d+)$")
    idxs = [_VIDEO_FRAME.match(str(nm)) for nm in frame_names]
    if all(m is not None for m in idxs) and idxs:
        fps = float(getattr(importer.telemetry, "camera_fps", 0.0) or 0.0)
        if fps <= 0:
            return None
        return np.asarray([int(m.group(2)) for m in idxs], np.float64) / fps
    # image folders: require a real filename timestamp on every frame. The
    # mtime / frame-index fallbacks of extract_timestamps_from_paths are
    # fine for ordering but are NOT on the telemetry clock — interpolating
    # measurements at them pulls every camera toward whatever sample sits
    # near t=0.
    ts = [_filename_timestamp_ns(str(nm)) for nm in frame_names]
    if any(t is None for t in ts):
        return None
    return np.asarray(ts, np.float64) * 1e-9


def constrain_with_telemetry(recons, importer, gps_sigma: float = 2.0,
                             gravity_sigma: float = 0.05,
                             refine_iterations: int = 20,
                             frame_times=None, device="cuda") -> dict:
    """Georeference + telemetry-constrained refine over chunk reconstructions.

    recons: list of sfm.reconstruction.ChunkReconstruction (modified in
    place). Frame times come from the recon frame names (image timestamps or
    video frame index / telemetry fps) unless ``frame_times`` (matching list
    of second-based arrays) overrides them. Steps: (1) a Sim3 fit of the
    stitched camera track onto the GPS ENU track (metric scale from
    geodesy) applied to every chunk — the world frame becomes ENU, where
    gravity is physically -z; without GPS, the world frame is instead
    leveled (a global rotation) onto the consensus gravity axis. (2) A
    per-chunk refine BA with GPS position priors and gravity-direction
    residuals against the FIXED world gravity [0, 0, -1] — fixing g_world
    (rather than re-estimating it from the rotations being optimized) is
    what makes the gravity term an absolute roll/pitch constraint instead
    of a gauge-invariant consistency term. Shared by the offline
    reconstructor (--telemetry) and the online mode's finalization. The Sim3
    fit and the refine BA run on ``device``.

    Returns {"gps", "gravity", "gps_rms_m", "refined_chunks", "notes"} —
    flags are True only when constraints actually acted (nonzero weights).
    """
    from .alignment import apply_sim3_to_reconstruction
    from .ba import run_bundle_adjust

    t = importer.telemetry
    has_gps = t.gps_t.size > 0 and gps_sigma > 0
    has_grav = t.grav_t.size > 0 and gravity_sigma > 0
    stats = {
        "gps": False, "gravity": False, "gps_rms_m": None,
        "refined_chunks": 0, "notes": [],
    }

    def note(msg):
        stats["notes"].append(msg)
        print(f"telemetry: {msg}")

    if not (has_gps or has_grav):
        note("no usable gravity/GPS streams; skipping")
        return stats
    if frame_times is None:
        frame_times = [frame_times_from_names(r.frame_names, importer) for r in recons]
        if any(ft is None for ft in frame_times):
            note("frame names carry no usable timebase (need filename "
                 "timestamps, or video frames + a telemetry fps); skipping")
            return stats

    # gravity measurements first: sampled at the frame times, they are
    # invariant to the world-frame transforms applied below
    grav = (
        [gravity_priors(importer, ft, gravity_sigma) for ft in frame_times]
        if has_grav else None
    )
    if grav is not None and not any(gw.sum() > 0 for _, gw in grav):
        note("no gravity measurements cover the frame times")
        grav = None

    gps_origin = None
    if has_gps:
        all_c = np.concatenate([r.centers for r in recons])
        all_t = np.concatenate(frame_times)
        enu, w, gps_origin = gps_priors(importer, all_t, gps_sigma)
        s3 = fit_sim3_to_gps(all_c, enu, weights=w, device=device)
        if s3 is None:
            note("GPS Sim3 fit degenerate (span/count); skipping GPS priors")
            has_gps = False
        else:
            for r in recons:
                apply_sim3_to_reconstruction(r, s3)
            fit = (
                float(s3.scale) * all_c @ s3.rotation.cpu().numpy().T
                + s3.translation.cpu().numpy()
            )
            rms = float(np.sqrt(np.mean(np.sum((fit - enu) ** 2, axis=1)[w > 0])))
            stats.update(gps=True, gps_rms_m=rms, scale=float(s3.scale),
                         origin=np.asarray(gps_origin).tolist())
            spread = enu[w > 0] - enu[w > 0].mean(0)
            sv = np.linalg.svd(spread, compute_uv=False)
            if sv[1] < max(1.0, 0.01 * sv[0]) and grav is None:
                note("GPS track is near-collinear: roll about the track "
                     "axis is GPS-underdetermined (gravity telemetry would "
                     "pin it)")

    down = np.array([0.0, 0.0, -1.0], np.float32)
    if grav is not None and not stats["gps"]:
        # no georeference: fix the orientation gauge by leveling the world
        # frame — one global rotation taking the consensus gravity axis
        # (estimated from ALL constrained cameras) onto -z. With GPS the
        # Sim3 above already made the world ENU, where gravity IS -z.
        g_hat = estimate_world_gravity(
            np.concatenate([r.rotations for r in recons]),
            np.concatenate([d for d, _ in grav]),
            np.concatenate([w for _, w in grav]),
        )
        from ..geometry.sim3 import Sim3

        s_lvl = Sim3(torch.tensor(1.0),
                     torch.as_tensor(rotation_aligning(g_hat, down), dtype=torch.float32),
                     torch.zeros(3))
        for r in recons:
            apply_sim3_to_reconstruction(r, s_lvl)
        note("leveled world frame onto the measured gravity axis")

    for i, r in enumerate(recons):
        priors = {}
        if has_gps:
            enu_i, w_i, _ = gps_priors(importer, frame_times[i], gps_sigma,
                                       origin=gps_origin)
            if w_i.sum() > 0:
                priors.update(prior_centers=enu_i, prior_pos_weight=w_i)
        if grav is not None:
            dirs_i, gw_i = grav[i]
            if gw_i.sum() > 0:  # only when measurements cover this chunk
                # g_world is FIXED at -z (leveled / ENU world): the residual
                # constrains absolute roll/pitch, not just consistency
                priors.update(gravity_dirs=dirs_i, gravity_weight=gw_i,
                              gravity_world=down)
                stats["gravity"] = True
        if not priors:
            continue
        kpf = (
            r.num_tracks // r.num_frames
            if r.num_tracks % r.num_frames == 0 else None
        )
        prob = r.to_problem(priors, device=device)
        prob = run_bundle_adjust(prob, refine_iterations, 3.0, tracks_per_frame=kpf)
        r.update_from_problem(prob)
        stats["refined_chunks"] += 1
    return stats
