"""The port's telemetry priors (``pi3_slam_tpu_torch/sfm/priors.py``), its
telemetry importers and exporters (``utils/telemetry.py``) and its GPMF
parser (``utils/gpmf.py``) against the JAX package's, on the CPU, and the
``--telemetry`` runs of the offline reconstructor and the online class.

The same numpy inputs go through both. The numpy-level builders (ENU
conversion, gravity and GPS priors, the world-gravity consensus, the
leveling rotation, frame times), the importers and the GPMF parser give
equal arrays and the exporters equal bytes. The GPS Sim3 fit is float32 on
both sides (relative 1e-5). ``constrain_with_telemetry`` refines each chunk
with a fp32 BA whose weak GPS priors (sigma 0.5 m) hold its gauge only
loosely: on the quick system's chained chunks a 1e-6 m perturbation of the
points (float32 rounding) moves JAX's own refined centers by 1.8e-3 m, so
the port's are held within 5e-3 m and its rotations within 5e-3 of JAX's.
Gravity alone fixes roll and pitch only; the same perturbation moves JAX's
centers by 1.0e-2 m after a similarity, so the port's are held within 2e-2
m after one, and its gravity directions within 5e-3. Before the refine (the
georeference or the leveling alone) both agree within 1e-5.
The reconstructor CLI with ``--telemetry`` adds the chunk BAs and the Sim3
chain before the georeference; at GPS sigma 0.05 m the priors hold the
refine, and its trajectory lies within 1e-3 m of the JAX CLI's on a 5.6 m
track.
"""

import copy
import dataclasses
import json
import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import reconstruct_offline as jax_cli  # noqa: E402
from test_gpmf import build_mp4, klv, klv_container  # noqa: E402
from test_system_ape import write_synthetic_chunks  # noqa: E402

from pi3_slam_tpu.io import read_tum_trajectory as jax_read_tum  # noqa: E402
from pi3_slam_tpu.sfm import priors as jpri  # noqa: E402
from pi3_slam_tpu.sfm.reconstruction import build_chunk_reconstruction as jbuild  # noqa: E402
from pi3_slam_tpu.utils import gpmf as jgpmf  # noqa: E402
from pi3_slam_tpu.utils import telemetry as jtel  # noqa: E402

from pi3_slam_tpu_torch import reconstruct_offline as cli  # noqa: E402
from pi3_slam_tpu_torch.io.tum import read_tum_trajectory  # noqa: E402
from pi3_slam_tpu_torch.sfm import priors as tpri  # noqa: E402
from pi3_slam_tpu_torch.sfm.reconstruction import ChunkReconstruction  # noqa: E402
from pi3_slam_tpu_torch.utils import gpmf as tgpmf  # noqa: E402
from pi3_slam_tpu_torch.utils import telemetry as ttel  # noqa: E402

N_FRAMES, YAW = 14, 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are chains of small
    operations, which the oversubscribed thread pools of parallel test
    workers slow down a hundredfold; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _importers(grav=None, gps=None, fps=0.0):
    """The same streams in a JAX importer and in the port's."""
    out = []
    for mod in (jtel, ttel):
        imp, t = mod.TelemetryImporter(), mod.TelemetryData()
        if grav is not None:
            t.grav_t, t.grav = grav
        if gps is not None:
            t.gps_t, t.gps = gps
        t.camera_fps = fps
        imp.telemetry = t
        out.append(imp)
    return out


def _same_telemetry(got, want):
    for f in dataclasses.fields(jtel.TelemetryData):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)


def _gps_track(rng, n=30):
    ts = np.linspace(0.0, 10.0, n)
    lla = np.stack([48.0 + 1e-5 * ts + rng.normal(size=n) * 1e-7,
                    11.0 + 2e-5 * np.sin(ts / 3) + rng.normal(size=n) * 1e-7,
                    500.0 + 0.3 * ts], axis=1)
    return ts, lla


# ----- the numpy-level builders -----


def test_geodetic_gravity_and_gps_priors_equal_jax(rng):
    ts, lla = _gps_track(rng)
    g = np.tile([0.2, 0.1, -9.8], (len(ts), 1)) + rng.normal(size=(len(ts), 3)) * 0.1
    jimp, timp = _importers(grav=(ts, g), gps=(ts, lla))
    for origin in (None, np.array([48.0, 11.0, 490.0])):
        for a, b in zip(tpri.geodetic_to_enu(lla, origin), jpri.geodetic_to_enu(lla, origin)):
            np.testing.assert_array_equal(a, b)
    frame_t = np.array([-1.0, 0.0, 2.5, 7.25, 10.0, 11.0])
    for a, b in zip(tpri.gravity_priors(timp, frame_t, 0.1),
                    jpri.gravity_priors(jimp, frame_t, 0.1)):
        np.testing.assert_array_equal(a, b)
    got, want = tpri.gps_priors(timp, frame_t, 2.0), jpri.gps_priors(jimp, frame_t, 2.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1][0] == 0.0 and got[1][-1] == 0.0 and (got[1][1:5] > 0).all()


def test_world_gravity_and_rotation_aligning_equal_jax(rng):
    R = Rotation.random(20, random_state=1).as_matrix()
    g = np.einsum("nij,j->ni", R, [0.1, -0.2, -0.97]) + rng.normal(size=(20, 3)) * 0.01
    w = rng.uniform(0, 2, 20)
    for weights in (None, w, np.zeros(20)):
        np.testing.assert_array_equal(tpri.estimate_world_gravity(R, g, weights),
                                      jpri.estimate_world_gravity(R, g, weights))
    v = np.array([0.3, -0.4, 0.866])
    for to in (v, -v, np.array([0.0, 0.0, -1.0]), np.array([1.0, 0.0, 0.0])):
        np.testing.assert_array_equal(tpri.rotation_aligning(v, to), jpri.rotation_aligning(v, to))
    x = np.array([1.0, 0.0, 0.0])
    np.testing.assert_array_equal(tpri.rotation_aligning(x, -x), jpri.rotation_aligning(x, -x))


def test_fit_sim3_to_gps_matches_jax(rng):
    ts, lla = _gps_track(rng)
    jimp, timp = _importers(gps=(ts, lla))
    frame_t = np.linspace(-1.0, 11.0, 25)
    enu, w, _ = jpri.gps_priors(jimp, frame_t, 2.0)
    rot = Rotation.from_euler("zyx", [0.7, 0.1, -0.2]).as_matrix()
    centers = (enu @ rot.T) * 0.5 + np.array([3.0, -2.0, 1.0]) + rng.normal(size=enu.shape) * 0.01
    want = jpri.fit_sim3_to_gps(centers, enu, weights=w)
    got = tpri.fit_sim3_to_gps(centers, enu, weights=w, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.scale), 2.0, rtol=1e-2)
    # the degenerate fits: fewer than 3 constrained frames, a point-like
    # camera track, a near-stationary GPS track
    for args in ((centers[:2], enu[:2]), (np.zeros_like(centers), enu),
                 (centers, np.zeros_like(enu) + 0.01)):
        assert tpri.fit_sim3_to_gps(*args, device="cpu") is None
        assert jpri.fit_sim3_to_gps(*args) is None


def test_frame_times_from_names_equal_jax():
    ts = np.linspace(0.0, 2.0, 5)
    jimp, timp = _importers(grav=(ts, np.tile([0, 0, -1.0], (5, 1))), fps=30.0)
    cases = [[f"go.mp4#{i}" for i in (0, 30, 60)], ["0000000000500.png", "0000000001500.png"],
             ["1403636579763555584.png"], ["frame_0001.png"], ["0000000000500.png", "frame_2.png"]]
    for names in cases:
        got = tpri.frame_times_from_names(names, timp)
        want = jpri.frame_times_from_names(names, jimp)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    for imp in (jimp, timp):
        imp.telemetry.camera_fps = 0.0
    assert tpri.frame_times_from_names(cases[0], timp) is None


# ----- the importers, exporters and the GPMF parser -----


def _write_formats(tmp_path, rng):
    t = np.arange(0, 1.0, 0.05)
    flat = {"accelerometer": np.c_[t, rng.normal(size=(20, 3))].tolist(),
            "gyroscope": np.c_[t, rng.normal(size=(20, 3))].tolist(),
            "gravity": np.c_[t, np.tile([0, 0, -9.81], (20, 1))].tolist(),
            "gps": np.c_[t, np.tile([48.0, 11.0, 500.0], (20, 1)) + t[:, None] * 1e-5].tolist(),
            "camera_fps": 30.0}
    (tmp_path / "flat.json").write_text(json.dumps(flat))
    samples = [{"value": list(rng.normal(size=4)), "cts": 100.0 * i} for i in range(5)]
    gps = [{"value": [48.0 + i * 1e-5, 11.0, 500.0, 1.0, 0.5], "cts": 100.0 * i,
            "fix": 0 if i == 2 else 3} for i in range(5)]
    streams = {k: {"samples": samples} for k in ("ACCL", "GYRO", "GRAV", "CORI")}
    streams["GPS5"] = {"samples": gps}
    (tmp_path / "gopro.json").write_text(json.dumps({"1": {"streams": streams}}))
    rows = ["#header"] + [",".join(f"{v:.6f}" for v in [0.01 * i, *rng.normal(size=6)])
                          for i in range(6)]
    (tmp_path / "imu.csv").write_text("\n".join(rows))
    lines = [json.dumps({"timestamp": 1_000_000_000 + 10_000_000 * i,
                         "linear_acceleration": list(rng.normal(size=3)),
                         "angular_velocity": list(rng.normal(size=3))}) for i in range(4)]
    (tmp_path / "zed.jsonl").write_text("\n".join(lines) + "\n")


def _sensor(key, arr, typ, scal=None):
    arr = np.asarray(arr)
    dt = {b"s": ">i2", b"f": ">f4", b"L": ">u4", b"l": ">i4"}[typ]
    inner = b"" if scal is None else klv(b"SCAL", b"s", 2, 1, struct.pack(">h", scal))
    inner += klv(key, typ, arr.shape[1] * np.dtype(dt).itemsize, arr.shape[0],
                 arr.astype(dt).tobytes())
    return klv_container(b"STRM", inner)


def _gopro_mp4(path, rng):
    """A GoPro-style MP4 with every stream the importer reads: ACCL and GYRO
    (int16 with SCAL), GRAV, CORI, GPS5 (float) and GPSF (a no-fix
    payload)."""
    payloads = []
    for i in range(3):
        devc = b"".join([
            _sensor(b"ACCL", rng.integers(-1000, 1000, (10, 3)), b"s", 100),
            _sensor(b"GYRO", rng.integers(-1000, 1000, (10, 3)), b"s", 100),
            _sensor(b"GRAV", rng.normal(size=(6, 3)), b"f"),
            _sensor(b"CORI", rng.normal(size=(6, 4)), b"f"),
            _sensor(b"GPSF", [[0 if i == 1 else 3]], b"L"),
            _sensor(b"GPS5", np.c_[48.0 + rng.normal(size=(4, 1)) * 1e-4, np.full((4, 1), 11.0),
                                   rng.normal(size=(4, 3))], b"f"),
        ])
        payloads.append(klv_container(b"DEVC", devc))
    path.write_bytes(build_mp4(payloads))
    return str(path)


@pytest.mark.parametrize("fmt", ["flat.json", "gopro.json", "imu.csv", "zed.jsonl", "clip.mp4"])
def test_importers_and_exporters_equal_jax(tmp_path, rng, fmt):
    """load_telemetry on each format, the interpolation helpers where the
    streams exist, and both exporters (equal bytes)."""
    _write_formats(tmp_path, rng)
    if fmt == "clip.mp4":
        _gopro_mp4(tmp_path / fmt, rng)
    src = str(tmp_path / fmt)
    timp, jimp = ttel.load_telemetry(src), jtel.load_telemetry(src)
    _same_telemetry(timp.telemetry, jimp.telemetry)
    t = timp.telemetry
    times = np.linspace(-0.1, 3.1, 9)
    if t.grav_t.size:
        np.testing.assert_array_equal(timp.gravity_at_times(times), jimp.gravity_at_times(times))
    if t.gps_t.size:
        np.testing.assert_array_equal(timp.gps_at_times(times), jimp.gps_at_times(times))
    if fmt in ("gopro.json", "clip.mp4"):
        assert t.gps_t.size and t.grav_t.size and t.cori.shape[1] == 4
    for exporter, name in (("to_json", "out.json"), ("to_kalibr_csv", "out.csv")):
        getattr(ttel.TelemetryConverter(timp), exporter)(str(tmp_path / "port" / name))
        getattr(jtel.TelemetryConverter(jimp), exporter)(str(tmp_path / "jax" / name))
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_gpmf_parser_equals_jax(tmp_path, rng):
    path = _gopro_mp4(tmp_path / "clip.mp4", rng)
    got, want = tgpmf.parse_gpmf_mp4(path), jgpmf.parse_gpmf_mp4(path)
    assert got.keys() == want.keys() and len(got["payloads"]) == 3
    for key in want:
        if key != "payloads":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for gp, wp in zip(got["payloads"], want["payloads"]):
        gs, ws = tgpmf.extract_streams(gp), jgpmf.extract_streams(wp)
        assert gs.keys() == ws.keys()
        for k in ws:
            for a, b in zip(gs[k]["data"], ws[k]["data"]):
                np.testing.assert_array_equal(a, b)
    got, want = tgpmf.gopro_telemetry_from_mp4(path), jgpmf.gopro_telemetry_from_mp4(path)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["gps"].shape == (8, 3)  # the no-fix payload's fixes dropped
    bad = tmp_path / "plain.mp4"
    bad.write_bytes(b"\x00\x00\x00\x0cftypmp42" + b"\x00\x00\x00\x08moov")
    with pytest.raises(IOError, match="gpmd|GPMF"):
        tgpmf.parse_gpmf_mp4(str(bad))


# ----- constrain_with_telemetry and the CLIs -----


def _to_port(r) -> ChunkReconstruction:
    return ChunkReconstruction(**{f.name: copy.deepcopy(getattr(r, f.name))
                                  for f in dataclasses.fields(ChunkReconstruction)})


def _to_jax(r):
    from pi3_slam_tpu.sfm.reconstruction import ChunkReconstruction as JRecon

    return JRecon(**{f.name: copy.deepcopy(getattr(r, f.name)) for f in dataclasses.fields(JRecon)})


def _lla_of(enu, origin=(48.0, 11.0, 500.0)):
    """Geodetic fixes of ENU points, by the linearisation geodetic_to_enu
    inverts."""
    lat0, lon0, alt0 = origin
    s = np.sin(np.radians(lat0))
    rn = jpri._A / np.sqrt(1.0 - jpri._E2 * s * s)
    rm = jpri._A * (1.0 - jpri._E2) / (1.0 - jpri._E2 * s * s) ** 1.5
    return np.stack([lat0 + np.degrees(enu[:, 1] / rm),
                     lon0 + np.degrees(enu[:, 0] / (rn * np.cos(np.radians(lat0)))),
                     alt0 + enu[:, 2]], axis=1)


def _telemetry_json(path, centers, rots_wc, dt=0.1):
    """Generic-JSON telemetry at 50 Hz about a trajectory sampled every
    ``dt`` seconds: GPS at the interpolated centers, gravity (-z, ENU) in
    the camera frame."""
    n = len(centers)
    ts = np.arange(0.0, dt * n + dt, 0.02)
    c = np.stack([np.interp(ts, dt * np.arange(n), centers[:, i]) for i in range(3)], axis=1)
    idx = np.clip((ts / dt).round().astype(int), 0, n - 1)
    grav = np.stack([rots_wc[i].T @ np.array([0.0, 0.0, -1.0]) for i in idx])
    path.write_text(json.dumps({"gps": np.c_[ts, _lla_of(c)].tolist(),
                                "gravity": np.c_[ts, grav].tolist()}))
    return str(path)


def _chunk_recons(tmp_path, rng):
    """The quick system's chunks (frame i at t = 0.1 i s) reconstructed and
    chained by the port's reconstructor (per-chunk BA, Sim3 alignment), as
    JAX reconstructions, and the true trajectory."""
    from pi3_slam_tpu_torch.slam.config import ReconstructorConfig
    from pi3_slam_tpu_torch.slam.offline_reconstructor import OfflineReconstructor

    centers = write_synthetic_chunks(tmp_path, rng, n_frames=N_FRAMES, yaw_rate=YAW,
                                     frame_name_fn=lambda i: f"{i * 100:013d}.png")
    recons = OfflineReconstructor(ReconstructorConfig(
        chunk_dir=str(tmp_path), output_dir=str(tmp_path / "chain"), max_observations_per_track=8,
        device="cpu")).run()["reconstructions"]
    rots = [Rotation.from_euler("y", YAW * i).as_matrix() for i in range(N_FRAMES)]
    return [_to_jax(r) for r in recons], centers, rots


def _similarity_aligned(src, dst):
    """src mapped onto dst by the least-squares similarity (fp64)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    u, d, vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s))
    sgn = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])
    return (np.trace(np.diag(d) @ sgn) / ((src - mu_s) ** 2).sum()) * (src - mu_s) @ (
        u @ sgn @ vt).T + mu_d


def _merged(recons):
    seen, c, r = set(), [], []
    for rec in recons:
        for j, nm in enumerate(rec.frame_names):
            if nm not in seen:
                seen.add(nm)
                c.append(rec.centers[j])
                r.append(rec.rotations[j])
    return np.asarray(c), np.asarray(r)


@pytest.mark.parametrize("streams", ["gps+gravity", "gravity"])
def test_constrain_with_telemetry_matches_jax(tmp_path, rng, streams):
    """The GPS georeference (or, gravity only, the leveling rotation) and
    the per-chunk refine BA with its priors, on the same chunks."""
    jrec, centers, rots = _chunk_recons(tmp_path, rng)
    path = _telemetry_json(tmp_path / "t.json", centers, rots)
    gps_sigma = 0.5 if streams == "gps+gravity" else 0.0
    # without the refine: the georeference (or the leveling) alone
    j0, t0 = [_to_jax(r) for r in jrec], [_to_port(r) for r in jrec]
    jpri.constrain_with_telemetry(j0, jtel.load_telemetry(path), gps_sigma=gps_sigma,
                                  gravity_sigma=0.05, refine_iterations=0)
    tpri.constrain_with_telemetry(t0, ttel.load_telemetry(path), gps_sigma=gps_sigma,
                                  gravity_sigma=0.05, refine_iterations=0, device="cpu")
    for a, b in zip(_merged(t0), _merged(j0)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    trec = [_to_port(r) for r in jrec]
    want = jpri.constrain_with_telemetry(jrec, jtel.load_telemetry(path), gps_sigma=gps_sigma,
                                         gravity_sigma=0.05, refine_iterations=10)
    got = tpri.constrain_with_telemetry(trec, ttel.load_telemetry(path), gps_sigma=gps_sigma,
                                        gravity_sigma=0.05, refine_iterations=10, device="cpu")
    for key in ("gps", "gravity", "refined_chunks", "notes"):
        assert got[key] == want[key], key
    assert got["refined_chunks"] == len(trec) and got["gravity"]
    assert got["gps"] == (streams == "gps+gravity")
    if got["gps"]:
        np.testing.assert_allclose(got["gps_rms_m"], want["gps_rms_m"], rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-5)
        assert got["origin"] == want["origin"]
    (gc, gr), (wc, wr) = _merged(trec), _merged(jrec)
    down, jdown = (np.einsum("nij,j->ni", r, [0.0, 0.0, -1.0]) for r in (gr, wr))
    if got["gps"]:
        np.testing.assert_allclose(gc, wc, atol=5e-3)
        np.testing.assert_allclose(gr, wr, atol=5e-3)
    else:
        # gravity alone fixes roll and pitch, nothing else: the measured
        # directions through the leveled, refined rotations point straight
        # down, and the centers agree up to a similarity
        meas = np.stack([rots[i].T @ [0.0, 0.0, -1.0] for i in range(N_FRAMES)])
        assert np.abs(down - meas).max() < 1e-2
        np.testing.assert_allclose(_similarity_aligned(gc, wc), wc, atol=2e-2)
    np.testing.assert_allclose(down, jdown, atol=5e-3)


def test_reconstructor_cli_with_telemetry_matches_jax(tmp_path, rng):
    """--telemetry (GPS + gravity, GPS sigma 0.05 m) and --save-colmap
    through both CLIs on the same chunks: the trajectory already in the ENU
    frame, within 1e-3 m of the JAX CLI's and within 1e-2 m RMS of the truth
    with no alignment; the telemetry record the JAX reconstructor returns."""
    from pi3_slam_tpu.slam import OfflineReconstructor as JaxReconstructor
    from pi3_slam_tpu.slam import ReconstructorConfig as JaxConfig

    centers = write_synthetic_chunks(tmp_path, rng, n_frames=N_FRAMES, yaw_rate=YAW,
                                     frame_name_fn=lambda i: f"{i * 100:013d}.png")
    rots = [Rotation.from_euler("y", YAW * i).as_matrix() for i in range(N_FRAMES)]
    path = _telemetry_json(tmp_path / "telemetry.json", centers, rots)
    argv = ["--chunks", str(tmp_path), "--max-observations-per-track", "8", "--telemetry", path,
            "--gps-sigma", "0.05", "--save-colmap"]
    # the JAX CLI's parser and config, through its reconstructor (the CLI's
    # main() only adds select_platform)
    jargs = jax_cli.build_parser().parse_args(argv + ["--output", str(tmp_path / "jax")])
    want = JaxReconstructor(JaxConfig(
        chunk_dir=jargs.chunks, output_dir=jargs.output,
        max_observations_per_track=jargs.max_observations_per_track,
        telemetry_path=jargs.telemetry, gps_sigma=jargs.gps_sigma,
        gravity_sigma=jargs.gravity_sigma, save_colmap=jargs.save_colmap)).run()
    got = cli.reconstruct(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    for key in ("gps", "gravity", "refined_chunks", "notes"):
        assert got["telemetry"][key] == want["telemetry"][key], key
    assert got["telemetry"]["gps"] and got["telemetry"]["gravity"]
    assert got["telemetry"]["seconds"] > 0
    np.testing.assert_allclose(got["telemetry"]["scale"], want["telemetry"]["scale"], rtol=1e-2)
    traj = read_tum_trajectory(got["artifacts"]["trajectory"])["positions"]
    jtraj = jax_read_tum(want["artifacts"]["trajectory"])["positions"]
    assert np.linalg.norm(traj - jtraj, axis=1).max() < 1e-3
    assert np.sqrt(np.mean(np.sum((traj - centers) ** 2, axis=1))) < 1e-2
    assert os.path.exists(got["artifacts"]["colmap"])


def test_online_cli_with_telemetry_matches_jax_priors(tmp_path, rng, monkeypatch):
    """The online CLI with --telemetry (gravity only) on a tiny model: its
    apply_telemetry, after the chain, gives what the JAX package's
    constrain_with_telemetry gives on the same reconstructions (gravity
    directions within 5e-3, the same statistics), and the CLI returns the
    record."""
    from PIL import Image
    from test_pi3_model import TINY, make_tiny_params

    from pi3_slam_tpu.models.convert import save_pi3_checkpoint
    from pi3_slam_tpu_torch import pi3_slam_online as online_cli
    from pi3_slam_tpu_torch.slam import online

    ckpt = str(tmp_path / "tiny.npz")
    save_pi3_checkpoint(ckpt, make_tiny_params(), TINY)
    frames = tmp_path / "frames"
    frames.mkdir()
    base = rng.integers(30, 220, (48, 64, 3)).astype(np.uint8)
    for i in range(6):  # frame i at t = 0.1 i s
        Image.fromarray(np.roll(base, 3 * i, axis=1)).save(frames / f"{i * 100:013d}.png")
    ts = np.arange(0.0, 0.8, 0.02)
    tilt = Rotation.from_euler("x", 0.3).as_matrix() @ np.array([0.0, 0.0, -1.0])
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"gravity": np.c_[ts, np.tile(tilt, (len(ts), 1))].tolist()}))

    before = {}
    apply = online.Pi3SLAMOnline.apply_telemetry

    def spy(self):
        before["recons"] = [_to_jax(r) for r in self.reconstructions]
        return apply(self)

    monkeypatch.setattr(online.Pi3SLAMOnline, "apply_telemetry", spy)
    res = online_cli.run_online([
        "--images", str(frames), "--model-path", ckpt, "--chunk-length", "4", "--overlap", "2",
        "--max-kp", "20", "--pixel-limit", "3000", "--device", "cpu", "--compute-dtype", "float32",
        "--no-metric-depth", "--telemetry", str(path), "--output", str(tmp_path / "out")])
    jrec = before["recons"]
    want = jpri.constrain_with_telemetry(jrec, jtel.load_telemetry(str(path)), gps_sigma=2.0,
                                         gravity_sigma=0.05, refine_iterations=20)
    got = res["telemetry"]
    for key in ("gps", "gravity", "refined_chunks", "notes"):
        assert got[key] == want[key], key
    assert got["gravity"] and not got["gps"] and got["refined_chunks"] == len(jrec) == 3
    # the JAX refine against the port's, on the trajectory the CLI wrote
    _, wr = _merged(jrec)
    traj = read_tum_trajectory(res["artifacts"]["trajectory"])
    R_wc = Rotation.from_quat(traj["quaternions_xyzw"]).as_matrix()
    np.testing.assert_allclose(np.einsum("nji,j->ni", R_wc, [0.0, 0.0, -1.0]),
                               np.einsum("nij,j->ni", wr, [0.0, 0.0, -1.0]), atol=5e-3)
