"""The port's offline reconstructor against the JAX package on the CPU:
chunk reconstruction with both observation fans, Sim3 chunk alignment on its
track and pose routes, the reconstructor end to end on the quick synthetic
system of ``tests/test_system_ape.py`` (14 frames, 3 chunks + a tail), its
artifacts, the APE scorer, the per-chunk files and the CLI.

Inputs are made with numpy from a seed. Tolerances: the observation arrays
are built in fp64 and stored in fp32 by both packages (held to 1e-4 px); a
Sim3 fit agrees to fp32 rounding (1e-4 on unit-scale scenes).

A chunk BA has no fixed camera: only the LM damping (1e-4 of the diagonal)
holds its 7 gauge directions, so fp32 rounding in the right-hand side moves
each step along them by up to ~1e4 times its size, and the ftol early stop
can fire a step apart. A chunk BA is therefore held to the JAX one up to a
similarity (the gauge), at 1e-3 of the scene. The alignment's prior BA and
the quick system are held on the quick system's chunks (300 landmarks at
depth 4-10, yaw), where fp32 solves of the two packages stay within 1e-3 of
each other (on a 30-point scene seen from a line of cameras a single fp32
step is 0.01 off its fp64 value in either package, and no tolerance holds).
Where a solve converges before its budget, the ftol early stop compares a
relative decrease with 1e-6 at fp32 noise and can fire a step apart, so
iteration counts are held where they are robust (tests/test_torch_sfm.py).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation


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

import reconstruct_offline as jax_cli  # noqa: E402
from test_alignment import make_chunk  # noqa: E402
from test_system_ape import write_synthetic_chunks  # noqa: E402

from pi3_slam_tpu.geometry.sim3 import Sim3 as JSim3  # noqa: E402
from pi3_slam_tpu.io.ply import read_ply as jax_read_ply  # noqa: E402
from pi3_slam_tpu.sfm import alignment as jalign  # noqa: E402
from pi3_slam_tpu.sfm import reconstruction as jrec  # noqa: E402
from pi3_slam_tpu.sfm.serialization import load_reconstruction as jax_load_reconstruction  # noqa: E402
from pi3_slam_tpu.slam import OfflineReconstructor as JaxReconstructor  # noqa: E402
from pi3_slam_tpu.slam import ReconstructorConfig as JaxConfig  # noqa: E402
from pi3_slam_tpu.slam.offline_reconstructor import load_chunk_npz as jax_load_chunk  # noqa: E402
from pi3_slam_tpu.utils import evaluation as jeval  # noqa: E402

from pi3_slam_tpu_torch import reconstruct_offline as cli  # noqa: E402
from pi3_slam_tpu_torch.geometry.sim3 import Sim3  # noqa: E402
from pi3_slam_tpu_torch.io.ply import read_ply  # noqa: E402
from pi3_slam_tpu_torch.io.tum import read_tum_trajectory  # noqa: E402
from pi3_slam_tpu_torch.sfm import alignment as talign  # noqa: E402
from pi3_slam_tpu_torch.sfm import reconstruction as trec  # noqa: E402
from pi3_slam_tpu_torch.sfm.ba import last_ba_info  # noqa: E402
from pi3_slam_tpu_torch.sfm.serialization import load_reconstruction, save_reconstruction  # noqa: E402
from pi3_slam_tpu_torch.slam.config import ReconstructorConfig  # noqa: E402
from pi3_slam_tpu_torch.slam.offline_reconstructor import (  # noqa: E402
    OfflineReconstructor,
    load_chunk_npz,
)
from pi3_slam_tpu_torch.utils import evaluation as teval  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAYS = ("rotations", "centers", "intrinsics", "points", "colors", "track_frame", "track_kp",
          "track_uv", "track_valid", "obs_frame", "obs_valid")


def _noisy_chunk(rng, names, start=0, seed=None):
    chunk, seed = make_chunk(rng, names, n_kp=30, start=start, seed_points=seed)
    chunk["points"] = chunk["points"] + rng.normal(size=chunk["points"].shape) * 0.02
    chunk["keypoints"] = chunk["keypoints"] + rng.normal(size=chunk["keypoints"].shape) * 0.3
    return chunk, seed


def _same_recon(got, want, atol=0.0):
    assert got.frame_names == want.frame_names
    for name in ARRAYS:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=atol, err_msg=name)
    valid = want.obs_valid > 0
    np.testing.assert_allclose(got.obs_uv[valid], want.obs_uv[valid], atol=max(atol, 1e-4))


def _similarity_aligned(src, dst):
    """src mapped onto dst by the least-squares similarity (Umeyama, fp64)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    u, d, vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s))
    R = u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
    s = np.trace(np.diag(d) @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])) / (
        (src - mu_s) ** 2).sum()
    return s * (src - mu_s) @ R.T + mu_d


@pytest.mark.parametrize("fan", ["subsampled", "unbounded"])
def test_build_chunk_reconstruction_matches_jax(rng, fan):
    """The observation fan (12 frames, max 6 observations: 'subsampled' takes
    5 slots, 'unbounded' 15), held exactly; then the bundle adjustment and
    pruning, held up to the gauge (module docstring)."""
    chunk, _ = _noisy_chunk(rng, [f"f{i}" for i in range(12)])
    kw = dict(max_observations_per_track=6, observation_fan=fan)
    got = trec.build_chunk_reconstruction(chunk, run_ba=False, device="cpu", **kw)
    want = jrec.build_chunk_reconstruction(chunk, run_ba=False, **kw)
    assert got.obs_frame.shape[1] == (6 if fan == "subsampled" else 15)
    _same_recon(got, want)
    got = trec.build_chunk_reconstruction(chunk, device="cpu", **kw)
    want = jrec.build_chunk_reconstruction(chunk, **kw)
    assert 1 <= last_ba_info()["iterations"] <= 10
    geo = lambda r: np.concatenate([r.centers, r.points]).astype(np.float64)
    np.testing.assert_allclose(_similarity_aligned(geo(got), geo(want)), geo(want), atol=1e-3)
    assert (got.track_valid == want.track_valid).mean() > 0.98
    for stats in (trec.reconstruction_stats(got), jrec.reconstruction_stats(want)):
        assert stats["median_reprojection_error"] < 1.0  # 0.3 px keypoint noise


def test_stored_observations_and_keypoint_validity_match_jax(rng):
    chunk, _ = _noisy_chunk(rng, [f"f{i}" for i in range(4)])
    valid = np.ones((4, 30), bool)
    valid[:, 25:] = False
    chunk["keypoint_valid"] = valid
    chunk["obs_frame"] = np.tile(np.arange(4)[None, None, :], (4, 30, 1)).astype(np.int32)
    chunk["obs_uv"] = np.repeat(chunk["keypoints"][:, :, None], 4, axis=2)
    chunk["obs_valid"] = np.ones((4, 30, 4), np.float32)
    got = trec.build_chunk_reconstruction(chunk, run_ba=False, device="cpu")
    want = jrec.build_chunk_reconstruction(chunk, run_ba=False)
    _same_recon(got, want)
    assert (got.obs_valid[got.track_valid == 0] == 0).all()


def _chunk_pair(tmp_path, rng, jitter):
    """Chunks 0 and 1 of the quick synthetic system (each in its own gauge,
    two shared frames), as both packages' reconstructions."""
    write_synthetic_chunks(tmp_path, rng)
    a, b = (load_chunk_npz(str(tmp_path / "chunks" / f"chunk_00000{i}.npz")) for i in (0, 1))
    if jitter:  # beyond the 0.25 px join: no common track, the pose route
        b["keypoints"] = b["keypoints"] + rng.uniform(1.0, 2.0, b["keypoints"].shape).astype(
            np.float32)
    port = [trec.build_chunk_reconstruction(c, run_ba=False, max_observations_per_track=8,
                                            device="cpu") for c in (a, b)]
    jax = [jrec.build_chunk_reconstruction(c, run_ba=False, max_observations_per_track=8)
           for c in (a, b)]
    return port, jax


@pytest.mark.parametrize("route", ["tracks", "poses"])
@pytest.mark.parametrize("refine", [False, True])
def test_align_chunks_matches_jax(tmp_path, rng, route, refine):
    """The common-track Sim3 (median-distance filter, IRLS, trim) and the
    shared-pose fallback, with and without the prior-BA refine (the
    reference's priors, 20 iterations) and prune: the same Sim3 to fp32
    rounding, the refined poses to 1e-3 and points to 5e-3 (module
    docstring)."""
    (ta, tb), (ja, jb) = _chunk_pair(tmp_path, rng, jitter=route == "poses")
    got = talign.align_chunks(ta, tb, refine=refine, refine_iterations=20, device="cpu")
    want = jalign.align_chunks(ja, jb, refine=refine, refine_iterations=20)
    assert got.success and want.success
    assert (got.method, got.num_common_tracks, got.num_used_tracks) == (
        want.method, want.num_common_tracks, want.num_used_tracks)
    assert got.method == route
    np.testing.assert_allclose(float(got.sim3.scale), float(want.sim3.scale), rtol=1e-4)
    np.testing.assert_allclose(got.sim3.rotation.numpy(), np.asarray(want.sim3.rotation), atol=1e-4)
    atol = 1e-3 if refine else 1e-4
    np.testing.assert_allclose(tb.centers, jb.centers, atol=atol)
    np.testing.assert_allclose(tb.rotations, jb.rotations, atol=atol)
    live = jb.track_valid > 0
    np.testing.assert_array_equal(tb.track_valid, jb.track_valid)
    np.testing.assert_allclose(tb.points[live], jb.points[live], atol=5 * atol)


def test_align_chunks_without_shared_frames_fails(rng):
    chunk_a, _ = make_chunk(rng, ["f0", "f1", "f2"])
    chunk_b, _ = make_chunk(rng, ["g0", "g1", "g2"], start=5)
    ra = trec.build_chunk_reconstruction(chunk_a, run_ba=False, device="cpu")
    rb = trec.build_chunk_reconstruction(chunk_b, run_ba=False, device="cpu")
    res = talign.align_chunks(ra, rb, refine=False, device="cpu")
    assert not res.success and res.num_common_tracks == 0


def test_apply_sim3_matches_jax(rng):
    chunk, _ = _noisy_chunk(rng, ["f0", "f1", "f2"])
    ra = trec.build_chunk_reconstruction(chunk, run_ba=False, device="cpu")
    rb = jrec.build_chunk_reconstruction(chunk, run_ba=False)
    R = Rotation.from_rotvec([0.1, 0.2, -0.3]).as_matrix()
    talign.apply_sim3_to_reconstruction(
        ra, Sim3(torch.tensor(1.2), torch.from_numpy(R), torch.tensor([0.5, 0.0, -1.0])))
    jalign.apply_sim3_to_reconstruction(
        rb, JSim3(jnp.asarray(1.2), jnp.asarray(R), jnp.asarray([0.5, 0.0, -1.0])))
    _same_recon(ra, rb, atol=1e-6)


def test_quick_system_matches_jax(tmp_path, rng):
    """The quick synthetic system through both reconstructors (the port by
    its CLI, --device cpu): the same alignments, trajectories within 1e-3,
    the port's APE < 0.05 m (the JAX gate), and TUM / PLY files that agree."""
    gt_centers = write_synthetic_chunks(tmp_path, rng)
    want = JaxReconstructor(JaxConfig(chunk_dir=str(tmp_path), output_dir=str(tmp_path / "jax"),
                                      max_observations_per_track=8, ba_iterations=10)).run()
    got = cli.reconstruct(["--chunks", str(tmp_path), "--output", str(tmp_path / "port"),
                           "--max-observations-per-track", "8", "--device", "cpu"])
    assert [(a.method, a.num_common_tracks) for a in got["alignment"]] == [
        (a.method, a.num_common_tracks) for a in want["alignment"]]
    assert all(a.success for a in got["alignment"])
    assert all(1 <= t["ba_iterations"] <= 10 for t in got["timings"])
    assert all(0 < t["ba_s"] <= t["recon_s"] for t in got["timings"])
    traj = read_tum_trajectory(got["artifacts"]["trajectory"])
    traj_j = read_tum_trajectory(want["artifacts"]["trajectory"])
    np.testing.assert_array_equal(traj["timestamps"], traj_j["timestamps"])
    np.testing.assert_allclose(traj["positions"], traj_j["positions"], atol=1e-3)
    np.testing.assert_allclose(traj["quaternions_xyzw"], traj_j["quaternions_xyzw"], atol=1e-3)
    assert traj["positions"].shape == (len(gt_centers), 3)
    ape = teval.ape_translation(gt_centers, traj["positions"])
    assert ape.rmse < 0.05, ape
    for name in ("points", "cameras"):
        a = read_ply(got["artifacts"][name])
        b = jax_read_ply(want["artifacts"][name])
        assert a["xyz"].shape == b["xyz"].shape
        # points 10-12 m out are the least constrained: 5e-3
        np.testing.assert_allclose(a["xyz"], b["xyz"], atol=5e-3)
        np.testing.assert_array_equal(a["rgb"], b["rgb"])


def test_port_writes_the_files_the_jax_package_reads(tmp_path, rng):
    """TUM, PLY and the per-chunk reconstruction files of the port read back
    through the JAX package's readers unchanged."""
    chunk, _ = _noisy_chunk(rng, ["f0", "f1", "f2"])
    r = trec.build_chunk_reconstruction(chunk, device="cpu")
    path = str(tmp_path / "recon_000000.npz")
    save_reconstruction(r, path)
    for loaded in (load_reconstruction(path), jax_load_reconstruction(path)):
        _same_recon(trec.ChunkReconstruction(**{**loaded.__dict__, "track_desc": None}), r)
    rec = OfflineReconstructor(ReconstructorConfig(chunk_dir=str(tmp_path),
                                                   output_dir=str(tmp_path), device="cpu"))
    art = rec.export([r])
    from pi3_slam_tpu.io.tum import read_tum_trajectory as jax_read_tum

    for key in ("timestamps", "positions", "quaternions_xyzw"):
        np.testing.assert_array_equal(read_tum_trajectory(art["trajectory"])[key],
                                      jax_read_tum(art["trajectory"])[key])
    np.testing.assert_array_equal(read_ply(art["points"])["xyz"], jax_read_ply(art["points"])["xyz"])


def test_load_chunk_npz_matches_jax(tmp_path, rng):
    write_synthetic_chunks(tmp_path, rng)
    path = str(tmp_path / "chunks" / "chunk_000000.npz")
    got, want = load_chunk_npz(path), jax_load_chunk(path)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)


def test_ape_scorer_matches_jax(tmp_path, rng):
    gt = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    est = 0.7 * gt @ Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix().T + 2.0
    est = est + rng.normal(size=est.shape) * 0.05
    a, b = teval.ape_translation(gt, est), jeval.ape_translation(gt, est)
    np.testing.assert_allclose(list(a.as_dict().values()), list(b.as_dict().values()), rtol=1e-4)
    ts_a = np.arange(40) * 0.1
    ts_b = ts_a[::2] + rng.uniform(-0.004, 0.004, 20)
    for x, y in zip(teval.associate(ts_a, ts_b), jeval.associate(ts_a, ts_b)):
        np.testing.assert_array_equal(x, y)
    from pi3_slam_tpu_torch.io.tum import write_tum_trajectory

    rots = np.tile(np.eye(3), (40, 1, 1))
    write_tum_trajectory(str(tmp_path / "gt.txt"), gt, rots)
    write_tum_trajectory(str(tmp_path / "est.txt"), est, rots)
    a = teval.evaluate_tum_files(str(tmp_path / "gt.txt"), str(tmp_path / "est.txt"))
    b = jeval.evaluate_tum_files(str(tmp_path / "gt.txt"), str(tmp_path / "est.txt"))
    np.testing.assert_allclose(a.rmse, b.rmse, rtol=1e-4)
    assert a.num_pairs == b.num_pairs == 40


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices)
            for a in parser._actions if a.dest != "help"}


def test_cli_flags_match_the_jax_cli():
    """Every flag of reconstruct_offline.py, with its default and type; only
    --device's default differs (the card, not the TPU)."""
    got, want = _flags(cli.build_parser()), _flags(jax_cli.build_parser())
    assert set(got) == set(want)
    for dest in want:
        if dest != "device":
            assert got[dest] == want[dest], dest
    assert got["device"][1] == "cuda"


def test_cli_default_device_refuses_to_run_without_a_gpu(tmp_path, rng):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    write_synthetic_chunks(tmp_path, rng)
    proc = subprocess.run([sys.executable, "-m", "pi3_slam_tpu_torch.reconstruct_offline",
                           "--chunks", str(tmp_path)], capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
