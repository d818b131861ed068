"""The port's loop closure (``pi3_slam_tpu_torch/sfm/posegraph.py``,
``sfm/loops.py``) against the JAX package's, on the CPU: the Sim3 pose graph
(nodes and both costs), loop detection and correction on the scenes of
tests/test_posegraph.py, the offline reconstructor with ``--loop-closure`` on
a small tests/test_loop_system.py circle, the online class's
``apply_loop_closure``, and the online CLI and the eval tool with the three
appearance options on the CPU.

The same numpy inputs go through both. fp32 solvers on both sides: pose-graph
nodes within 2e-4, costs within 1e-3 relative; loop edges the same pairs,
match and inlier counts, their Sim3 within 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.geometry import sim3 as jsim3
from pi3_slam_tpu.sfm import loops as jloops
from pi3_slam_tpu.sfm import posegraph as jpg
from pi3_slam_tpu.sfm.alignment import apply_sim3_to_reconstruction as japply
from pi3_slam_tpu.sfm.reconstruction import build_chunk_reconstruction as jbuild
from pi3_slam_tpu_torch.geometry.sim3 import Sim3
from pi3_slam_tpu_torch.sfm import loops as tloops
from pi3_slam_tpu_torch.sfm import posegraph as tpg
from pi3_slam_tpu_torch.sfm.alignment import subsample_live_tracks
from pi3_slam_tpu_torch.sfm.reconstruction import build_chunk_reconstruction as tbuild


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = "cpu"


def _t(s) -> Sim3:
    """A JAX Sim3 (possibly batched) as the port's."""
    return Sim3(*(torch.tensor(np.asarray(x), dtype=torch.float32) for x in s))


def _jrand(rng, mag_r, mag_t, mag_s):
    xi = np.concatenate([rng.normal(size=3) * mag_t, rng.normal(size=3) * mag_r,
                         rng.normal(size=1) * mag_s])
    return jsim3.sim3_exp(jnp.asarray(xi, jnp.float32))


def _drift_chain(rng, n=12):
    """tests/test_posegraph.py's chain: per-step alignment noise and one loop
    edge from the last node to the first."""
    ident = jsim3.Sim3(jnp.ones(()), jnp.eye(3), jnp.zeros(3))
    rels = [_jrand(rng, 0.3, 1.0, 0.05) for _ in range(n - 1)]
    t_true, t_est = [ident], [ident]
    for r in rels:
        t_true.append(jsim3.sim3_compose(t_true[-1], r))
        t_est.append(jsim3.sim3_compose(t_est[-1], jsim3.sim3_compose(r, _jrand(rng, 0.02, 0.05,
                                                                                 0.01))))
    e0 = jsim3.sim3_compose(t_est[0], jsim3.sim3_inverse(t_true[0]))
    en = jsim3.sim3_compose(t_est[-1], jsim3.sim3_inverse(t_true[-1]))
    ei, ej, meas_seq = jpg.sequential_edges(n)
    ei = np.concatenate([ei, [0]]).astype(np.int32)
    ej = np.concatenate([ej, [n - 1]]).astype(np.int32)
    meas = jpg.stack_sim3(meas_seq + [jsim3.sim3_compose(e0, jsim3.sim3_inverse(en))])
    w = np.ones(len(ei), np.float32)
    w[-1] = 3.0
    return ident, ei, ej, meas, w


@pytest.mark.parametrize("iterations,huber", [(12, 0.5), (15, 0.05), (1, 0.5)])
def test_pose_graph_matches_jax(rng, iterations, huber):
    """Nodes, initial cost (the first step's) and final cost; a small Huber
    width puts the loop edge on the linear branch."""
    n = 12
    ident, ei, ej, meas, w = _drift_chain(rng, n)
    want = jpg.optimize_sim3_pose_graph(jpg.stack_sim3([ident] * n), jnp.asarray(ei),
                                        jnp.asarray(ej), meas, jnp.asarray(w),
                                        iterations=iterations, huber_delta=huber)
    got = tpg.optimize_sim3_pose_graph(tpg.stack_sim3([_t(ident)] * n), ei, ej, _t(meas), w,
                                       iterations=iterations, huber_delta=huber, device=CPU)
    assert got.iterations == iterations
    np.testing.assert_allclose(got.initial_cost, want.initial_cost, rtol=1e-4)
    np.testing.assert_allclose(got.final_cost, want.final_cost, rtol=1e-3, atol=1e-6)
    for a, b in zip(got.nodes, want.nodes):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, rtol=0)
    assert got.final_cost < (0.1 if huber == 0.5 else 1.0) * got.initial_cost
    x0 = tpg.index_sim3(got.nodes, 0)  # the gauge: node 0 stays the identity
    np.testing.assert_allclose(x0.rotation.numpy(), np.eye(3), atol=1e-4)


def test_edge_residuals_and_sequential_edges_match_jax(rng):
    ident, ei, ej, meas, _ = _drift_chain(rng, 6)
    nodes = jpg.stack_sim3([_jrand(rng, 0.2, 0.5, 0.1) for _ in range(6)])
    want = jpg._edge_residuals(nodes, jnp.asarray(ei), jnp.asarray(ej),
                               jsim3.sim3_inverse(meas), 0.7)
    got = tpg._edge_residuals(_t(nodes), torch.from_numpy(ei).long(), torch.from_numpy(ej).long(),
                              _t(jsim3.sim3_inverse(meas)), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    a, b = tpg.sequential_edges(5), jpg.sequential_edges(5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert len(a[2]) == 4


def _unit_desc(rng, k, dim=64):
    d = rng.normal(size=(k, dim))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _revisit_chunks(rng, n_kp=48):
    """tests/test_posegraph.py's scene: four chunks, the last revisits the
    first's points with the same descriptors."""
    from tests.test_alignment import make_chunk

    def desc_chunk(names, seed, desc, start):
        chunk, _ = make_chunk(rng, names, n_kp=seed.shape[0], seed_points=seed, start=start)
        chunk["descriptors"] = np.tile(desc[None], (len(names), 1, 1)).astype(np.float32)
        return chunk

    seed_a = np.stack([rng.uniform(-2, 2, n_kp), rng.uniform(-1.5, 1.5, n_kp),
                       rng.uniform(4, 7, n_kp)], axis=1)
    desc_a = _unit_desc(rng, n_kp)
    chunks = [desc_chunk(["a0", "a1", "a2", "a3"], seed_a, desc_a, 0)]
    for k, start in ((1, 3), (2, 6)):
        chunks.append(desc_chunk([f"c{k}f{i}" for i in range(4)],
                                 seed_a + np.array([0.8 * start, 0.0, 0.0]),
                                 _unit_desc(rng, n_kp), start))
    chunks.append(desc_chunk(["b0", "b1", "b2", "b3"], seed_a, desc_a, 0))
    return chunks, seed_a


def _both_recons(chunks, drift_xi):
    """The chunks built by both packages (no BA), chunks 1.. drifted by the
    accumulated drift_xi step."""
    jr = [jbuild(c, run_ba=False) for c in chunks]
    tr = [tbuild(c, run_ba=False) for c in chunks]
    step = jsim3.sim3_exp(jnp.asarray(drift_xi, jnp.float32))
    acc = jsim3.Sim3(jnp.ones(()), jnp.eye(3), jnp.zeros(3))
    from pi3_slam_tpu_torch.sfm.alignment import apply_sim3_to_reconstruction

    for k in range(1, len(chunks)):
        acc = jsim3.sim3_compose(step, acc)
        japply(jr[k], acc)
        apply_sim3_to_reconstruction(tr[k], _t(acc))
    return jr, tr


def _same_edges(got, want):
    assert [(e.i, e.j, e.num_matches, e.num_inliers) for e in got] == \
        [(e.i, e.j, e.num_matches, e.num_inliers) for e in want]
    for a, b in zip(got, want):
        for x, y in zip(a.sim3, b.sim3):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4)
        np.testing.assert_allclose(a.inlier_rms, b.inlier_rms, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("prefilter", [None, 1])
def test_detect_and_close_loops_match_jax(rng, prefilter):
    """The (0, 3) revisit is found with the JAX edge, and the pose graph
    moves every chunk's points to the JAX positions (within 1e-3 of a
    ~5-unit scene), pulling chunk 3 back onto chunk 0's geometry."""
    chunks, seed_a = _revisit_chunks(rng)
    jr, tr = _both_recons(chunks, [0.15, 0.1, -0.05, 0.03, -0.02, 0.04, 0.02])
    for r_t, r_j in zip(tr, jr):
        np.testing.assert_allclose(r_t.points, r_j.points, atol=1e-5)
    want = jloops.detect_loop_closures(jr, global_prefilter_top_k=prefilter)
    got = tloops.detect_loop_closures(tr, global_prefilter_top_k=prefilter, device=CPU)
    assert [(e.i, e.j) for e in got] == [(0, 3)]
    _same_edges(got, want)
    err_before = np.linalg.norm(tr[3].points[:48] - seed_a, axis=-1).mean()
    s_want = jloops.close_loops(jr, edges=want, sequential_weight=0.5)
    s_got = tloops.close_loops(tr, edges=got, sequential_weight=0.5, device=CPU)
    assert s_got["applied"] and s_got["num_loop_edges"] == 1
    np.testing.assert_allclose(s_got["initial_cost"], s_want["initial_cost"], rtol=1e-4)
    np.testing.assert_allclose(s_got["final_cost"], s_want["final_cost"], rtol=1e-3, atol=1e-6)
    for r_t, r_j in zip(tr, jr):
        np.testing.assert_allclose(r_t.points, r_j.points, atol=1e-3)
        np.testing.assert_allclose(r_t.centers, r_j.centers, atol=1e-3)
        np.testing.assert_allclose(r_t.rotations, r_j.rotations, atol=1e-4)
    assert np.linalg.norm(tr[3].points[:48] - seed_a, axis=-1).mean() < 0.35 * err_before


def test_close_loops_detects_and_closes_in_one_call(rng):
    """close_loops without edges detects them itself, as the JAX one does."""
    chunks, _ = _revisit_chunks(rng)
    jr, tr = _both_recons(chunks, [0.1, 0.05, -0.05, 0.02, -0.01, 0.03, 0.01])
    s_want = jloops.close_loops(jr, min_inliers=20, min_cosine=0.85)
    s_got = tloops.close_loops(tr, min_inliers=20, min_cosine=0.85, device=CPU)
    _same_edges(s_got["edges"], s_want["edges"])
    np.testing.assert_allclose(s_got["final_cost"], s_want["final_cost"], rtol=1e-3, atol=1e-6)
    for r_t, r_j in zip(tr, jr):
        np.testing.assert_allclose(r_t.centers, r_j.centers, atol=1e-3)


def test_grid_chunks_close_nothing(rng):
    from tests.test_alignment import make_chunk

    chunks = [make_chunk(rng, [f"g{k}f{i}" for i in range(3)], start=3 * k)[0] for k in range(4)]
    recons = [tbuild(c, run_ba=False) for c in chunks]
    assert tloops.chunk_global_descriptor(recons[0]).size == 0
    stats = tloops.close_loops(recons, device=CPU)
    assert stats == {"num_loop_edges": 0, "applied": False, "edges": []}


def test_global_descriptor_and_subsample_match_jax(rng):
    from pi3_slam_tpu.sfm.alignment import subsample_live_tracks as jsub

    chunks, _ = _revisit_chunks(rng)
    r_j, r_t = jbuild(chunks[1], run_ba=False), tbuild(chunks[1], run_ba=False)
    r_j.track_valid[::3] = 0
    r_t.track_valid[::3] = 0
    for cap in (10, 100, 1000):
        np.testing.assert_array_equal(subsample_live_tracks(r_t, cap), jsub(r_j, cap))
    np.testing.assert_allclose(tloops.chunk_global_descriptor(r_t, 50),
                               jloops.chunk_global_descriptor(r_j, 50), atol=1e-6)
    assert tloops._chunk_proximity(r_t, r_t) == jloops._chunk_proximity(r_j, r_j) == 0.0


@pytest.fixture(scope="module")
def loop_scene(tmp_path_factory):
    """A small circle of tests/test_loop_system.py: 80 frames in five chunks
    of 20 (overlap 5), 60 keypoints a frame with landmark descriptors."""
    from tests.test_loop_system import write_loop_chunks

    root = tmp_path_factory.mktemp("loop")
    gt = write_loop_chunks(root, np.random.default_rng(0), n_frames=80, n_landmarks=1200,
                           chunk_length=20, overlap=5, n_kp=60)
    return root, gt


def test_offline_reconstructor_loop_closure_matches_jax(loop_scene):
    """python -m pi3_slam_tpu_torch.reconstruct_offline --loop-closure against
    the JAX reconstructor: the first-last edge with the JAX counts, the JAX
    pose-graph costs, trajectories within 1e-2 of a ~10-unit circle (BA and
    the prior refine run between, on fp32 solvers of either package), and a
    lower APE than without loop closure."""
    from pi3_slam_tpu.slam import OfflineReconstructor, ReconstructorConfig
    from pi3_slam_tpu.utils.evaluation import ape_translation
    from pi3_slam_tpu_torch import reconstruct_offline as cli
    from pi3_slam_tpu_torch.io.tum import read_tum_trajectory

    root, gt = loop_scene
    args = ["--chunks", str(root), "--max-observations-per-track", "6", "--ba-iterations", "3",
            "--device", "cpu"]
    plain = cli.reconstruct(args + ["--output", str(root / "t_plain")])
    got = cli.reconstruct(args + ["--output", str(root / "t_loop"), "--loop-closure",
                                  "--loop-min-inliers", "20"])
    want = OfflineReconstructor(ReconstructorConfig(
        chunk_dir=str(root), output_dir=str(root / "j_loop"), max_observations_per_track=6,
        ba_iterations=3, loop_closure=True)).run()
    assert plain["loop_closure"] is None
    stats, jstats = got["loop_closure"], want["loop_closure"]
    n_chunks = len(got["reconstructions"])
    assert (0, n_chunks - 1) in [(e.i, e.j) for e in stats["edges"]]
    assert [(e.i, e.j) for e in stats["edges"]] == [(e.i, e.j) for e in jstats["edges"]]
    for a, b in zip(stats["edges"], jstats["edges"]):
        assert abs(a.num_matches - b.num_matches) <= 2 and abs(a.num_inliers - b.num_inliers) <= 2
    np.testing.assert_allclose(stats["initial_cost"], jstats["initial_cost"], rtol=2e-2)
    assert stats["seconds"] > 0
    traj = {k: read_tum_trajectory(r["artifacts"]["trajectory"])["positions"]
            for k, r in (("plain", plain), ("loop", got), ("jax", want))}
    np.testing.assert_allclose(traj["loop"], traj["jax"], atol=1e-2)
    ape = {k: ape_translation(gt, v, align_sim3=True).rmse for k, v in traj.items()}
    assert ape["loop"] < ape["plain"], ape


def test_online_apply_loop_closure_matches_jax(rng):
    """Pi3SLAMOnline.apply_loop_closure on an accumulated chain (the class's
    state set directly: no model is needed) against the JAX class's, and
    None when loop closure is off."""
    from pi3_slam_tpu.slam import online as jonline
    from pi3_slam_tpu.slam.config import OnlineConfig as JConfig
    from pi3_slam_tpu_torch.slam import online as tonline
    from pi3_slam_tpu_torch.slam.config import OnlineConfig

    chunks, _ = _revisit_chunks(rng)
    jr, tr = _both_recons(chunks, [0.15, 0.1, -0.05, 0.03, -0.02, 0.04, 0.02])
    js = jonline.Pi3SLAMOnline.__new__(jonline.Pi3SLAMOnline)
    js.config, js.reconstructions = JConfig(loop_closure=True), jr
    ts = tonline.Pi3SLAMOnline.__new__(tonline.Pi3SLAMOnline)
    ts.config, ts.reconstructions = OnlineConfig(loop_closure=True), tr
    ts.sfm_device = torch.device("cpu")
    want, got = js.apply_loop_closure(), ts.apply_loop_closure()
    _same_edges(got["edges"], want["edges"])
    for r_t, r_j in zip(tr, jr):
        np.testing.assert_allclose(r_t.centers, r_j.centers, atol=1e-3)
    ts.config = OnlineConfig(loop_closure=False)
    assert ts.apply_loop_closure() is None


@pytest.fixture(scope="module")
def appearance_inputs(tmp_path_factory):
    from test_torch_correlation import _write_inputs

    root = tmp_path_factory.mktemp("appearance_cli")
    return root, *_write_inputs(root)


def test_online_cli_runs_all_three_options(appearance_inputs):
    """The online CLI with --keypoints aliked --refine-observations
    --loop-closure on the CPU: every chunk's reconstruction carries the
    descriptors and the stored fan width, and loop closure runs."""
    from pi3_slam_tpu_torch import pi3_slam_online as cli
    from pi3_slam_tpu_torch.slam import online

    root, frames, ckpt, aliked = appearance_inputs
    seen = []
    build = online.Pi3SLAMOnline._consume_build

    def spy(self, pending, idx=None):
        ctx = build(self, pending, idx)
        seen.append(ctx["recon"])
        return ctx

    online.Pi3SLAMOnline._consume_build = spy
    try:
        result = cli.run_online([
            "--images", frames, "--model-path", ckpt, "--output", str(root / "online"),
            "--device", "cpu", "--chunk-length", "4", "--overlap", "1", "--max-kp", "30",
            "--pixel-limit", "4000", "--no-metric-depth", "--compute-dtype", "float32",
            "--keypoints", "aliked", "--aliked-path", aliked, "--refine-observations",
            "--loop-closure", "--tum-integer-timestamps"])
    finally:
        online.Pi3SLAMOnline._consume_build = build
    assert result["num_chunks"] == 3 and len(seen) == 3
    assert result["loop_closure"] is not None
    for recon in seen:
        assert recon.track_desc is not None and recon.track_desc.shape[1] == 64
        assert recon.obs_frame.shape[1] == 10  # the step's fan width
    assert os.path.isfile(result["artifacts"]["trajectory"])


def test_eval_tool_runs_the_appearance_options(appearance_inputs, tmp_path):
    """python -m pi3_slam_tpu_torch.tools.eval 7scenes --keypoints aliked
    --aliked-npz <npz> --refine --loop on the CPU: the scripts' ALIKED, REFINE
    and LOOP steps run with the port's CLIs and give a finite APE (the online
    mode passes the same flags to the online CLI, run above)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import smoke_eval_scripts as sm

    from pi3_slam_tpu_torch.tools import eval as eval_tool

    root, _, ckpt, aliked = appearance_inputs
    data = str(tmp_path / "7scenes")
    sm.make_7scenes(data, ["alpha"], 8, 64, 84)
    results = eval_tool.run(["7scenes", data, ckpt, "", str(tmp_path / "o"), "--scenes", "alpha",
                             "--keypoints", "aliked", "--aliked-npz", aliked,
                             "--refine", "--loop", "--chunk-length", "4", "--overlap", "2",
                             "--max-kp", "16", "--device", "cpu",
                             "--gt-dir", str(tmp_path / "no_gt")])
    r = results["alpha"]
    assert np.isfinite(r["rmse"]) and r["pairs"] == 8
    steps = r["steps"]
    assert steps["reconstruct_offline"]["loop_closure"] is not None
    with np.load(steps["create_offline_chunks"][0]["path"]) as z:
        assert {"descriptors", "keypoint_valid", "obs_uv", "obs_refined"} <= set(z.files)
