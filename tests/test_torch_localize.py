"""The port's second-camera localization (``pi3_slam_tpu_torch/sfm/localize.py``)
and its CLI (``python -m pi3_slam_tpu_torch.localize_camera``) against the
JAX package's, on the CPU.

The same numpy inputs go through both. Tolerances: the DLT pose of exact
correspondences within 1e-4 (rotation) and 1e-3 (center) of JAX's, which is
fp32 SVD rounding; ``ransac_pnp`` fed JAX's own minimal samples (its
``jax.random`` draws, recomputed here) picks the same hypothesis, the same
inlier mask and count, and refines to within 1e-5 of JAX's pose; the
closed-form refinement Jacobian equals ``torch.func.jacfwd`` of the
reprojection to float64 rounding (1e-9 relative); triangulation within 1e-4;
the query tracks equal. ``localize_by_descriptors`` draws its samples on a
torch generator (other samples than JAX's), so on the planted maps it is
held to the same success, match and inlier counts and to the planted pose
(1e-3 rotation, 5e-3 center, as the JAX tests hold it); the registration's
Sim3 within 1e-4 of JAX's. Both CLI modes write the same stats and
trajectories within 1e-4.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import localize_camera as jax_cli  # noqa: E402
from test_localize import INTR, _synthetic_view  # noqa: E402
from test_posegraph import _make_desc_chunk  # noqa: E402

from pi3_slam_tpu.geometry.sim3 import sim3_apply, sim3_exp  # noqa: E402
from pi3_slam_tpu.io.tum import read_tum_trajectory as jax_read_tum  # noqa: E402
from pi3_slam_tpu.sfm import localize as jloc  # noqa: E402
from pi3_slam_tpu.sfm.alignment import apply_sim3_to_reconstruction as japply  # noqa: E402
from pi3_slam_tpu.sfm.reconstruction import build_chunk_reconstruction as jbuild  # noqa: E402

from pi3_slam_tpu_torch import localize_camera as cli  # noqa: E402
from pi3_slam_tpu_torch.geometry.transforms import so3_exp  # noqa: E402
from pi3_slam_tpu_torch.io.tum import read_tum_trajectory  # noqa: E402
from pi3_slam_tpu_torch.sfm import localize as tloc  # noqa: E402
from pi3_slam_tpu_torch.sfm.reconstruction import build_chunk_reconstruction as tbuild  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its solves are chains of small
    operations, which the oversubscribed thread pools of parallel test
    workers slow down a hundredfold; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xn(uv):
    return np.stack([(uv[:, 0] - INTR[2]) / INTR[0], (uv[:, 1] - INTR[3]) / INTR[1]], axis=1)


def _jax_samples(key, valid, num_samples=256, sample_size=8):
    """The minimal samples JAX's ransac_pnp draws from ``key``."""
    valid_f = jnp.asarray(valid, jnp.float32)
    p_sel = valid_f / jnp.maximum(valid_f.sum(), 1e-9)
    n = valid_f.shape[0]
    draw = lambda k: jax.random.choice(k, n, (sample_size,), replace=False, p=p_sel)  # noqa: E731
    return np.asarray(jax.vmap(draw)(jax.random.split(key, num_samples)))


def test_dlt_pose_matches_jax(rng):
    for n in (6, 8, 20):
        R, c, X, uv = _synthetic_view(rng, n=n)
        xn = _xn(uv)
        jR, jc = jloc.dlt_pose(jnp.asarray(X, jnp.float32), jnp.asarray(xn, jnp.float32))
        tR, tc = tloc.dlt_pose(torch.tensor(X, dtype=torch.float32),
                               torch.tensor(xn, dtype=torch.float32))
        np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
        np.testing.assert_allclose(tR.numpy(), R, atol=1e-4)
    # batched over hypotheses, as ransac_pnp calls it
    Rb, cb = tloc.dlt_pose(torch.tensor(np.stack([X[:8], X[8:16]]), dtype=torch.float32),
                           torch.tensor(np.stack([xn[:8], xn[8:16]]), dtype=torch.float32))
    np.testing.assert_allclose(Rb.numpy(), np.stack([R, R]), atol=1e-4)


@pytest.mark.parametrize("padded", [False, True])
def test_ransac_pnp_with_jax_samples_matches_jax(rng, padded):
    """30% outliers, 0.5 px noise; with ``padded`` 56 zero rows masked out,
    as JAX's bucket padding leaves them."""
    R, c, X, uv = _synthetic_view(rng)
    uv = uv + rng.normal(size=uv.shape) * 0.5
    out = rng.random(uv.shape[0]) < 0.3
    uv[out] += rng.uniform(30, 200, size=(int(out.sum()), 2))
    valid = np.ones(len(X), np.float32)
    if padded:
        X = np.concatenate([X, np.zeros((56, 3))])
        uv = np.concatenate([uv, np.zeros((56, 2))])
        valid = np.concatenate([valid, np.zeros(56, np.float32)])
    key = jax.random.PRNGKey(7)
    want = jloc._ransac_pnp_jit(jnp.asarray(X, jnp.float32), jnp.asarray(uv, jnp.float32),
                                jnp.asarray(INTR), jnp.asarray(valid), key)
    idx = _jax_samples(key, valid)
    got = tloc.ransac_pnp(X.astype(np.float32), uv.astype(np.float32), INTR, valid,
                          sample_idx=idx, device=CPU)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 0.5 * (~out).sum()
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation), atol=1e-5)
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center), atol=1e-5)
    np.testing.assert_allclose(float(got.inlier_rms_px), float(want.inlier_rms_px), rtol=1e-4)
    np.testing.assert_allclose(got.rotation.numpy(), R, atol=5e-3)
    # the hypotheses' vote alone: the DLT pose of JAX's first best sample
    timings = {}
    unrefined = tloc.ransac_pnp(X.astype(np.float32), uv.astype(np.float32), INTR, valid,
                                sample_idx=idx, refine_iterations=0, device=CPU, timings=timings)
    assert set(timings) == {"ransac_s", "refine_s"}
    jR, jc = jax.vmap(jloc.dlt_pose)(jnp.asarray(X, jnp.float32)[idx],
                                     jnp.asarray(_xn(uv), jnp.float32)[idx])
    xc = np.einsum("sij,snj->sni", np.asarray(jR), X[None] - np.asarray(jc)[:, None])
    err = np.linalg.norm(INTR[:2] * xc[..., :2] / xc[..., 2:] + INTR[2:] - uv, axis=-1)
    best = int(np.argmax(((err < 5.0) & (xc[..., 2] > 0) & (valid > 0)).sum(-1)))
    np.testing.assert_allclose(unrefined.rotation.numpy(), np.asarray(jR[best]), atol=1e-4)


def test_draw_samples_are_valid_and_distinct():
    valid = torch.zeros(40)
    valid[:25] = 1.0
    idx = tloc.draw_samples(valid, 64, 8, torch.Generator().manual_seed(3))
    assert idx.shape == (64, 8) and int(idx.max()) < 25
    assert all(len(set(row.tolist())) == 8 for row in idx)
    again = tloc.draw_samples(valid, 64, 8, torch.Generator().manual_seed(3))
    assert torch.equal(idx, again)


def test_pose_jacobian_is_the_reprojection_derivative(rng):
    """The closed form against torch.func.jacfwd of uv(exp(w) R, c + dc) at
    zero, in float64, with one point at the clamped depth."""
    R, c, X, _ = _synthetic_view(rng, n=30)
    X[0] = c + R.T @ np.array([0.1, 0.2, 1e-9])  # z below _project's 1e-8 clamp
    R, c, X = (torch.tensor(a, dtype=torch.float64) for a in (R, c, X))
    intr = torch.tensor(INTR, dtype=torch.float64)

    def uv(p):
        return tloc._project(so3_exp(p[:3]) @ R, c + p[3:], intr, X)[0].reshape(-1)

    want = torch.func.jacfwd(uv)(torch.zeros(6, dtype=torch.float64))
    got = tloc.pose_jacobian(R, c, intr, X).reshape(-1, 6)
    np.testing.assert_allclose(got[2:].numpy(), want[2:].numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got[:2].numpy(), want[:2].numpy(), rtol=1e-9)


def _triangulation_views(rng, v=4, t=80):
    Rs = np.stack([Rotation.from_euler("y", 5 * k, degrees=True).as_matrix() for k in range(v)])
    cs = np.stack([np.array([0.4 * k, 0.02 * k, 0.0]) for k in range(v)])
    X = np.stack([rng.uniform(-1.5, 1.5, t), rng.uniform(-1, 1, t), rng.uniform(3, 8, t)], axis=1)
    obs = np.zeros((t, v, 2), np.float32)
    val = np.ones((t, v), np.float32)
    for k in range(v):
        xc = (X - cs[k]) @ Rs[k].T
        obs[:, k, 0] = INTR[0] * xc[:, 0] / xc[:, 2] + INTR[2]
        obs[:, k, 1] = INTR[1] * xc[:, 1] / xc[:, 2] + INTR[3]
    obs += rng.normal(size=obs.shape) * 0.3
    val[: t // 4, 2:] = 0  # two-view tracks
    return Rs, cs, X, obs, val


def test_triangulate_points_matches_jax(rng):
    Rs, cs, X, obs, val = _triangulation_views(rng)
    want = jloc.triangulate_points(jnp.asarray(Rs, jnp.float32), jnp.asarray(cs, jnp.float32),
                                   jnp.asarray(INTR), jnp.asarray(obs), jnp.asarray(val))
    got = tloc.triangulate_points(Rs, cs, INTR, obs, val, device=CPU)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.linalg.norm(got[0].numpy() - X, axis=1).mean() < 0.05


def _seed(rng, n):
    return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 7, n)],
                    axis=1)


def _unit(rng, n, dim=64):
    d = rng.normal(size=(n, dim))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _maps(rng, seed, desc, names=("m0", "m1", "m2", "m3")):
    chunk = _make_desc_chunk(rng, list(names), seed, desc, start=0)
    return [jbuild(chunk, run_ba=False)], [tbuild(chunk, run_ba=False, device=CPU)]


def _view(seed, R, c):
    xc = (seed - c) @ R.T
    return np.stack([INTR[0] * xc[:, 0] / xc[:, 2] + INTR[2],
                     INTR[1] * xc[:, 1] / xc[:, 2] + INTR[3]], axis=1).astype(np.float32)


def test_localize_by_descriptors_matches_jax(rng):
    """tests/test_localize.py's planted map and query, with unmatched noise
    keypoints."""
    n_kp, n_noise = 64, 40
    seed, desc = _seed(rng, n_kp), _unit(rng, n_kp)
    jmap, tmap = _maps(rng, seed, desc)
    R_q = Rotation.from_euler("yxz", [15, -5, 3], degrees=True).as_matrix()
    c_q = np.array([0.5, -0.3, 0.8])
    kp = np.concatenate([_view(seed, R_q, c_q), rng.uniform(0, 600, (n_noise, 2))])
    d = np.concatenate([desc, _unit(rng, n_noise)])
    want = jloc.localize_by_descriptors(jmap, kp, d, INTR, min_inliers=12)
    timings = {}
    got = tloc.localize_by_descriptors(tmap, kp, d, INTR, min_inliers=12, device=CPU,
                                       timings=timings)
    assert got.success == want.success is True
    assert (got.num_matches, got.num_inliers) == (want.num_matches, want.num_inliers)
    np.testing.assert_allclose(got.rotation, want.rotation, atol=1e-4)
    np.testing.assert_allclose(got.center, want.center, atol=1e-3)
    np.testing.assert_allclose(got.rotation, R_q, atol=1e-3)
    np.testing.assert_allclose(got.center, c_q, atol=5e-3)
    assert set(timings) == {"match_s", "ransac_s", "refine_s"}
    # too few matches: the same early failure
    few = tloc.localize_by_descriptors(tmap, kp[:6], d[:6], INTR, device=CPU)
    assert not few.success and few.num_matches == 6 and few.num_inliers == 0


def test_register_reconstruction_matches_jax(rng):
    n_kp = 48
    seed, desc = _seed(rng, n_kp), _unit(rng, n_kp)
    jmap, tmap = _maps(rng, seed, desc)
    q_chunk = _make_desc_chunk(rng, ["q0", "q1", "q2"], seed, desc, start=1)
    jq, tq = jbuild(q_chunk, run_ba=False), tbuild(q_chunk, run_ba=False, device=CPU)
    gt = sim3_exp(jnp.asarray([0.4, -0.2, 0.3, 0.1, -0.05, 0.08, 0.15], jnp.float32))
    japply(jq, gt)
    for name in ("points", "centers", "rotations"):
        setattr(tq, name, getattr(jq, name).copy())
    want = jloc.register_reconstruction(jmap, jq, min_matches=30, min_inliers=20)
    got = tloc.register_reconstruction(tmap, tq, min_matches=30, min_inliers=20, device=CPU)
    assert got.success and want.success
    assert (got.num_matches, got.num_inliers) == (want.num_matches, want.num_inliers)
    for a, b in zip(got.sim3, want.sim3):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(got.inlier_rms, want.inlier_rms, atol=1e-5)
    np.testing.assert_allclose(tq.points[:n_kp], seed, atol=1e-3)
    np.testing.assert_allclose(tq.points, jq.points, atol=1e-4)


def test_build_query_tracks_and_triangulation_match_jax(rng):
    """tests/test_localize.py's PnP-then-triangulate story: query views of
    mapped and new points, localized against the map, their tracks chained
    and triangulated."""
    n_map, n_new = 64, 40
    seed, desc_map = _seed(rng, n_map), _unit(rng, n_map)
    _, tmap = _maps(rng, seed, desc_map)
    seed_new = np.stack([rng.uniform(-2, 2, n_new), rng.uniform(-1.5, 1.5, n_new),
                         rng.uniform(3.5, 6.5, n_new)], axis=1)
    desc_new = _unit(rng, n_new)
    dets, poses, centers = [], [], []
    for k in range(3):
        R_q = Rotation.from_euler("yx", [6 * k - 6, 2], degrees=True).as_matrix()
        c_q = np.array([0.3 * k - 0.3, 0.1, 0.2])
        uv = _view(np.concatenate([seed, seed_new]), R_q, c_q)
        d = np.concatenate([desc_map, desc_new])
        res = tloc.localize_by_descriptors(tmap, uv, d, INTR, seed=k, device=CPU)
        assert res.success
        np.testing.assert_allclose(res.center, c_q, atol=1e-2)
        dets.append({"keypoints": uv, "descriptors": d})
        poses.append(res.rotation)
        centers.append(res.center)
    got, want = tloc.build_query_tracks(dets), jloc.build_query_tracks(dets)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    pts = tloc.triangulate_points(np.stack(poses), np.stack(centers), INTR, *got, device=CPU)[0]
    jpts = jloc.triangulate_points(jnp.asarray(np.stack(poses)), jnp.asarray(np.stack(centers)),
                                   jnp.asarray(INTR), jnp.asarray(got[0]), jnp.asarray(got[1]))[0]
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=1e-4, atol=1e-4)
    err = np.min(np.linalg.norm(pts.numpy()[None] - seed_new[:, None], axis=-1), axis=1)
    assert err.max() < 0.05


# ----- the CLI -----


def _jax_parser():
    """The JAX CLI's parser (built inside its main())."""
    import argparse

    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jax_cli.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["parser"]


def test_cli_flags_match_the_jax_cli():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.required)
                for a in parser._actions if a.dest != "help"}

    got, want = flags(cli.build_parser()), flags(_jax_parser())
    assert set(got) == set(want)
    for dest in want:
        if dest != "device":
            assert got[dest] == want[dest], dest
    assert got["device"][1] == "cuda"


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """The default --device cuda without a card raises before any work; no
    CPU carry-on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--map-chunks", str(tmp_path), "--query-chunks", str(tmp_path),
                  "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _save_chunk(chunk, directory, idx):
    os.makedirs(directory, exist_ok=True)
    np.savez_compressed(
        os.path.join(directory, f"chunk_{idx:06d}.npz"),
        keypoints=chunk["keypoints"].astype(np.float16),
        points=chunk["points"].astype(np.float16),
        colors=(chunk["colors"] * 255).astype(np.uint8),
        camera_poses=chunk["camera_poses"].astype(np.float64),
        intrinsics=chunk["intrinsics"].astype(np.float32),
        image_paths=np.asarray([str(p) for p in chunk["image_paths"]]),
        original_width=chunk["original_width"],
        original_height=chunk["original_height"],
        descriptors=chunk["descriptors"].astype(np.float16))


def _run_both(argv_tail, tmp_path):
    rc_j = jax_cli.main(argv_tail + ["--output", str(tmp_path / "jax"), "--device", "cpu"])
    rc_t = cli.main(argv_tail + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    return rc_t, rc_j


def _same_stats(path_t, path_j, exact, close):
    got, want = json.load(open(path_t)), json.load(open(path_j))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in exact} == {k: w[k] for k in exact}
        for k in close:
            if w[k] is None:
                assert g[k] is None
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5)
    return got


def test_cli_register_mode_matches_jax(rng, tmp_path):
    """tests/test_localize.py's register-mode drive: a fabricated ALIKED-style
    map and a query chunk in its own displaced gauge, through both CLIs."""
    n_kp = 48
    seed, desc = _seed(rng, n_kp), _unit(rng, n_kp)
    map_dir, q_dir = str(tmp_path / "map"), str(tmp_path / "query")
    _save_chunk(_make_desc_chunk(rng, ["m0", "m1", "m2", "m3"], seed, desc, start=0), map_dir, 0)
    q = _make_desc_chunk(rng, ["q0", "q1", "q2"], seed, desc, start=1)
    disp = sim3_exp(jnp.asarray([0.3, 0.1, -0.2, 0.05, 0.04, -0.06, 0.1], jnp.float32))
    q["points"] = np.asarray(sim3_apply(disp, jnp.asarray(q["points"].reshape(-1, 3),
                                                          jnp.float32))).reshape(q["points"].shape)
    poses = q["camera_poses"].copy()
    poses[:, :3, 3] = np.asarray(sim3_apply(disp, jnp.asarray(poses[:, :3, 3], jnp.float32)))
    poses[:, :3, :3] = np.asarray(disp.rotation) @ poses[:, :3, :3]
    q["camera_poses"] = poses
    _save_chunk(q, q_dir, 0)
    rc_t, rc_j = _run_both(["--map-chunks", map_dir, "--query-chunks", q_dir,
                            "--ba-iterations", "2"], tmp_path)
    assert rc_t == rc_j == 0
    stats = _same_stats(tmp_path / "port" / "registration_stats.json",
                        tmp_path / "jax" / "registration_stats.json",
                        ("chunk", "success", "num_matches", "num_inliers"),
                        ("inlier_rms", "scale"))
    assert stats[0]["success"]
    got = read_tum_trajectory(str(tmp_path / "port" / "query_trajectory_tum.txt"))
    want = jax_read_tum(str(tmp_path / "jax" / "query_trajectory_tum.txt"))
    np.testing.assert_array_equal(got["timestamps"], want["timestamps"])
    np.testing.assert_allclose(got["positions"], want["positions"], atol=1e-4)
    assert os.path.exists(tmp_path / "port" / "combined_points.ply")
    # no query chunk: exit 2
    assert cli.main(["--map-chunks", map_dir, "--query-chunks", str(tmp_path / "none"),
                     "--device", "cpu", "--output", str(tmp_path / "x")]) == 2


def test_cli_pnp_mode_matches_jax(rng, tmp_path):
    """PnP mode with --triangulate on a map made from ALIKED's own detections:
    random ALIKED-n16 weights on a query image; the map chunk holds that
    image's keypoints, their descriptors (from the JAX extractor) and
    planted points at random depths seen from the identity pose with the
    CLI's default intrinsics, and a second frame beside it. Both CLIs
    localize both query images (the image twice) at the identity, with the
    same stats."""
    from PIL import Image

    from test_aliked import _torch_layout_state_dict

    from pi3_slam_tpu.models.aliked import CONFIGS
    from pi3_slam_tpu.models.convert import convert_aliked_state_dict, save_params_npz
    from pi3_slam_tpu.utils.keypoints import ALIKEDExtractor as JaxALIKED

    sd = _torch_layout_state_dict(CONFIGS["aliked-n16"], seed=5)
    aliked = str(tmp_path / "aliked.npz")
    save_params_npz(aliked, convert_aliked_state_dict(sd, model_name="aliked-n16"))
    h, w = 64, 84
    img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    q_dir = tmp_path / "qimgs"
    q_dir.mkdir()
    for i in range(2):
        Image.fromarray(img).save(q_dir / f"{i:04d}.png")
    det = JaxALIKED(aliked, max_num_keypoints=64).extract(
        (img.transpose(2, 0, 1)[None] / 255.0).astype(np.float32))
    keep = det["valid"][0] > 0
    kp, desc = det["keypoints"][0][keep], det["descriptors"][0][keep]
    f = float(max(w, h))
    z = rng.uniform(3, 6, len(kp))
    pts = np.stack([(kp[:, 0] - w / 2) / f * z, (kp[:, 1] - h / 2) / f * z, z], axis=1)
    # the map's second frame 0.3 m to the side (parallax for its BA and
    # pruning), its keypoints the points' projections, the same descriptors
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[1, 0, 3] = 0.3
    kp1 = np.stack([f * (pts[:, 0] - 0.3) / z + w / 2, f * pts[:, 1] / z + h / 2], axis=1)
    chunk = {"keypoints": np.stack([kp, kp1]), "points": np.stack([pts, pts]),
             "colors": np.full((2, len(kp), 3), 0.5), "camera_poses": poses,
             "intrinsics": np.tile(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]), (2, 1, 1)),
             "image_paths": ["m0.png", "m1.png"], "original_width": w, "original_height": h,
             "descriptors": np.stack([desc, desc])}
    map_dir = str(tmp_path / "map")
    _save_chunk(chunk, map_dir, 0)
    argv = ["--map-chunks", map_dir, "--query-images", str(q_dir), "--aliked-path", aliked,
            "--max-keypoints", "64", "--ba-iterations", "2", "--min-inliers", "8",
            "--triangulate"]
    rc_t, rc_j = _run_both(argv, tmp_path)
    assert rc_t == rc_j == 0
    stats = _same_stats(tmp_path / "port" / "localization_stats.json",
                        tmp_path / "jax" / "localization_stats.json",
                        ("image", "success", "num_matches", "num_inliers"), ("inlier_rms_px",))
    assert all(s["success"] for s in stats) and stats[0]["num_inliers"] >= 8
    got = read_tum_trajectory(str(tmp_path / "port" / "query_trajectory_tum.txt"))
    want = jax_read_tum(str(tmp_path / "jax" / "query_trajectory_tum.txt"))
    np.testing.assert_array_equal(got["timestamps"], want["timestamps"])
    np.testing.assert_allclose(got["positions"], want["positions"], atol=1e-3)
    np.testing.assert_allclose(got["positions"], 0.0, atol=1e-2)
    # no --aliked-path: exit 2
    assert cli.main(argv[:4] + ["--device", "cpu", "--output", str(tmp_path / "x")]) == 2


def test_mutual_nn_match_column_pass_equals_argmax(rng):
    """The matcher's column argmax (one pass over the rows) against numpy's
    argmax(axis=0) and the JAX package's matcher, with exact ties (duplicate
    descriptors on both sides)."""
    from pi3_slam_tpu.sfm.alignment import mutual_nn_match as jax_match

    from pi3_slam_tpu_torch.sfm.alignment import _column_argmax, mutual_nn_match

    q, r = _unit(rng, 300), _unit(rng, 900)
    r[10], r[700], q[5] = r[3], r[3], q[4]
    q[7] = r[3]
    sim = q @ r.T
    np.testing.assert_array_equal(_column_argmax(sim), sim.argmax(axis=0))
    np.testing.assert_array_equal(_column_argmax(np.round(sim, 1)), np.round(sim, 1).argmax(0))
    for cos in (0.0, 0.85):
        for a, b in zip(mutual_nn_match(q, r, cos), jax_match(q, r, cos)):
            np.testing.assert_array_equal(a, b)
    assert 7 in mutual_nn_match(q, r, 0.85)[0]
