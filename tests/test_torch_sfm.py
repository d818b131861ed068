"""The port's SfM modules against the JAX package on the CPU: SO3 helpers,
Sim3 and the Umeyama fits, one damped Gauss-Newton step of the bundle
adjustment in four configurations, the whole solve with its iteration count,
outlier pruning, and the host track matcher.

Inputs are made with numpy from a seed and handed to both packages in fp32.
Tolerances: the per-step functions agree to fp32 rounding in another
summation order (atol 1e-5 on unit-scale geometry, rtol 1e-4 on costs);
a damped GN step solves normal equations whose fp32 error depends on the
solver's order, so both packages' steps are held to the step in float64
(GN_STEP_ATOL). A whole LM solve compares two fp32 costs at every step, so a 1e-7 difference
can flip an accept / reject on an ill-posed problem; the whole-solve tests
therefore use well-posed synthetic scenes (cameras on an arc, points in
front, 4-6 observations each, the gauge fixed by two fixed cameras: without
them only the LM damping holds the 7 gauge directions, and fp32 rounding
moves the step along them by ~5e-5) and hold the solution to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import pi3_slam_tpu.geometry.sim3 as jsim3
import pi3_slam_tpu.geometry.transforms as jtf
import pi3_slam_tpu.sfm.ba as jba
import pi3_slam_tpu.sfm.native as jnative
from pi3_slam_tpu_torch.geometry import sim3 as tsim3
from pi3_slam_tpu_torch.geometry import transforms as ttf
from pi3_slam_tpu_torch.io.tum import quaternions_wxyz
from pi3_slam_tpu_torch.sfm import ba as tba
from pi3_slam_tpu_torch.sfm import native as tnative


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# --- SO3 and quaternions ---------------------------------------------------


@pytest.mark.parametrize("scale", [1e-8, 1e-3, 0.5, 2.5])
def test_so3_exp_log_skew_match_jax(rng, scale):
    """Angles on both sides of the Taylor branches (theta^2 < 1e-12 in exp,
    theta < 1e-6 in log)."""
    w = rng.normal(size=(20, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * scale
    np.testing.assert_allclose(_np(ttf.skew(_t(w))), np.asarray(jtf.skew(jnp.asarray(w))))
    R_t, R_j = ttf.so3_exp(_t(w)), jtf.so3_exp(jnp.asarray(w))
    np.testing.assert_allclose(_np(R_t), np.asarray(R_j), atol=1e-6)
    np.testing.assert_allclose(_np(ttf.so3_log(R_t)), np.asarray(jtf.so3_log(R_j)),
                               atol=2e-6 if scale < 1 else 5e-5)


def test_quaternion_and_transform_points_match_jax(rng):
    R = Rotation.random(64, random_state=0).as_matrix()
    R[:4] = np.diag([1.0, -1.0, -1.0])  # trace -1: the non-trace branches
    # the TUM writers' quaternions: float64 rotations in, the same float32 bits out
    np.testing.assert_array_equal(quaternions_wxyz(R),
                                  np.asarray(jtf.rotation_matrix_to_quaternion(R)))
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, :3, :3] = R[4:7]
    T[:, :3, 3] = rng.normal(size=(3, 3))
    pts = rng.normal(size=(3, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(ttf.transform_points(_t(T), _t(pts))),
                               np.asarray(jtf.transform_points(jnp.asarray(T), jnp.asarray(pts))),
                               atol=1e-6)


# --- Sim3 ------------------------------------------------------------------


def _sim3(rng):
    R = Rotation.from_rotvec(rng.normal(size=3) * 0.7).as_matrix().astype(np.float32)
    return np.float32(rng.uniform(0.5, 2.0)), R, rng.normal(size=3).astype(np.float32)


def _same_sim3(a, b, atol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), np.asarray(y), atol=atol)


def test_sim3_algebra_matches_jax(rng):
    (s1, R1, t1), (s2, R2, t2) = _sim3(rng), _sim3(rng)
    ta = tsim3.Sim3(torch.tensor(s1), _t(R1), _t(t1))
    tb = tsim3.Sim3(torch.tensor(s2), _t(R2), _t(t2))
    ja = jsim3.Sim3(jnp.asarray(s1), jnp.asarray(R1), jnp.asarray(t1))
    jb = jsim3.Sim3(jnp.asarray(s2), jnp.asarray(R2), jnp.asarray(t2))
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tsim3.sim3_apply(ta, _t(pts))),
                               np.asarray(jsim3.sim3_apply(ja, jnp.asarray(pts))), atol=1e-5)
    _same_sim3(tsim3.sim3_inverse(ta), jsim3.sim3_inverse(ja), 1e-5)
    _same_sim3(tsim3.sim3_compose(ta, tb), jsim3.sim3_compose(ja, jb), 1e-5)
    np.testing.assert_allclose(_np(tsim3.sim3_matrix(ta)), np.asarray(jsim3.sim3_matrix(ja)),
                               atol=1e-6)
    np.testing.assert_allclose(_np(tsim3.sim3_log(ta)), np.asarray(jsim3.sim3_log(ja)), atol=2e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-7, 0.3])
def test_sim3_exp_matches_jax(rng, scale):
    """Tangents at and near zero take the Taylor branches of the W matrix."""
    xi = (rng.normal(size=(8, 7)) * scale).astype(np.float32)
    _same_sim3(tsim3.sim3_exp(_t(xi)), jsim3.sim3_exp(jnp.asarray(xi)), 1e-6)


def test_umeyama_and_robust_umeyama_match_jax(rng):
    s, R, t = _sim3(rng)
    src = rng.normal(size=(300, 3)).astype(np.float32) * 3
    dst = (s * src @ R.T + t + rng.normal(size=src.shape) * 0.01).astype(np.float32)
    dst[:30] += rng.normal(size=(30, 3)).astype(np.float32) * 5  # gross outliers
    w = rng.uniform(0.5, 1.0, 300).astype(np.float32)
    _same_sim3(tsim3.umeyama(_t(src), _t(dst), _t(w)),
               jsim3.umeyama(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)), 2e-5)
    _same_sim3(tsim3.umeyama(_t(src), _t(dst), with_scale=False),
               jsim3.umeyama(jnp.asarray(src), jnp.asarray(dst), with_scale=False), 2e-5)
    got = tsim3.robust_umeyama(_t(src), _t(dst), huber_delta=1.0, iterations=5)
    want = jsim3.robust_umeyama(jnp.asarray(src), jnp.asarray(dst), huber_delta=1.0, iterations=5)
    _same_sim3(got, want, 2e-5)
    np.testing.assert_allclose(float(got.scale), s, rtol=1e-3)  # the outliers were rejected


def test_sim3_from_camera_poses_matches_jax(rng):
    n = 6
    R_ref = Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.1).as_matrix().astype(np.float32)
    c_ref = np.stack([np.linspace(0, 2, n), np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    s, R, t = _sim3(rng)
    c_q = ((c_ref - t) @ R / s).astype(np.float32)  # the inverse Sim3 of the centers
    R_q = (R_ref @ R).astype(np.float32)
    got = tsim3.sim3_from_camera_poses(_t(R_ref), _t(c_ref), _t(R_q), _t(c_q))
    want = jsim3.sim3_from_camera_poses(*map(jnp.asarray, (R_ref, c_ref, R_q, c_q)))
    _same_sim3(got, want, 2e-5)
    np.testing.assert_allclose(_np(got.rotation), R, atol=1e-4)


# --- bundle adjustment -------------------------------------------------------


def make_scene(rng, n_frames=6, n_tracks=60, obs=4, noise_px=0.5, perturb=0.03,
               owner_layout=False):
    """Cameras on an arc looking at points at depth 4-8; observations of each
    track in ``obs`` frames (the owner frame first), pixel noise, and the
    poses and points perturbed from the truth. With ``owner_layout`` the
    tracks are laid out (owner frame, keypoint) with one candidate-frame row
    per owner, the layout the grouped Schur path takes."""
    k = n_tracks // n_frames if owner_layout else None
    pts = np.stack([rng.uniform(-2, 2, n_tracks), rng.uniform(-2, 2, n_tracks),
                    rng.uniform(4, 8, n_tracks)], axis=1)
    centers = np.stack([np.linspace(-1.5, 1.5, n_frames), 0.1 * np.sin(np.arange(n_frames)),
                        np.zeros(n_frames)], axis=1)
    R_cw = np.stack([Rotation.from_euler("y", -0.1 * c).as_matrix() for c in centers[:, 0]])
    intr = np.tile([500.0, 500.0, 320.0, 240.0], (n_frames, 1))
    obs_frame = np.zeros((n_tracks, obs), np.int32)
    for t in range(n_tracks):
        if owner_layout:
            owner = t // k
            others = np.random.default_rng(owner).permutation(
                [f for f in range(n_frames) if f != owner])[: obs - 1]
            obs_frame[t] = [owner, *others]
        else:
            obs_frame[t] = rng.choice(n_frames, size=obs, replace=False)
    xc = np.einsum("tmij,tmj->tmi", R_cw[obs_frame], pts[:, None] - centers[obs_frame])
    uv = intr[obs_frame][..., :2] * xc[..., :2] / xc[..., 2:] + intr[obs_frame][..., 2:]
    uv += rng.normal(size=uv.shape) * noise_px
    R_pert = Rotation.from_rotvec(rng.normal(size=(n_frames, 3)) * perturb * 0.3).as_matrix()
    return dict(
        rotations=np.einsum("nij,njk->nik", R_pert, R_cw),
        centers=centers + rng.normal(size=centers.shape) * perturb,
        points=pts + rng.normal(size=pts.shape) * perturb,
        intrinsics=intr, obs_frame=obs_frame, obs_uv=uv,
        obs_valid=(rng.uniform(size=obs_frame.shape) > 0.1).astype(np.float64),
    ), k


def _problems(scene, **extra):
    return jba.make_problem(**scene, **extra), tba.make_problem(**scene, **extra)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=0)


GN_CASES = {
    "grouped": dict(owner_layout=True),
    "ungrouped": dict(),
    "inverse_depth": dict(inverse_depth=True),
    "optimize_focal": dict(optimize_focal=True),
    "priors_gravity": dict(priors=True),
}


# Bounds of an fp32 GN step against the same step in float64 (rotations,
# centers, points, intrinsics fx..cy). Fp32's own error on the damped normal
# equations, over these five cases and seeds 0-5 of the scene, reaches 2.6e-6,
# 2.2e-5, 2e-5 and 1.9e-3 (on focal), the same in both packages, which sum in
# different orders (MKL's and XLA's solves, and the order follows the CPU).
# Each bound sits ~4x above that; a step with lambda x10 is off by at least
# 2.6e-3, 1.6e-2, 1.5e-2 (and 2.1 on focal), one without the focal block by
# 4e-4, 1.4e-2, 5e-3 and 1.5: at least 20x the bound.
GN_STEP_ATOL = (2e-5, 1e-4, 1e-4, 1e-2)


def _f64_problem(p):
    return p._replace(**{f: v.double() for f, v in p._asdict().items() if v.is_floating_point()})


def _step_within(step, ref):
    """Whether each quantity of ``step`` lies within GN_STEP_ATOL of ``ref``."""
    return [bool(np.abs(_np(s) - r.numpy()).max() <= atol)
            for s, r, atol in zip(step, ref, GN_STEP_ATOL)]


@pytest.mark.parametrize("case", list(GN_CASES))
def test_gn_step_matches_jax(rng, case):
    """One damped GN step (and the cost before and after it) in each of the
    solver's configurations, cameras 0 and 1 fixed; 'grouped' takes the
    owner-grouped Schur accumulation, 'priors_gravity' adds pose priors on
    half the frames and gravity residuals. Both packages' fp32 steps are
    held to the port's step in float64 (GN_STEP_ATOL), and the bounds are
    shown to reject a step with lambda x10 and one without the focal block."""
    opts = GN_CASES[case]
    scene, k = make_scene(rng, n_tracks=60, obs=4, owner_layout=opts.get("owner_layout", False))
    extra, fixed = {}, np.r_[1.0, 1.0, np.zeros(4)].astype(np.float32)
    if opts.get("priors"):
        n = 6
        extra = dict(
            prior_rotations=Rotation.from_rotvec(rng.normal(size=(n, 3)) * 0.05).as_matrix(),
            prior_centers=scene["centers"] + rng.normal(size=(n, 3)) * 0.1,
            prior_rot_weight=np.r_[np.full(3, 0.5), np.zeros(3)],
            prior_pos_weight=np.r_[np.full(3, 0.04), np.zeros(3)],
            gravity_dirs=rng.normal(size=(n, 3)) * 0.1 + [0, -1, 0],
            gravity_weight=np.full(n, 400.0),
            gravity_world=np.array([0.0, -1.0, 0.0]),
        )
    jp, tp = _problems(scene, **extra)
    kw = dict(optimize_focal=opts.get("optimize_focal", False),
              inverse_depth=opts.get("inverse_depth", False), tracks_per_frame=k)
    lam = 1e-3
    want = jba._gn_step(jp, 2.0, jnp.asarray(lam, jnp.float32), jnp.asarray(fixed), **kw)
    got = tba._gn_step(tp, 2.0, torch.tensor(lam), _t(fixed), **kw)
    tp64, fixed64 = _f64_problem(tp), torch.from_numpy(fixed).double()
    step64 = lambda lam, **over: tba._gn_step(
        tp64, 2.0, torch.tensor(lam, dtype=torch.float64), fixed64, **dict(kw, **over))
    ref = step64(lam)
    assert _step_within(got, ref) == [True] * 4, "the port's fp32 step"
    assert _step_within(want, ref) == [True] * 4, "the JAX package's fp32 step"
    assert not all(_step_within(step64(10 * lam), ref))
    if kw["optimize_focal"]:
        assert not all(_step_within(step64(lam, optimize_focal=False), ref))
    np.testing.assert_allclose(float(tba._cost(tp, 2.0)), float(jba._cost(jp, 2.0)), rtol=1e-5)
    cand_j = jp._replace(rotations=want[0], centers=want[1], points=want[2], intrinsics=want[3])
    cand_t = tp._replace(rotations=got[0], centers=got[1], points=got[2], intrinsics=got[3])
    np.testing.assert_allclose(float(tba._cost(cand_t, 2.0)), float(jba._cost(cand_j, 2.0)),
                               rtol=1e-4)


def test_grouped_step_equals_ungrouped_step(rng):
    scene, k = make_scene(rng, n_tracks=60, obs=4, owner_layout=True)
    _, tp = _problems(scene)
    lam, fixed = torch.tensor(1e-3), torch.tensor([1.0, 1.0, 0, 0, 0, 0])
    g = tba._gn_step(tp, 2.0, lam, fixed, tracks_per_frame=k)
    u = tba._gn_step(tp, 2.0, lam, fixed)
    for a, b in zip(g, u):
        _close(a, b.numpy(), 2e-5)


@pytest.mark.parametrize("n,trailing", [(7, (6, 6)), (50, (7,)), (1, ()), (3, (2, 3)), (400, ())])
def test_fixed_order_segment_sum_matches_index_add(rng, n, trailing):
    """The BA's segment sum (stable sort once, then each segment in row
    order) against index_add_ on random rows: indices repeat, some segments
    are empty (the index never reaches n - 1 for n > 1), and the sums agree
    to fp32 rounding in another order."""
    rows = 300
    index = torch.from_numpy(rng.integers(0, max(n - 1, 1), rows)).long()
    values = _t(rng.normal(size=(rows, *trailing)))
    want = torch.zeros((n, *trailing)).index_add_(0, index, values)
    seg = tba._segments(index, n)
    assert int(seg.lengths.sum()) == rows and (n == 1 or int(seg.lengths[-1]) == 0)
    got = tba._segment_sum(values, seg)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.sort(seg.order.numpy()), np.arange(rows))


@pytest.mark.parametrize("ftol", [0.0, 1e-3])
def test_bundle_adjust_matches_jax_with_iteration_count(rng, ftol):
    """The whole LM solve on a well-posed scene: the same solution, final
    cost and iteration count; cameras 0 and 1 fixed. With ftol 1e-3 the
    early stop fires well before the budget of 30, at a step whose relative
    decrease is far from the threshold (at 1e-6 this scene stops where the
    decrease is within fp32 noise of it, one step apart in the two
    packages)."""
    scene, k = make_scene(rng, n_tracks=120, obs=5, owner_layout=True)
    jp, tp = _problems(scene)
    fixed = np.r_[1.0, 1.0, np.zeros(4)].astype(np.float32)
    want, info_j = jba.bundle_adjust(jp, iterations=30, tracks_per_frame=k, ftol=ftol,
                                     fixed_cameras=jnp.asarray(fixed), return_info=True)
    got, info_t = tba.bundle_adjust(tp, iterations=30, tracks_per_frame=k, ftol=ftol,
                                    fixed_cameras=_t(fixed), return_info=True)
    assert info_t["iterations"] == int(info_j["iterations"])
    if ftol:
        assert info_t["iterations"] < 30
    np.testing.assert_allclose(float(info_t["final_cost"]), float(info_j["final_cost"]),
                               rtol=1e-4)
    for name, atol in (("rotations", 1e-4), ("centers", 1e-4), ("points", 2e-4)):
        _close(getattr(got, name), getattr(want, name), atol)


def test_run_bundle_adjust_records_last_ba_info(rng):
    scene, k = make_scene(rng, n_tracks=60, obs=4, owner_layout=True)
    _, tp = _problems(scene)
    tba.run_bundle_adjust(tp, 7, 2.0, tracks_per_frame=k, ftol=0.0)
    assert tba.last_ba_info()["iterations"] == 7
    assert np.isfinite(tba.last_ba_info()["final_cost"])


@pytest.mark.parametrize("inverse_depth", [False, True])
def test_bundle_adjust_converges(rng, inverse_depth):
    """From perturbed poses and points to the noise floor (0.5 px noise)."""
    scene, k = make_scene(rng, n_tracks=120, obs=5, owner_layout=True, perturb=0.05)
    _, tp = _problems(scene)
    before = tba.reprojection_errors(tp)
    out = tba.bundle_adjust(tp, iterations=20, tracks_per_frame=k,
                            use_inverse_depth=inverse_depth)
    after = tba.reprojection_errors(out)
    assert before[torch.isfinite(before)].median() > 5.0
    assert after[torch.isfinite(after)].median() < 1.0


def test_reprojection_errors_and_prune_match_jax(rng):
    scene, _ = make_scene(rng, n_tracks=80, obs=4)
    scene["obs_uv"][:5, 1] += 30.0  # reprojection outliers
    scene["points"][5:8] = scene["centers"][scene["obs_frame"][5:8, 0]] + [0, 0, 50.0]  # far:
    # tiny triangulation angle
    jp, tp = _problems(scene)
    e_t, e_j = tba.reprojection_errors(tp).numpy(), np.asarray(jba.reprojection_errors(jp))
    assert (np.isfinite(e_t) == np.isfinite(e_j)).all()
    np.testing.assert_allclose(e_t[np.isfinite(e_t)], e_j[np.isfinite(e_j)], rtol=1e-5, atol=1e-4)
    for px, deg in ((15.0, 0.25), (60.0, 2.0)):
        keep_t = tba.prune_outlier_tracks(tp, px, deg).numpy()
        keep_j = np.asarray(jba.prune_outlier_tracks(jp, px, deg))
        np.testing.assert_array_equal(keep_t, keep_j)
        assert 0 < keep_t.sum() < len(keep_t)


# --- host track matching -----------------------------------------------------


def test_match_tracks_matches_jax(rng):
    n_a, n_b = 300, 250
    fa = rng.integers(0, 6, n_a).astype(np.int32)
    fb = rng.integers(0, 5, n_b).astype(np.int32)
    uv_a = rng.uniform(0, 640, (n_a, 2)).astype(np.float32)
    uv_b = rng.uniform(0, 640, (n_b, 2)).astype(np.float32)
    fmap = np.array([3, 4, 5, -1, 0], np.int32)
    hit = rng.choice(n_b, 120, replace=False)
    for i, t in enumerate(hit):  # shared keypoints, a little sub-quantum jitter
        src = rng.integers(n_a)
        if fmap[fb[t]] >= 0:
            fa[src] = fmap[fb[t]]
            uv_b[t] = uv_a[src] + rng.uniform(-0.05, 0.05, 2)
    va = (rng.uniform(size=n_a) > 0.1).astype(np.float32)
    vb = (rng.uniform(size=n_b) > 0.1).astype(np.float32)
    got = tnative.match_tracks(fa, uv_a, va, fb, uv_b, vb, fmap)
    want = jnative.match_tracks(fa, uv_a, va, fb, uv_b, vb, fmap)
    assert got[0].size > 40
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
