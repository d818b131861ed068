"""The port's ZNCC observation refinement (``pi3_slam_tpu_torch/ops/
correlation.py``) and the chunk step's refined observation fan against the
JAX package's, on the CPU; then the tiny creator with ``--keypoints aliked
--refine-observations`` against the JAX creator, chunk array by array.

Smooth random images made from a seed; the same inputs go through both.
Sampling is held to 1e-6, the ZNCC peaks to 1e-5 and the refined
coordinates to 1e-4 px with the same refined flags.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift as ndshift

from pi3_slam_tpu.ops import correlation as jcor
from pi3_slam_tpu.slam import chunk_creator as jcc
from pi3_slam_tpu_torch.ops import correlation as tcor
from pi3_slam_tpu_torch.slam import chunk_creator as tcc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth(rng, h, w, sigma=2.0):
    img = gaussian_filter(rng.normal(size=(h, w)), sigma)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)  # in [0, 1]


def test_rgb_to_gray_matches_jax(rng):
    x = rng.uniform(size=(2, 3, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(tcor.rgb_to_gray(torch.from_numpy(x)).numpy(),
                               np.asarray(jcor.rgb_to_gray(jnp.asarray(x))), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("w", [40, 80])
def test_bilinear_sample_flat_matches_jax_to_the_last_pixel(rng, w):
    """At w >= 64 the clip bound w - 1.000001 is w - 1 in float32, so the
    right neighbour of the last column is one past the row; at the last
    frame's bottom-right pixel the flat index runs past the stack, which the
    JAX gather clamps (and the port clamps alike)."""
    n, h = 3, 72
    gray = rng.uniform(size=(n, h, w)).astype(np.float32)
    frame = rng.integers(0, n, 40)
    uv = np.stack([rng.uniform(-3, w + 3, 40), rng.uniform(-3, h + 3, 40)], axis=1)
    frame[:4] = n - 1
    uv[:4] = [[w - 1, h - 1], [w - 1, 0], [w + 5, h + 5], [w - 1.0000001, h - 1.5]]
    uv = uv.astype(np.float32)
    want = np.asarray(jcor.bilinear_sample_flat(jnp.asarray(gray), jnp.asarray(frame),
                                                jnp.asarray(uv)))
    got = tcor.bilinear_sample_flat(torch.from_numpy(gray), torch.from_numpy(frame),
                                    torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all()


def _zncc_inputs(rng, n=3, h=56, w=72, t=60, m=3):
    imgs = [_smooth(rng, h, w)]
    for k in range(1, n):
        imgs.append(ndshift(imgs[0], (0.6 * k, -0.4 * k), order=3, mode="nearest"))
    gray = np.stack(imgs)
    gray[0, :12, :12] = 0.5  # a flat corner: textureless templates
    tmpl_frame = np.zeros(t, np.int64)
    tmpl_uv = np.stack([rng.uniform(2, w - 2, t), rng.uniform(2, h - 2, t)], axis=1)
    obs_frame = rng.integers(1, n, (t, m))
    shift = np.stack([-0.4 * obs_frame, 0.6 * obs_frame], axis=-1)
    obs_uv = tmpl_uv[:, None] + shift + rng.normal(size=(t, m, 2)) * 1.2
    obs_uv[0, 0] = [w - 1, h - 1]  # the bottom-right corner of a frame
    obs_frame[0, 0] = n - 1
    obs_uv[1, 0] = [-20.0, 500.0]  # window starts clamped
    obs_uv[2, 1] = [w - 4.5, 3.5]  # ties of round(): half to even
    return (gray, tmpl_frame, tmpl_uv.astype(np.float32), obs_frame,
            obs_uv.astype(np.float32))


@pytest.mark.parametrize("radii", [(3, 4), (2, 3)])
def test_zncc_refine_matches_jax(rng, radii):
    gray, tf, tuv, of, ouv = _zncc_inputs(rng)
    kw = dict(patch_radius=radii[0], search_radius=radii[1], min_zncc=0.5)
    j_uv, j_peak, j_ok = jcor.zncc_refine_observations(
        jnp.asarray(gray), jnp.asarray(tf, jnp.int32), jnp.asarray(tuv),
        jnp.asarray(of, jnp.int32), jnp.asarray(ouv), **kw)
    t_uv, t_peak, t_ok = tcor.zncc_refine_observations(
        torch.from_numpy(gray), torch.from_numpy(tf), torch.from_numpy(tuv),
        torch.from_numpy(of), torch.from_numpy(ouv), **kw)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert 0.2 < t_ok.float().mean() < 1.0  # some refined, some gated
    np.testing.assert_allclose(t_peak.numpy(), np.asarray(j_peak), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_uv.numpy(), np.asarray(j_uv), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t_uv.numpy()[~t_ok.numpy()], ouv[~t_ok.numpy()])


def test_zncc_recovers_subpixel_shift(rng):
    """A frame shifted by a known sub-pixel offset: the refinement pulls
    noisy projections onto the true correspondence (the JAX test's bounds)."""
    h, w = 64, 80
    img0 = _smooth(rng, h, w)
    true = (1.3, -0.7)  # (dy, dx)
    img1 = ndshift(img0, true, order=3, mode="nearest")
    t = 50
    tu, tv = rng.uniform(15, w - 15, t), rng.uniform(15, h - 15, t)
    err = rng.normal(size=(t, 2))
    obs_uv = np.stack([tu + true[1] + err[:, 0], tv + true[0] + err[:, 1]], axis=1)[:, None]
    ruv, peak, ok = tcor.zncc_refine_observations(
        torch.from_numpy(np.stack([img0, img1])), torch.zeros(t, dtype=torch.long),
        torch.tensor(np.stack([tu, tv], axis=1), dtype=torch.float32),
        torch.ones((t, 1), dtype=torch.long), torch.tensor(obs_uv, dtype=torch.float32),
        patch_radius=4, search_radius=4)
    ok = ok.numpy()[:, 0]
    gt = np.stack([tu + true[1], tv + true[0]], axis=1)
    before = np.linalg.norm(obs_uv[:, 0] - gt, axis=1)
    after = np.linalg.norm(ruv.numpy()[:, 0] - gt, axis=1)
    assert ok.mean() > 0.9
    assert after[ok].mean() < 0.25
    assert after[ok].mean() < 0.3 * before[ok].mean()
    assert float(peak.numpy()[:, 0][ok].mean()) > 0.9


def test_fan_table_matches_jax():
    for n_real, n_pad, m in ((5, 5, 4), (3, 6, 10), (12, 12, 5), (1, 4, 3)):
        np.testing.assert_array_equal(tcc._fan_table(n_real, n_pad, m),
                                      jcc._fan_table(n_real, n_pad, m))


def _exact_scene(rng, n=4, k=30, h=60, w=80, f=70.0):
    """Cameras along x over a textured cloud; each frame's keypoints are exact
    projections (the JAX test's scene)."""
    seed = np.stack([rng.uniform(-1.5, 1.5, k), rng.uniform(-1.0, 1.0, k),
                     rng.uniform(4, 7, k)], axis=1)
    centers = np.stack([0.35 * np.arange(n), np.zeros(n), np.zeros(n)], axis=1)
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, 3] = centers
    kp = np.zeros((n, k, 2))
    for i in range(n):
        xc = seed - centers[i]
        kp[i, :, 0] = f * xc[:, 0] / xc[:, 2] + w / 2.0
        kp[i, :, 1] = f * xc[:, 1] / xc[:, 2] + h / 2.0
    return kp, np.tile(seed[None], (n, 1, 1)), poses, f


@pytest.mark.parametrize("case", ["refine", "degenerate-focal", "no-intrinsics", "padded"])
def test_step_refinement_matches_jax(rng, case):
    """The in-step fan (_project_and_refine_observations) on one scene: the
    images are shifted copies of one texture, so projections refine; a
    frame with focal <= 1 takes the default intrinsics; without intrinsics
    every frame does; with padded frames (fan over 3 real of 4) the padded
    row has no slot."""
    n, h, w = 4, 60, 80
    kp, pts, poses, f = _exact_scene(rng, n, h=h, w=w)
    base = _smooth(rng, h, w)
    imgs = np.stack([ndshift(base, (0, -3.0 * i), order=3, mode="nearest") for i in range(n)])
    imgs = np.repeat(imgs[:, None], 3, axis=1)
    fx = np.full(n, f, np.float32)
    if case == "degenerate-focal":
        fx[2] = 0.5
    cam = {"fx": fx, "fy": np.full(n, f, np.float32), "cx": np.full(n, w / 2.0, np.float32),
           "cy": np.full(n, h / 2.0, np.float32)}
    if case == "no-intrinsics":
        cam = None
    n_real = 3 if case == "padded" else n
    cand = jcc._fan_table(n_real, n, 4)
    settings = (4, 3, 4, 0.5)
    want = jcc._project_and_refine_observations(
        jnp.asarray(imgs), jnp.asarray(kp, jnp.float32), jnp.asarray(pts, jnp.float32),
        jnp.asarray(poses, jnp.float32),
        None if cam is None else {k: jnp.asarray(v) for k, v in cam.items()}, settings,
        jnp.asarray(cand))
    got = tcc._project_and_refine_observations(
        torch.from_numpy(imgs), torch.tensor(kp, dtype=torch.float32),
        torch.tensor(pts, dtype=torch.float32), torch.tensor(poses, dtype=torch.float32),
        None if cam is None else {k: torch.from_numpy(v) for k, v in cam.items()}, settings,
        torch.from_numpy(cand))
    assert got.keys() == want.keys()
    for key in ("obs_frame", "obs_valid", "obs_refined"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    assert got["obs_frame"].dtype == torch.int32
    np.testing.assert_allclose(got["obs_uv"].numpy(), np.asarray(want["obs_uv"]), atol=1e-4,
                               rtol=0)
    if case == "refine":
        assert got["obs_refined"].float().mean() > 0.2


def _write_inputs(root):
    """8 frames (shifted copies of one texture), a tiny Pi3 checkpoint (the
    JAX writer) and a tiny ALIKED npz (aliked-t16, the port's writer)."""
    from PIL import Image

    from pi3_slam_tpu.models import pi3 as jax_pi3
    from pi3_slam_tpu.models.convert import save_pi3_checkpoint
    from pi3_slam_tpu_torch.models.aliked import CONFIGS, init_aliked_params
    from pi3_slam_tpu_torch.models.convert import init_pi3_params, save_params_npz
    from test_torch_chunk_creator import CFG

    rng = np.random.default_rng(5)
    frames = root / "frames"
    frames.mkdir()
    base = (np.stack([_smooth(rng, 64, 84, 1.5) for _ in range(3)], -1) * 255).astype(np.uint8)
    for i in range(8):
        Image.fromarray(np.roll(base, 2 * i, axis=1)).save(frames / f"f_{i:03d}.png")
    ckpt = str(root / "pi3_tiny.npz")
    tree = init_pi3_params(1, CFG)
    save_pi3_checkpoint(ckpt, tree, jax_pi3.Pi3Config.from_json(CFG.to_json()))
    aliked = str(root / "aliked_t16.npz")
    save_params_npz(aliked, {**init_aliked_params(0, CONFIGS["aliked-t16"]),
                             "_model_name": "aliked-t16"})
    return str(frames), ckpt, aliked


@pytest.fixture(scope="module")
def appearance_runs(tmp_path_factory):
    """Both creator CLIs with --keypoints aliked --refine-observations on the
    same inputs: windows of 5 with overlap 2 (5, 5 and a 2-frame tail padded
    to 5)."""
    import create_offline_chunks as jax_cli
    from pi3_slam_tpu_torch import create_offline_chunks as torch_cli

    root = tmp_path_factory.mktemp("appearance")
    frames, ckpt, aliked = _write_inputs(root)
    common = ["--images", frames, "--model-path", ckpt, "--chunk-length", "5", "--overlap", "2",
              "--max-kp", "40", "--pixel-limit", "4000", "--device", "cpu",
              "--compute-dtype", "float32", "--num-workers", "1", "--no-metric-depth",
              "--keypoints", "aliked", "--aliked-path", aliked, "--refine-observations",
              "--refine-max-observations", "4"]
    out_j, out_t = str(root / "jax"), str(root / "torch")
    assert jax_cli.main(common + ["--output", out_j]) == 0
    records = torch_cli.create_chunks(common + ["--output", out_t])
    return out_j, out_t, records


def _chunks(out):
    with open(os.path.join(out, "chunks_manifest.json")) as f:
        manifest = json.load(f)
    result = []
    for entry in manifest:
        with np.load(os.path.join(out, "chunks", entry["file"])) as z:
            result.append({k: z[k] for k in z.files})
    return result


@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_creator_appearance_chunks_match_jax(appearance_runs, chunk):
    """Every key of the JAX creator's chunk with its dtype and shape; ALIKED's
    keypoints within fp16 storage of 1e-4 px apart, its validity and the
    masks equal, descriptors (fp16) within 2e-3; the rest as
    tests/test_torch_chunk_creator.py holds them. The refined fan projects
    through the estimated focals, which that file shows to be ill-posed on
    the random tiny model (1e-7 input differences move them by percents):
    its frames are held exactly, its validity and refined flags on all but
    1% of the slots, its coordinates to 1% of max(1, |uv|) where the flags
    agree. The step itself is held to 1e-4 px on fixed intrinsics above."""
    from test_torch_chunk_creator import FLOAT_TOL, _check_intrinsics

    out_j, out_t, _ = appearance_runs
    cj, ct = _chunks(out_j)[chunk], _chunks(out_t)[chunk]
    assert set(ct) == set(cj)
    assert {"keypoint_valid", "descriptors", "obs_frame", "obs_uv", "obs_valid",
            "obs_refined"} <= set(ct)
    for key in sorted(cj):
        a, b = cj[key], ct[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key == "intrinsics":
            _check_intrinsics(a, b)
        elif key in FLOAT_TOL:
            np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), err_msg=key,
                                       **FLOAT_TOL[key])
        elif key == "keypoints":  # fp16 storage: one ulp at most
            np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), atol=0.04,
                                       rtol=0, err_msg=key)
        elif key == "descriptors":
            np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), atol=2e-3,
                                       rtol=0, err_msg=key)
        elif key in ("obs_valid", "obs_refined"):
            assert (a != b).mean() <= 0.01, key
        elif key == "obs_uv":
            same = (cj["obs_refined"] == ct["obs_refined"]) & (cj["obs_valid"] == ct["obs_valid"])
            scale = np.maximum(1.0, np.abs(a).max(-1))
            assert (np.abs(b - a).max(-1)[same] <= 0.01 * scale[same]).all(), key
        elif key == "colors":
            assert np.abs(b.astype(int) - a.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)
    assert ct["obs_frame"].dtype == np.int16 and ct["obs_uv"].dtype == np.float32
    n = ct["keypoints"].shape[0]
    assert not ct["obs_valid"][ct["obs_frame"] >= n].any()
    assert (ct["masks"] <= ct["keypoint_valid"]).all()


def test_creator_records_the_appearance_times(appearance_runs):
    _, _, records = appearance_runs
    for r in records:
        assert r["aliked_s"] > 0 and r["refine_s"] > 0


def test_reconstructor_reads_the_refined_fan_as_jax_does(appearance_runs):
    """Step 0's check of the stored-observation branch: the port's
    build_chunk_reconstruction on refined chunks gives the JAX one's
    observations, track validity and descriptors."""
    from pi3_slam_tpu.sfm.reconstruction import build_chunk_reconstruction as jax_build
    from pi3_slam_tpu.slam.offline_reconstructor import load_chunk_npz as jax_load
    from pi3_slam_tpu_torch.sfm.reconstruction import build_chunk_reconstruction
    from pi3_slam_tpu_torch.slam.offline_reconstructor import load_chunk_npz

    out = appearance_runs[1]
    for path in sorted(os.listdir(os.path.join(out, "chunks"))):
        p = os.path.join(out, "chunks", path)
        want = jax_build(jax_load(p), max_observations_per_track=7, run_ba=False)
        got = build_chunk_reconstruction(load_chunk_npz(p), max_observations_per_track=7,
                                         run_ba=False)
        assert got.obs_frame.shape[1] == 4  # the stored width wins
        for key in ("obs_frame", "obs_uv", "obs_valid", "track_valid", "track_uv", "points",
                    "track_desc", "intrinsics"):
            np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
