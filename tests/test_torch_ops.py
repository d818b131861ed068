"""The port's plain ops (pi3_slam_tpu_torch) against the JAX package's, on
the CPU: RoPE, pixel shuffle, position-embedding interpolation,
grid_sample_frames, depth_edge and the other map utilities, the SE3 helpers,
the focal solver, grid keypoints and the npz writer. Inputs are made with
numpy from a seed and fed to both. Unless a test says otherwise both sides
compute in fp32, so tolerances are fp32 rounding ones.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pi3_slam_tpu.geometry import focal as jfocal
from pi3_slam_tpu.geometry import maps as jmaps
from pi3_slam_tpu.geometry import transforms as jtf
from pi3_slam_tpu.io.npz import save_npz as jax_save_npz
from pi3_slam_tpu.ops import interpolate as jinterp
from pi3_slam_tpu.ops import pixel_shuffle as jps
from pi3_slam_tpu.ops import rope as jrope
from pi3_slam_tpu.utils import keypoints as jkp

from pi3_slam_tpu_torch.geometry import focal as tfocal
from pi3_slam_tpu_torch.geometry import maps as tmaps
from pi3_slam_tpu_torch.geometry import transforms as ttf
from pi3_slam_tpu_torch.io.npz import save_npz
from pi3_slam_tpu_torch.ops import interpolate as tinterp
from pi3_slam_tpu_torch.ops import pixel_shuffle as tps
from pi3_slam_tpu_torch.ops import rope as trope
from pi3_slam_tpu_torch.utils import keypoints as tkp


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
    return torch.from_numpy(np.array(a))


def test_patch_positions_and_rope_tables_match():
    pj = jrope.make_patch_positions(3, 4, 5, num_special=5, offset=1)
    pt = trope.make_patch_positions(3, 4, 5, num_special=5, offset=1)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    for d in (32, 64):
        cj, sj = jrope.rope_tables(pj, d, base=100.0)
        ct, st = trope.rope_tables(pt, d, base=100.0)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)


@pytest.mark.parametrize("d", [32, 64])
def test_rope_2d_matches(rng, d):
    x = rng.standard_normal((2, 25, 3, d)).astype(np.float32)
    pos = np.asarray(jrope.make_patch_positions(2, 4, 5, num_special=5, offset=1))
    want = jrope.rope_2d(jnp.asarray(x), jnp.asarray(pos), 100.0)
    got = trope.rope_2d(_t(x), _t(pos), 100.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_tokens_to_image_matches(rng):
    tok = rng.standard_normal((2, 6, 3 * 14 * 14)).astype(np.float32)
    want = jps.tokens_to_image(jnp.asarray(tok), (2, 3), 14, 3)
    got = tps.tokens_to_image(_t(tok), (2, 3), 14, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "grid_hw,offset,antialias",
    [
        ((22, 29), 0.0, True),  # Pi3 at 308x406: antialiased downsample of the 37x37 grid
        ((40, 45), 0.0, True),  # upsample
        ((22, 29), 0.1, False),  # plain DINOv2 variant: scale-factor mapping
    ],
)
def test_interpolate_pos_embed_matches(rng, grid_hw, offset, antialias):
    """torch's bicubic F.interpolate against the JAX interpolation matrices."""
    pos = rng.standard_normal((37 * 37, 16)).astype(np.float32)
    want = jinterp.interpolate_pos_embed(jnp.asarray(pos), grid_hw, offset, antialias)
    got = tinterp.interpolate_pos_embed(_t(pos), grid_hw, offset, antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_frames_matches(rng, mode):
    maps = rng.standard_normal((3, 28, 42, 4)).astype(np.float32)
    kp = np.concatenate(
        [
            rng.uniform(-3, 45, (3, 50, 1)),  # beyond the border on both sides
            rng.uniform(-3, 31, (3, 50, 1)),
        ],
        axis=-1,
    ).astype(np.float32)
    kp[:, :4] = [[0, 0], [41, 27], [20.5, 13.5], [7.25, 3.75]]  # edges, half-pixels
    want = jinterp.grid_sample_frames(jnp.asarray(maps), jnp.asarray(kp), mode=mode)
    got = tinterp.grid_sample_frames(_t(maps), _t(kp), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("with_mask", [False, True])
def test_depth_edge_matches(rng, with_mask):
    depth = (1.5 + 0.005 * rng.random((3, 20, 24))).astype(np.float32)
    depth[:, 5:9, 7:12] += 2.0  # discontinuities
    depth[1, 15:, 20:] += 0.03  # a step near the rtol threshold
    mask = rng.random((3, 20, 24)) > 0.2 if with_mask else None
    kw = dict(rtol=0.03, atol=0.5)
    want = jmaps.depth_edge(jnp.asarray(depth), mask=None if mask is None else jnp.asarray(mask), **kw)
    got = tmaps.depth_edge(_t(depth), mask=None if mask is None else _t(mask), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_view_plane_uv_and_nearest_resize_match(rng):
    np.testing.assert_allclose(
        tmaps.normalized_view_plane_uv(406, 308).numpy(),
        np.asarray(jmaps.normalized_view_plane_uv(406, 308)),
        atol=1e-6,
    )
    x = rng.standard_normal((2, 308, 406, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tmaps.nearest_resize(_t(x), (64, 64)).numpy(),
        np.asarray(jmaps.nearest_resize(jnp.asarray(x), (64, 64))),
    )


def test_svd_orthogonalize_matches(rng):
    """torch.linalg.svd may order or sign its vectors differently; the
    projection onto SO(3) must not depend on that."""
    m = rng.standard_normal((64, 9)).astype(np.float32)
    m[0] = np.eye(3).ravel()  # already a rotation
    m[1] = np.diag([1.0, 1.0, -1.0]).ravel()  # reflection: the det fix must act
    want = np.asarray(jtf.svd_orthogonalize(jnp.asarray(m)))
    got = ttf.svd_orthogonalize(_t(m)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


def test_se3_inverse_and_homogenize_match(rng):
    R = np.asarray(jtf.svd_orthogonalize(jnp.asarray(rng.standard_normal((5, 9)).astype(np.float32))))
    T = np.zeros((5, 4, 4), np.float32)
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.standard_normal((5, 3))
    T[:, 3, 3] = 1
    np.testing.assert_allclose(
        ttf.se3_inverse(_t(T)).numpy(), np.asarray(jtf.se3_inverse(jnp.asarray(T))), atol=1e-6
    )
    p = rng.standard_normal((4, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttf.homogenize_points(_t(p)).numpy(), np.asarray(jtf.homogenize_points(jnp.asarray(p)))
    )


def _pinhole_pointmap(rng, n, h, w, focal, shift, noise):
    uv = np.asarray(jmaps.normalized_view_plane_uv(w, h))
    z = (2 + rng.random((n, h, w))).astype(np.float32)
    xy = uv[None] * (z[..., None] + shift) / focal
    pts = np.concatenate([xy, z[..., None]], axis=-1).astype(np.float32)
    return pts + noise * rng.standard_normal(pts.shape).astype(np.float32)


@pytest.mark.parametrize("noise", [0.0, 0.01, 0.03])
def test_recover_focal_shift_matches(rng, noise):
    """Damped GN on well-posed pinhole pointmaps (with noise and a mask)."""
    pts = _pinhole_pointmap(rng, 4, 56, 84, focal=1.3, shift=0.4, noise=noise)
    mask = rng.random(pts.shape[:-1]) > 0.3
    fj, sj = jfocal.recover_focal_shift(jnp.asarray(pts), jnp.asarray(mask))
    ft, st = tfocal.recover_focal_shift(_t(pts), _t(mask))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    if noise == 0.0:
        np.testing.assert_allclose(ft.numpy(), 1.3, rtol=1e-5)


def test_estimate_camera_parameters_matches(rng):
    pts = _pinhole_pointmap(rng, 3, 56, 84, focal=0.9, shift=-0.2, noise=0.01)
    conf = rng.standard_normal(pts.shape[:-1] + (1,)).astype(np.float32) + 2
    conf[1] = -10.0  # all masked out: degenerate frame -> focal 1, shift 0
    want = jfocal.estimate_camera_parameters(jnp.asarray(pts), jnp.asarray(conf))
    got = tfocal.estimate_camera_parameters(_t(pts), _t(conf))
    for key in ("intrinsics", "focal", "shift", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert got["focal"][1] == 1.0 and got["shift"][1] == 0.0


@pytest.mark.parametrize("hw,max_kp", [((308, 406), 400), ((28, 56), 20), ((308, 406), 10_000)])
def test_grid_keypoints_match(hw, max_kp):
    np.testing.assert_array_equal(tkp.grid_keypoints(*hw, max_kp), jkp.grid_keypoints(*hw, max_kp))


@pytest.mark.parametrize("compression", ["default", "fast", "none"])
def test_save_npz_matches(tmp_path, rng, compression):
    arrays = {"a": rng.standard_normal((4, 3)).astype(np.float16), "b": np.arange(5)}
    save_npz(os.path.join(tmp_path, "t.npz"), compression, **arrays)
    jax_save_npz(os.path.join(tmp_path, "j.npz"), compression, **arrays)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert t.files == j.files
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
