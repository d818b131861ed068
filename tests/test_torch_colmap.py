"""The port's COLMAP export, quaternion functions and projection helpers
(``pi3_slam_tpu_torch/io/colmap.py``, ``geometry/transforms.py``,
``geometry/projection.py``) against the JAX package's, on the CPU.

The same numpy inputs go through both. ``write_colmap_text`` writes the same
bytes (the quaternions' float32 bits are equal, the rest is the same numpy
arithmetic); ``rotation_matrix_to_quaternion`` gives the same float32 bits
at random rotations and on each of Shepperd's four branches, the trace ~ -1
rotations included; the projection helpers agree with JAX's float32 to
relative 1e-5, and the port's float64 unproject-project round trip returns
the pixel grid within 1e-9 px.
"""

import dataclasses
import os
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

from test_colmap_export import _make_recon, _parse_model  # noqa: E402
from test_projection import make_pose  # noqa: E402

from pi3_slam_tpu.geometry import projection as jproj  # noqa: E402
from pi3_slam_tpu.geometry import transforms as jtf  # noqa: E402
from pi3_slam_tpu.io import write_colmap_text as jax_write_colmap  # noqa: E402
from pi3_slam_tpu.sfm.reconstruction import ChunkReconstruction as JRecon  # noqa: E402

from pi3_slam_tpu_torch.geometry import projection as tproj  # noqa: E402
from pi3_slam_tpu_torch.geometry import transforms as ttf  # noqa: E402
from pi3_slam_tpu_torch.io import write_colmap_text  # noqa: E402
from pi3_slam_tpu_torch.sfm.reconstruction import ChunkReconstruction  # noqa: E402


def to_port(r) -> ChunkReconstruction:
    """A JAX ChunkReconstruction as the port's (the same fields)."""
    return ChunkReconstruction(**{f.name: getattr(r, f.name)
                                  for f in dataclasses.fields(ChunkReconstruction)})


def to_jax(r) -> JRecon:
    return JRecon(**{f.name: getattr(r, f.name) for f in dataclasses.fields(JRecon)})


def _same_files(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"cameras", "images", "points3D"}
    for key in want:
        with open(got[key], "rb") as a, open(want[key], "rb") as b:
            assert a.read() == b.read(), key


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_write_colmap_text_is_byte_identical(tmp_path, rng, dtype):
    """Two chunks sharing a frame (deduplicated by name, first occurrence
    wins), a dead track, float64 and float32 poses."""
    ra = _make_recon(rng, ["f0.png", "f1.png", "f2.png"], rng.normal(size=(12, 3)))
    rb = _make_recon(rng, ["f2.png", "f3.png"], rng.normal(size=(9, 3)))
    rb.track_valid[3] = 0.0
    for r in (ra, rb):
        r.rotations, r.centers = r.rotations.astype(dtype), r.centers.astype(dtype)
    want = jax_write_colmap([ra, rb], str(tmp_path / "jax"))
    got = write_colmap_text([to_port(ra), to_port(rb)], str(tmp_path / "port"))
    _same_files(got, want)
    _, images, _, points3d = _parse_model(tmp_path / "port")
    assert sorted(v["name"] for v in images.values()) == ["f0.png", "f1.png", "f2.png", "f3.png"]
    assert len(points3d) == 20


def test_reconstructor_save_colmap_matches_the_jax_writer(tmp_path, rng):
    """--save-colmap through the port's reconstructor CLI: the model it
    writes is the JAX writer's on the port's own reconstructions."""
    from test_system_ape import write_synthetic_chunks

    from pi3_slam_tpu_torch import reconstruct_offline as cli

    write_synthetic_chunks(tmp_path, rng, n_frames=10, n_landmarks=200,
                           chunk_length=4, overlap=2, n_kp=30)
    out = tmp_path / "out"
    res = cli.reconstruct(["--chunks", str(tmp_path / "chunks"), "--output", str(out),
                           "--device", "cpu", "--ba-iterations", "2", "--save-colmap"])
    assert res["artifacts"]["colmap"] == str(out / "colmap" / "images.txt")
    want = jax_write_colmap([to_jax(r) for r in res["reconstructions"]], str(tmp_path / "jax"))
    _same_files({k: str(out / "colmap" / f"{k}.txt") for k in want}, want)
    _, images, _, points3d = _parse_model(out / "colmap")
    assert len(images) == 10
    assert len(points3d) == sum(int(r.track_valid.sum()) for r in res["reconstructions"])


def _shepperd_cases():
    """Rotations on each branch: trace > 0, then R00, R11, R22 dominant, the
    last three also at trace ~ -1 (rotations by ~pi)."""
    out = [np.eye(3)]
    for axis in np.eye(3):
        for angle in (np.pi, np.pi - 1e-4, np.pi - 1e-6, 2.5):
            out.append(Rotation.from_rotvec(axis * angle).as_matrix())
        tilt = Rotation.from_rotvec(axis * np.pi) * Rotation.from_rotvec([1e-3, -2e-3, 3e-3])
        out.append(tilt.as_matrix())
    u = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    out += [Rotation.from_rotvec(u * np.pi).as_matrix(),
            Rotation.from_rotvec(u * (np.pi - 1e-5)).as_matrix()]
    return np.stack(out)


@pytest.mark.parametrize("case", ["random", "shepperd"])
def test_rotation_matrix_to_quaternion_same_bits(case):
    R = (Rotation.random(5000, random_state=3).as_matrix() if case == "random"
         else _shepperd_cases()).astype(np.float32)
    want = np.asarray(jtf.rotation_matrix_to_quaternion(jnp.asarray(R)))
    got = ttf.rotation_matrix_to_quaternion(torch.from_numpy(R)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "shepperd":
        tr = np.trace(R, axis1=1, axis2=2)
        assert (tr < -0.99).sum() >= 6 and (tr > 0).any()
    # the port's round trip, and its inverse against JAX's
    back = ttf.quaternion_to_rotation_matrix(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, R, atol=2e-6)
    jback = np.asarray(jtf.quaternion_to_rotation_matrix(jnp.asarray(got)))
    np.testing.assert_allclose(back, jback, atol=1e-6)


def test_quaternion_to_rotation_matrix_unnormalised(rng):
    q = rng.normal(size=(64, 4)) * 3.0
    want = np.asarray(jtf.quaternion_to_rotation_matrix(jnp.asarray(q, jnp.float32)))
    got = ttf.quaternion_to_rotation_matrix(torch.tensor(q, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def _jt(x, dtype=np.float32):
    return jnp.asarray(np.asarray(x, dtype)), torch.tensor(np.asarray(x, dtype))


def test_geotrf_matches_jax(rng):
    """4x4 and 3x3 transforms of 3D points, a projective 3x3 of 2D points,
    batched."""
    T = np.stack([make_pose(rng) for _ in range(2)])
    P = rng.normal(size=(2, 3, 3)) + 3 * np.eye(3)
    pts3, pts2 = rng.normal(size=(2, 50, 3)), rng.normal(size=(2, 50, 2))
    for Tm, pts in ((T, pts3), (T[:, :3, :3], pts3), (P, pts2), (T[:, :3, :], pts3)):
        (jT, tT), (jp, tp) = _jt(Tm), _jt(pts)
        np.testing.assert_allclose(tproj.geotrf(tT, tp).numpy(), np.asarray(jproj.geotrf(jT, jp)),
                                   rtol=1e-5, atol=1e-5)


def test_depthmaps_and_projection_match_jax(rng):
    K = np.stack([np.array([[100.0, 0, 32], [0, 90.0, 24], [0, 0, 1]])] * 2)
    depth = rng.uniform(1, 5, size=(2, 48, 64))
    c2w = np.stack([make_pose(rng) for _ in range(2)])
    (jd, td), (jK, tK), (jc, tc) = _jt(depth, np.float64), _jt(K, np.float64), _jt(c2w, np.float64)
    np.testing.assert_array_equal(tproj.pixel_grid(48, 64).numpy(),
                                  np.asarray(jproj.pixel_grid(48, 64)))
    got = tproj.depthmap_to_camera_points(td, tK).numpy()
    np.testing.assert_allclose(got, np.asarray(jproj.depthmap_to_camera_points(jd, jK)),
                               rtol=1e-6)
    # float64 on the port's side (JAX computes float32): the world points
    # within float32 rounding of JAX's
    world = tproj.depthmap_to_world_points(td, tK, tc)
    jworld = np.asarray(jproj.depthmap_to_world_points(jd, jK, jc))
    np.testing.assert_allclose(world.numpy(), jworld, rtol=1e-5, atol=1e-5)
    w2c = np.linalg.inv(c2w)
    uv, z = tproj.project_points(world.reshape(2, -1, 3), tK, torch.tensor(w2c))
    juv, jz = jproj.project_points(jnp.asarray(np.asarray(world).reshape(2, -1, 3)), jK,
                                   jnp.asarray(w2c))
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5)
    # the round trip in float64 on the port's side
    grid = tproj.pixel_grid(48, 64, torch.float64).reshape(-1, 2)
    np.testing.assert_allclose(uv.numpy(), np.broadcast_to(grid.numpy(), uv.shape), atol=1e-9)


def test_warp_keypoints_and_plucker_match_jax(rng):
    K_src = np.array([[120.0, 0, 30], [0, 110.0, 20], [0, 0, 1]])
    K_dst = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    kp, d = rng.uniform(0, 60, (40, 2)), rng.uniform(1, 6, 40)
    T = make_pose(rng)
    T[:3, 3] *= 0.2
    args = [_jt(x) for x in (kp, d, K_src, K_dst, T)]
    guv, gok = tproj.warp_keypoints(*(t for _, t in args))
    wuv, wok = jproj.warp_keypoints(*(j for j, _ in args))
    np.testing.assert_allclose(guv.numpy(), np.asarray(wuv), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    (jK, tK), (jT, tT) = _jt(K_dst), _jt(make_pose(rng))
    got = tproj.camera_rays_plucker(tK, tT, 12, 16).numpy()
    np.testing.assert_allclose(got, np.asarray(jproj.camera_rays_plucker(jK, jT, 12, 16)),
                               rtol=1e-5, atol=1e-5)
    assert got.shape == (12, 16, 6)
