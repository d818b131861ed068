"""The port's dense mapping (``pi3_slam_tpu_torch.mapping``, ``io/mesh.py``,
``utils/mesh_eval.py`` and the ``render_tsdf`` / ``eval_mesh`` tools) against
the JAX package's, on the CPU, the same numpy inputs through both.

Scenes are ``tests/test_mapping.py``'s analytic sphere (depth by exact
ray-sphere intersection). Tolerances:

* the mesh PLY bytes, ``surface_nets`` and ``sdf_vertex_normals``: host numpy
  in both packages, held bit for bit;
* ``fuse_tsdf``: the port sums the pixel index's inputs as XLA does on the host
  (FMA chains), so both pick the same pixel for every voxel and the weights
  agree exactly; tsdf and colour within 1e-5 (XLA contracts the running
  average's products into FMAs, the port rounds each: 1-2 ulp);
* ``fuse_tsdf(mesh=)``: bit for bit the port's single-device fusion (each
  voxel's update reads only its own row), and the JAX sharded fusion as above;
* ``raycast_depth``: 192 steps of trilinear samples from volumes 1e-7 apart:
  the hit masks on 99.9% of the rays and depth within 1e-4 on the rays both
  hit;
* the volume npz: each package's file loads in the other, array for array.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image


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
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))

import eval_mesh as jax_eval_mesh  # noqa: E402
import render_tsdf as jax_render_tsdf  # noqa: E402
from test_mapping import SPHERE_COLOR, _look_at_origin, _sphere_views  # noqa: E402

from pi3_slam_tpu import mapping as jmap  # noqa: E402
from pi3_slam_tpu.io import mesh as jmesh  # noqa: E402
from pi3_slam_tpu.mapping import tsdf as jtsdf  # noqa: E402
from pi3_slam_tpu.utils import mesh_eval as jeval  # noqa: E402

from pi3_slam_tpu_torch import mapping as tmap  # noqa: E402
from pi3_slam_tpu_torch.io import mesh as tmesh  # noqa: E402
from pi3_slam_tpu_torch.mapping import tsdf as ttsdf  # noqa: E402
from pi3_slam_tpu_torch.tools import eval_mesh, render_tsdf  # noqa: E402
from pi3_slam_tpu_torch.utils import mesh_eval as teval  # noqa: E402

FUSE_TOL = 1e-5


def _sphere_sdf(n=33, lim=1.6):
    g = np.linspace(-lim, lim, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return np.sqrt(X**2 + Y**2 + Z**2) - 1.0, np.array([-lim] * 3), g[1] - g[0], X


def _same_volume(got, want, tol=FUSE_TOL):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.origin, want.origin)
    assert got.voxel_size == want.voxel_size and got.trunc_dist == want.trunc_dist
    np.testing.assert_array_equal(got.weight, want.weight)
    np.testing.assert_allclose(got.tsdf, want.tsdf, atol=tol, rtol=0)
    np.testing.assert_allclose(got.color, want.color, atol=tol, rtol=0)


def _colors_conf(depths, seed=0):
    rng = np.random.default_rng(seed)
    colors = np.ones(depths.shape + (3,)) * SPHERE_COLOR + rng.uniform(-0.1, 0.1, depths.shape
                                                                     + (3,))
    return colors, rng.uniform(0.0, 1.0, depths.shape)  # a quarter below the 0.25 gate


# ----- io/mesh.py -----


@pytest.mark.parametrize("colors,normals", [(False, False), (True, False), (False, True),
                                            (True, True)])
def test_mesh_ply_bytes_match_jax_and_each_reader_reads_the_other(tmp_path, colors, normals):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(40, 3))
    faces = rng.integers(0, 40, size=(70, 3))
    kw = {}
    if colors:
        kw["colors"] = rng.uniform(size=(40, 3))
    if normals:
        n = rng.normal(size=(40, 3))
        kw["normals"] = n / np.linalg.norm(n, axis=1, keepdims=True)
    a, b = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    tmesh.write_mesh_ply(verts, faces, a, **kw)
    jmesh.write_mesh_ply(verts, faces, b, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for got, want in ((tmesh.read_mesh_ply(b), jmesh.read_mesh_ply(a)),
                      (tmesh.read_mesh_ply(a), jmesh.read_mesh_ply(b))):
        for key in ("vertices", "faces", "rgb", "normals"):
            if want[key] is None:
                assert got[key] is None
            else:
                np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError):
        tmesh.write_mesh_ply(verts, np.array([[0, 1, 40]]), a)


# ----- surface nets -----


@pytest.mark.parametrize("case", ["sphere", "observed_half", "colors"])
def test_surface_nets_bit_equal(case):
    sdf, origin, vs, X = _sphere_sdf()
    kw = dict(origin=origin, voxel_size=vs)
    if case == "observed_half":
        kw["observed"] = X <= 0
    if case == "colors":
        kw["colors"] = np.random.default_rng(2).uniform(size=sdf.shape + (3,))
    got = tmap.surface_nets(sdf, **kw)
    want = jmap.surface_nets(sdf, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if want[2] is None:
        assert got[2] is None
    else:
        np.testing.assert_array_equal(got[2], want[2])
    assert len(got[1]) > 100


def test_sdf_vertex_normals_bit_equal():
    sdf, origin, vs, _ = _sphere_sdf()
    verts = jmap.surface_nets(sdf, origin=origin, voxel_size=vs)[0]
    np.testing.assert_array_equal(
        tmap.sdf_vertex_normals(sdf, verts, origin=origin, voxel_size=vs),
        jmap.sdf_vertex_normals(sdf, verts, origin=origin, voxel_size=vs))


def test_surface_nets_refuses_a_flat_grid_as_jax_does():
    with pytest.raises(ValueError, match="sdf must be"):
        tmap.surface_nets(np.zeros((1, 4, 4)))
    with pytest.raises(ValueError, match="sdf must be"):
        jmap.surface_nets(np.zeros((1, 4, 4)))


# ----- TSDF fusion -----


def test_fuse_tsdf_one_shot_with_colors_and_confidence_matches_jax():
    depths, intrs, rots, cens = _sphere_views()
    colors, conf = _colors_conf(depths)
    cfg = dict(voxel_size=0.05)
    got = tmap.fuse_tsdf(depths, intrs, rots, cens, colors=colors, conf=conf,
                         config=tmap.TSDFConfig(**cfg), device="cpu")
    want = jmap.fuse_tsdf(depths, intrs, rots, cens, colors=colors, conf=conf,
                          config=jmap.TSDFConfig(**cfg))
    _same_volume(got, want)
    assert (want.weight > 0).mean() > 0.05 and (conf < 0.25).mean() > 0.2
    # the same mesh from both volumes
    vg, fg, cg = got.extract_mesh()
    vw, fw, cw = want.extract_mesh()
    assert len(vg) == len(vw) > 200
    np.testing.assert_array_equal(fg, fw)
    np.testing.assert_allclose(vg, vw, atol=1e-4)
    np.testing.assert_allclose(cg, cw, atol=FUSE_TOL)


@pytest.mark.parametrize("resume", ["device_state", "host_arrays"])
def test_fuse_tsdf_incremental_matches_jax(resume):
    """Two calls (volume= continuing the first) against JAX's two calls:
    from the first call's device state, and from its host arrays (read
    first, so the state was pulled and is uploaded again)."""
    depths, intrs, rots, cens = _sphere_views(n_views=8)
    colors, conf = _colors_conf(depths, seed=1)
    bounds = (np.array([-1.5] * 3), np.array([1.5] * 3))
    halves = (slice(0, 4), slice(4, 8))

    def run(m, **dev):
        cfg = m.TSDFConfig(voxel_size=0.08)
        vol = None
        for h in halves:
            vol = m.fuse_tsdf(depths[h], intrs[h], rots[h], cens[h], colors=colors[h],
                              conf=conf[h], config=cfg, bounds=bounds, volume=vol, **dev)
            if dev and resume == "host_arrays":
                vol.tsdf
            if dev and resume == "device_state" and h.start == 0:
                assert vol._state is not None  # not pulled between the calls
        return vol

    got, want = run(tmap, device="cpu"), run(jmap)
    _same_volume(got, want)
    one = tmap.fuse_tsdf(depths, intrs, rots, cens, colors=colors, conf=conf,
                         config=tmap.TSDFConfig(voxel_size=0.08), bounds=bounds, device="cpu")
    np.testing.assert_array_equal(got.tsdf, one.tsdf)  # the same ops in the same order


def test_unobserved_voxels_keep_the_free_space_init_as_in_jax():
    depths, intrs, rots, cens = _sphere_views(n_views=4)
    bounds = (np.array([-8.0] * 3), np.array([8.0] * 3))
    got = tmap.fuse_tsdf(depths, intrs, rots, cens, config=tmap.TSDFConfig(voxel_size=0.25),
                         bounds=bounds, device="cpu")
    want = jmap.fuse_tsdf(depths, intrs, rots, cens, config=jmap.TSDFConfig(voxel_size=0.25),
                          bounds=bounds)
    _same_volume(got, want)
    unobserved = got.weight == 0
    assert unobserved.mean() > 0.5
    np.testing.assert_array_equal(got.tsdf[unobserved], 1.0)


@pytest.mark.parametrize("lo,hi,voxel,cap", [
    ([-1.5, -1.5, -1.5], [1.5, 1.5, 1.5], 0.05, 192**3),
    ([-0.3, 2.0, -7.1], [4.2, 2.0, 1.3], 0.02, 192**3),  # a flat axis and a cap that binds
    ([-1.0, -1.0, -1.0], [1.0, 1.0, 1.0], 0.01, 40**3),
    ([0.0, 0.0, 0.0], [3.0, 1.0, 0.5], 0.013, 64**3),
])
def test_grid_from_bounds_matches_jax(lo, hi, voxel, cap):
    got = ttsdf._grid_from_bounds(lo, hi, ttsdf.TSDFConfig(voxel_size=voxel, max_voxels=cap))
    want = jtsdf._grid_from_bounds(lo, hi, jtsdf.TSDFConfig(voxel_size=voxel, max_voxels=cap))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and np.prod(got[1]) <= cap


@pytest.mark.parametrize("extent", [1e12, 1e13, 1e16])
def test_grid_from_bounds_of_wild_bounds_fits_the_cap(extent):
    """Bounds from degenerate depths: the JAX grid's int64 voxel count wraps
    negative (its fusion then fails); the port's grid fits max_voxels."""
    lo, hi = [0.0, 0.0, 0.0], [extent, extent, 0.7 * extent]
    _, dims, vs = ttsdf._grid_from_bounds(lo, hi, ttsdf.TSDFConfig())
    assert 8 <= np.prod(dims) <= 192**3 and min(dims) >= 2 and vs > 0
    _, jdims, _ = jtsdf._grid_from_bounds(lo, hi, jtsdf.TSDFConfig())
    assert int(np.prod(np.array(jdims, np.int64))) < 0


def test_auto_bounds_and_the_bounds_probe_match_jax():
    depths, intrs, rots, cens = _sphere_views(n_views=6)
    conf = _colors_conf(depths)[1]
    args = [np.asarray(a, np.float32) for a in (depths, conf, intrs, rots, cens)]
    got = ttsdf._backproject_sample(*args, ttsdf.TSDFConfig())
    want = jtsdf._backproject_sample(*args, jtsdf.TSDFConfig())
    np.testing.assert_array_equal(got, want)
    for a, b in zip(ttsdf.auto_bounds(got, 0.1), jtsdf.auto_bounds(want, 0.1)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        ttsdf.auto_bounds(np.full((3, 3), np.nan), 0.1)


def test_voxel_cap_coarsens_as_in_jax():
    depths, intrs, rots, cens = _sphere_views(n_views=4, h=24, w=32)
    got = tmap.fuse_tsdf(depths, intrs, rots, cens,
                         config=tmap.TSDFConfig(voxel_size=0.01, max_voxels=40**3), device="cpu")
    want = jmap.fuse_tsdf(depths, intrs, rots, cens,
                          config=jmap.TSDFConfig(voxel_size=0.01, max_voxels=40**3))
    _same_volume(got, want)
    assert np.prod(got.shape) <= 40**3 and got.voxel_size > 0.01


def test_confidence_below_the_gate_everywhere_raises_as_in_jax():
    depths, intrs, rots, cens = _sphere_views(n_views=3)
    conf = np.full_like(depths, 0.2)
    with pytest.raises(ValueError, match="no valid depth samples"):
        tmap.fuse_tsdf(depths, intrs, rots, cens, conf=conf, device="cpu")
    with pytest.raises(ValueError, match="no valid depth samples"):
        jmap.fuse_tsdf(depths, intrs, rots, cens, conf=conf)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_voxel_sharded_fusion_equals_single_device_and_matches_jax(n_shards):
    """fuse_tsdf(mesh=) over a CPU mesh built through ``devices=``: the flat
    state split over the dp axis (padded where the shards do not divide it:
    4 shards of a grid whose voxel count 4 does not divide), each shard
    gathering its own voxels. Bit for bit the port's single-device fusion,
    fresh and continued (``volume=``); within FUSE_TOL of the JAX package's
    sharded fusion on the same shard count."""
    from pi3_slam_tpu.parallel import make_mesh as jax_make_mesh

    from pi3_slam_tpu_torch.parallel import make_mesh

    depths, intrs, rots, cens = _sphere_views(n_views=4, h=24, w=32)
    cfg = dict(voxel_size=0.1)
    mesh = make_mesh(n_shards, 1, devices=["cpu"] * n_shards)
    one = tmap.fuse_tsdf(depths, intrs, rots, cens, config=tmap.TSDFConfig(**cfg), device="cpu")
    got = tmap.fuse_tsdf(depths, intrs, rots, cens, config=tmap.TSDFConfig(**cfg), mesh=mesh,
                         device="cpu")
    if n_shards == 4:
        assert np.prod(got.shape) % 4
    for name in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(got, name), getattr(one, name), err_msg=name)
    more = _sphere_views(n_views=2, h=24, w=32)
    got2 = tmap.fuse_tsdf(*more, volume=got, mesh=mesh, device="cpu")
    one2 = tmap.fuse_tsdf(*more, volume=one, device="cpu")
    for name in ("tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(got2, name), getattr(one2, name), err_msg=name)
    want = jmap.fuse_tsdf(depths, intrs, rots, cens, config=jmap.TSDFConfig(**cfg),
                          mesh=jax_make_mesh(n_shards, 1), mesh_axis="dp")
    _same_volume(got, want)


def test_cuda_without_a_device_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    depths, intrs, rots, cens = _sphere_views(n_views=2, h=12, w=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmap.fuse_tsdf(depths, intrs, rots, cens)
    vol = tmap.TSDFVolume(np.ones((2, 2, 2)), np.zeros((2, 2, 2)), np.zeros((2, 2, 2, 3)),
                          np.zeros(3), 0.1, 0.4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmap.raycast_depth(vol, [1.0, 1.0, 1.0, 1.0], np.eye(3), np.zeros(3), 2, 2)
    from pi3_slam_tpu_torch.tools import perf_lab

    with pytest.raises(RuntimeError, match="GPU"):
        perf_lab.bench_tsdf()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_volume_saved_by_either_package_loads_in_both(tmp_path, writer):
    depths, intrs, rots, cens = _sphere_views(n_views=8)
    colors = np.ones(depths.shape + (3,)) * SPHERE_COLOR
    vol = (tmap.fuse_tsdf(depths, intrs, rots, cens, colors=colors,
                          config=tmap.TSDFConfig(voxel_size=0.06), device="cpu")
           if writer == "port" else
           jmap.fuse_tsdf(depths, intrs, rots, cens, colors=colors,
                          config=jmap.TSDFConfig(voxel_size=0.06)))
    path = str(tmp_path / "vol.npz")
    vol.save(path)
    got, want = tmap.TSDFVolume.load(path), jmap.TSDFVolume.load(path)
    for key in ("tsdf", "weight", "color", "origin"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert (got.shape, got.voxel_size, got.trunc_dist) == (want.shape, want.voxel_size,
                                                           want.trunc_dist)
    np.testing.assert_allclose(got.tsdf, vol.tsdf, atol=2e-3)  # f16 storage


# ----- raycast -----


@pytest.fixture(scope="module")
def raycast_volumes():
    """The 12-view sphere fused by both packages at 0.04 (tests/test_mapping.py's
    raycast scene)."""
    depths, intrs, rots, cens = _sphere_views(n_views=12)
    bounds = (np.array([-1.5] * 3), np.array([1.5] * 3))
    got = tmap.fuse_tsdf(depths, intrs, rots, cens, config=tmap.TSDFConfig(voxel_size=0.04),
                         bounds=bounds, device="cpu")
    want = jmap.fuse_tsdf(depths, intrs, rots, cens, config=jmap.TSDFConfig(voxel_size=0.04),
                          bounds=bounds)
    return got, want


@pytest.mark.parametrize("angle,elev", [(0.37, 0.21), (2.1, -0.3)])
def test_raycast_matches_jax(raycast_volumes, angle, elev):
    got_vol, want_vol = raycast_volumes
    h, w = 50, 70
    intr = np.array([80.0, 80.0, w / 2, h / 2])
    c = 3.0 * np.array([np.cos(angle), np.sin(angle), elev])
    R = _look_at_origin(c)
    got = tmap.raycast_depth(got_vol, intr, R, c, h, w, device="cpu")
    want = jmap.raycast_depth(want_vol, intr, R, c, h, w)
    assert (got["mask"] == want["mask"]).mean() >= 0.999
    both = got["mask"] & want["mask"]
    assert both.mean() > 0.2
    np.testing.assert_allclose(got["depth"][both], want["depth"][both], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["points"][both], want["points"][both], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["normals"][both], want["normals"][both], atol=1e-3, rtol=0)
    assert (got["depth"][~got["mask"]] == 0).all()
    # the device copy of the tsdf is made once per volume
    assert got_vol.device_tsdf_flat("cpu") is got_vol.device_tsdf_flat("cpu")


# ----- mesh evaluation -----


def test_mesh_eval_matches_jax():
    sdf, origin, vs, _ = _sphere_sdf(n=25)
    verts, faces, _ = jmap.surface_nets(sdf, origin=origin, voxel_size=vs)
    gt = np.random.default_rng(3).normal(size=(3000, 3))
    gt /= np.linalg.norm(gt, axis=1, keepdims=True)
    np.testing.assert_array_equal(teval.sample_mesh_surface(verts, faces, 500, seed=4),
                                  jeval.sample_mesh_surface(verts, faces, 500, seed=4))
    for thr in (None, 0.02):
        got = teval.evaluate_mesh(verts, faces, gt, threshold=thr, n_samples=4000, seed=1)
        want = jeval.evaluate_mesh(verts, faces, gt, threshold=thr, n_samples=4000, seed=1)
        assert got.as_dict() == want.as_dict()
    with pytest.raises(ValueError, match="empty point set"):
        teval.surface_metrics(np.zeros((0, 3)), gt, 0.1)


# ----- the tools -----


@pytest.fixture(scope="module")
def saved_volume(tmp_path_factory):
    depths, intrs, rots, cens = _sphere_views(n_views=8)
    vol = jmap.fuse_tsdf(depths, intrs, rots, cens, config=jmap.TSDFConfig(voxel_size=0.06))
    path = str(tmp_path_factory.mktemp("vol") / "vol.npz")
    vol.save(path)
    return path, cens, rots


def _renders(folder):
    return {f: np.asarray(Image.open(os.path.join(folder, f))) for f in sorted(os.listdir(folder))}


@pytest.mark.parametrize("trajectory", [False, True])
def test_render_tsdf_matches_the_jax_tool(tmp_path, capsys, saved_volume, trajectory):
    path, cens, rots = saved_volume
    argv = ["--volume", path, "--views", "2", "--height", "40", "--width", "50"]
    if trajectory:
        from pi3_slam_tpu_torch.io.tum import write_tum_trajectory

        traj = str(tmp_path / "traj.txt")
        write_tum_trajectory(traj, cens, np.transpose(rots, (0, 2, 1)), integer_timestamps=True)
        argv += ["--trajectory", traj]
    assert jax_render_tsdf.main(argv + ["--output", str(tmp_path / "jax")]) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    assert render_tsdf.main(argv + ["--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    port_lines = capsys.readouterr().out.splitlines()
    assert [line.replace("port", "jax") for line in port_lines] == jax_lines
    got, want = _renders(tmp_path / "port"), _renders(tmp_path / "jax")
    assert sorted(got) == ["depth_000.png", "depth_001.png", "normal_000.png", "normal_001.png"]
    for name in got:
        # 8-bit quantization of values 1e-4 apart: one level at most
        diff = np.abs(got[name].astype(int) - want[name].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name
    assert got["depth_000.png"].max() > 0


def test_eval_mesh_matches_the_jax_tool(tmp_path, capsys):
    sdf, origin, vs, _ = _sphere_sdf(n=21)
    verts, faces, _ = jmap.surface_nets(sdf, origin=origin, voxel_size=vs)
    pred, gt = str(tmp_path / "pred.ply"), str(tmp_path / "gt.ply")
    jmesh.write_mesh_ply(verts, faces, pred)
    jmesh.write_mesh_ply(verts * 1.02, faces, gt)
    argv = ["--mesh", pred, "--gt", gt, "--samples", "3000"]
    assert jax_eval_mesh.main(argv) == 0
    want = capsys.readouterr().out
    assert eval_mesh.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["num_gt"] == 3000
