"""The port's mesh export end to end against the JAX package's, on the CPU:
``--save-dense`` chunks -> reconstruct -> TSDF mesh, and the online class's
``export_mesh`` and live-mesh refresh.

Scenes are ``tests/test_mesh_pipeline.py``'s: two overlapping chunks of a
camera orbit around a unit sphere, each in its own corrupted Sim3 gauge, with
dense maps. Tolerances:

* the reconstructor CLIs: the two packages' fp32 BA and alignment part the
  poses by ~1e-5 of the scene (``tests/test_torch_reconstructor.py``), which
  moves a voxel's projection and, for a few voxels at the truncation band, its
  observation; the grids are held equal, the weights on all but 1e-3 of the
  voxels, and the meshes to a chamfer distance under 1e-2 of a voxel;
* ``fuse_chunks`` and ``export_mesh`` with the same poses in both packages:
  the same inputs as ``tests/test_torch_mapping.py``, so the weights and faces
  exactly, tsdf, colours and vertices within 1e-5.
"""

import glob
import os
import shutil
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import reconstruct_offline as jax_cli  # noqa: E402
from test_mesh_pipeline import _look_at_origin, write_sphere_chunks  # noqa: E402
from test_pi3_model import TINY, make_tiny_params  # noqa: E402
from test_system_ape import write_synthetic_chunks  # noqa: E402

from pi3_slam_tpu.mapping import TSDFVolume as JaxVolume  # noqa: E402
from pi3_slam_tpu.mapping import fuse as jfuse  # noqa: E402
from pi3_slam_tpu.models.convert import save_pi3_checkpoint  # noqa: E402
from pi3_slam_tpu.slam import OfflineReconstructor as JaxReconstructor  # noqa: E402
from pi3_slam_tpu.slam import ReconstructorConfig as JaxConfig  # noqa: E402

from pi3_slam_tpu_torch import pi3_slam_online as online_cli  # noqa: E402
from pi3_slam_tpu_torch import reconstruct_offline as cli  # noqa: E402
from pi3_slam_tpu_torch.io.mesh import read_mesh_ply  # noqa: E402
from pi3_slam_tpu_torch.mapping import TSDFVolume  # noqa: E402
from pi3_slam_tpu_torch.mapping import fuse as tfuse  # noqa: E402
from pi3_slam_tpu_torch.models.pi3 import Pi3Config  # noqa: E402
from pi3_slam_tpu_torch.slam.config import OnlineConfig  # noqa: E402
from pi3_slam_tpu_torch.slam.online import Pi3SLAMOnline  # noqa: E402
from pi3_slam_tpu_torch.utils.mesh_eval import surface_metrics  # noqa: E402

TOL = 1e-5


def _aligned_recons(files, scale=1.0):
    """The TRUE (uncorrupted) global poses of write_sphere_chunks' chunks,
    centers scaled by ``scale``, with too few tracks (3) to bound the volume:
    the bounds come from the strided back-projection."""
    recons = []
    for i, p in enumerate(files):
        with np.load(p) as z:
            n = z["camera_poses"].shape[0]
        rots, cens = [], []
        for j in range(n):
            ang = 2 * np.pi * (i * 4 + j) / 10  # windows of 6 with overlap 2
            c = 3.0 * np.array([np.cos(ang), np.sin(ang), 0.3])
            rots.append(_look_at_origin(c))
            cens.append(scale * c)
        recons.append(SimpleNamespace(
            rotations=np.stack(rots).astype(np.float32), centers=np.stack(cens).astype(np.float32),
            points=np.zeros((3, 3), np.float32), track_valid=np.ones(3, np.float32),
            num_tracks=3))
    return recons


def _load(p):
    with np.load(p) as z:
        return dict(z)


def _same_volume(got, want):
    assert got.shape == want.shape and got.voxel_size == want.voxel_size
    np.testing.assert_array_equal(got.origin, want.origin)
    np.testing.assert_array_equal(got.weight, want.weight)
    np.testing.assert_allclose(got.tsdf, want.tsdf, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.color, want.color, atol=TOL, rtol=0)


def _same_mesh(a, b):
    np.testing.assert_array_equal(a["faces"], b["faces"])
    np.testing.assert_allclose(a["vertices"], b["vertices"], atol=TOL, rtol=0)
    np.testing.assert_array_equal(a["rgb"], b["rgb"])


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    root = tmp_path_factory.mktemp("sphere")
    gauge = write_sphere_chunks(root, np.random.default_rng(0))
    return root, gauge, sorted(glob.glob(str(root / "chunks" / "*.npz")))


# ----- offline -----


def test_reconstructor_cli_exports_the_jax_clis_mesh(sphere, tmp_path):
    """--export-mesh --save-volume --render-previews 2 through both CLIs on
    the same dense chunks: the same artifacts, grids and surfaces."""
    root, (g_s, _, g_t), _ = sphere
    flags = ["--chunks", str(root), "--ba-iterations", "4", "--export-mesh", "--save-volume",
             "--render-previews", "2", "--mesh-voxel-size", str(0.06 * g_s)]
    assert jax_cli.main(flags + ["--output", str(tmp_path / "jax")]) == 0
    got = cli.reconstruct(flags + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    assert got["artifacts"]["mesh"] == str(tmp_path / "port" / "fused_mesh.ply")
    for name in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / name / "mesh_previews")) == [
            "depth_000.png", "depth_001.png", "normal_000.png", "normal_001.png"]
    d0 = np.asarray(Image.open(tmp_path / "port" / "mesh_previews" / "depth_000.png"))
    assert d0.shape == (240, 320) and d0.max() > 0

    vol = TSDFVolume.load(str(tmp_path / "port" / "fused_volume.npz"))
    want = JaxVolume.load(str(tmp_path / "jax" / "fused_volume.npz"))
    assert vol.shape == want.shape and vol.voxel_size == want.voxel_size
    np.testing.assert_allclose(vol.origin, want.origin, atol=1e-3 * vol.voxel_size)
    assert (vol.weight != want.weight).mean() < 1e-3

    mesh = read_mesh_ply(got["artifacts"]["mesh"])
    jmesh = read_mesh_ply(str(tmp_path / "jax" / "fused_mesh.ply"))
    m = surface_metrics(mesh["vertices"], jmesh["vertices"], 0.1 * vol.voxel_size)
    assert m.chamfer < 1e-2 * vol.voxel_size and m.fscore > 0.99, m
    # the sphere in the aligned frame (chunk 0's gauge): center g_t, radius g_s
    r = np.linalg.norm(mesh["vertices"] - g_t, axis=1) / g_s
    assert abs(np.median(r) - 1.0) < 0.12
    assert mesh["normals"] is not None and abs(np.median(mesh["rgb"]) - 200) < 30


def test_reconstructor_skips_the_mesh_of_chunks_without_dense_maps(tmp_path, rng, capsys):
    write_synthetic_chunks(tmp_path, rng, n_frames=8, chunk_length=5, overlap=2)
    files = sorted(glob.glob(str(tmp_path / "chunks" / "*.npz")))
    JaxReconstructor(JaxConfig(chunk_dir=str(tmp_path), output_dir=str(tmp_path / "jax"),
                               export_mesh=True))._export_mesh(None, files)
    want = capsys.readouterr().out.splitlines()[-1]
    out = cli.reconstruct(["--chunks", str(tmp_path), "--output", str(tmp_path / "port"),
                           "--ba-iterations", "2", "--export-mesh", "--device", "cpu"])
    assert "mesh" not in out["artifacts"]
    assert want.startswith("mesh export skipped") and "save-dense" in want
    assert want in capsys.readouterr().out.splitlines()


def test_fuse_chunks_lazy_loading_and_aligned_bounds_fallback_match_jax(sphere):
    """Zero-arg loaders and, with too few sparse tracks, bounds from every
    chunk's depth back-projected under its ALIGNED pose and residual scale
    (the aligned poses are the true ones scaled 2x)."""
    _, _, files = sphere
    recons = _aligned_recons(files, scale=2.0)
    loads = []

    def loader(p):
        def load():
            loads.append(p)
            return _load(p)
        return load

    got = tfuse.fuse_chunks([loader(p) for p in files], recons, overlap=2, voxel_size=0.12,
                            device="cpu")
    assert len(loads) == 2 * len(files)  # the bounds probe, then the fusion
    want = jfuse.fuse_chunks([loader(p) for p in files], recons, overlap=2, voxel_size=0.12)
    _same_volume(got, want)
    verts = got.extract_mesh()[0]
    r = np.linalg.norm(verts, axis=1) / 2.0
    assert len(verts) > 100 and abs(np.median(r) - 1.0) < 0.12
    for sx in (-1, 1):  # every quadrant meshed: the bounds cover the sphere
        for sy in (-1, 1):
            assert ((np.sign(verts[:, 0]) == sx) & (np.sign(verts[:, 1]) == sy)).any()
    with pytest.raises(ValueError, match="chunks vs"):
        tfuse.fuse_chunks(files[:1], recons, device="cpu")


def test_export_fused_mesh_skips_degenerate_geometry_as_jax(sphere, tmp_path, capsys):
    _, _, files = sphere
    chunks = []
    for p in files:
        c = _load(p)
        c["conf_dense"] = np.full_like(c["conf_dense"], -9.0)  # nothing confident
        chunks.append(c)
    recons = _aligned_recons(files)
    assert jfuse.export_fused_mesh(chunks, recons, str(tmp_path / "j.ply")) is None
    want = capsys.readouterr().out
    assert tfuse.export_fused_mesh(chunks, recons, str(tmp_path / "p.ply"), device="cpu") is None
    assert capsys.readouterr().out == want and want.startswith("mesh export skipped")


# ----- online -----


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_pi3_checkpoint(path, make_tiny_params(), TINY)
    return path


def _online(tmp_path, ckpt, **kw):
    cfg = OnlineConfig(chunk_length=4, overlap=2, pixel_limit=4000, use_metric_depth=False,
                       max_keypoints=20, compute_dtype="float32", checkpoint_path=ckpt,
                       output_dir=str(tmp_path / "online"), device="cpu", **kw)
    return Pi3SLAMOnline(cfg, pi3_config=Pi3Config.from_json(TINY.to_json()))


def _stash(sphere, tmp_path):
    """write_sphere_chunks' chunks as the online class's dense stashes, with
    their aligned reconstructions."""
    _, _, files = sphere
    ddir = tmp_path / "online" / "dense"
    os.makedirs(ddir)
    for i, p in enumerate(files):
        shutil.copy(p, ddir / f"dense_{i:06d}.npz")
    return sorted(str(p) for p in ddir.iterdir()), _aligned_recons(files)


def test_online_export_mesh_matches_jax(sphere, tmp_path, ckpt, capsys):
    """export_mesh fuses the stashes under the reconstructions' FINAL poses
    (stashes in corrupted per-chunk gauges, aligned recons): the JAX
    export_fused_mesh on the same stashes and recons gives the same mesh."""
    slam = _online(tmp_path, ckpt, export_mesh=True, save_volume=True, mesh_voxel_size=0.06)
    assert slam.export_mesh() is None
    assert "no stashed dense maps" in capsys.readouterr().out
    stashes, recons = _stash(sphere, tmp_path)
    slam.reconstructions = recons[:1]
    assert slam.export_mesh() is None
    assert "3 dense chunks vs 1 reconstructions" in capsys.readouterr().out
    slam.reconstructions = recons
    path = slam.export_mesh()
    assert path == str(tmp_path / "online" / "fused_mesh.ply")
    assert os.path.exists(tmp_path / "online" / "fused_volume.npz")
    want = jfuse.export_fused_mesh(
        [lambda p=p: _load(p) for p in stashes], recons, str(tmp_path / "jax.ply"),
        config=jfuse.TSDFConfig(voxel_size=0.06), overlap=2)
    _same_mesh(read_mesh_ply(path), read_mesh_ply(str(tmp_path / "jax.ply")))
    r = np.linalg.norm(read_mesh_ply(path)["vertices"], axis=1)
    assert abs(np.median(r) - 1.0) < 0.12


def test_online_live_mesh_refresh_matches_jax(sphere, tmp_path, ckpt, capsys):
    """_live_mesh_tick re-fuses the stashes under the CURRENT poses on a
    host-CPU daemon thread (128^3 voxels at most) and prints the surface's
    size: the vertex count of the JAX fuse_chunks at the same settings."""
    slam = _online(tmp_path, ckpt, live_mesh_every=2, mesh_voxel_size=0.06)
    stashes, recons = _stash(sphere, tmp_path)
    slam.reconstructions = recons
    slam._live_mesh_tick()
    thread = slam._live_mesh_thread
    assert thread is not None and thread.daemon and thread.name == "live-mesh"
    slam._live_mesh_tick()  # dropped while the refresh runs, or a fresh one
    slam._live_mesh_thread.join(timeout=60)
    thread.join(timeout=60)
    assert not thread.is_alive() and not slam._live_mesh_thread.is_alive()
    want = jfuse.fuse_chunks([lambda p=p: _load(p) for p in stashes], recons,
                             config=jfuse.TSDFConfig(voxel_size=0.06, max_voxels=128**3),
                             overlap=2)
    n = len(want.extract_mesh()[0])
    lines = capsys.readouterr().out.splitlines()
    assert n > 100 and f"live mesh: {n} verts from 3 chunks" in lines, lines

    # degenerate geometry (no confident depth): the JAX fuse_chunks' reason
    for p in stashes:
        z = _load(p)
        z["conf_dense"] = np.full_like(z["conf_dense"], -9.0)
        np.savez(p, **z)
    with pytest.raises(ValueError) as e:
        jfuse.fuse_chunks([lambda p=p: _load(p) for p in stashes], recons, overlap=2)
    slam._live_mesh_tick()
    slam._live_mesh_thread.join(timeout=60)
    assert capsys.readouterr().out.splitlines() == [f"live mesh skipped: {e.value}"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """tests/test_pipeline.py's 8 frames: one random image moving right."""
    d = tmp_path_factory.mktemp("frames")
    base = np.random.default_rng(5).integers(30, 220, (64, 84, 3)).astype(np.uint8)
    for i in range(8):
        Image.fromarray(np.roll(base, shift=3 * i, axis=1)).save(d / f"frame_{i:04d}.png")
    return str(d)


@pytest.mark.parametrize("flags", [["--export-mesh", "--save-volume", "--live-mesh-every", "1"],
                                   ["--live-mesh-every", "2"]])
def test_online_cli_runs_the_mesh_flags(frames, ckpt, tmp_path, capsys, flags):
    """The online CLI with the mesh flags on the CPU: each chunk stashes its
    dense maps (--live-mesh-every alone too), the live refresh prints, and
    --export-mesh writes the mesh and volume after the run (random weights:
    the mesh or the JAX skip line)."""
    out = tmp_path / "out"
    result = online_cli.run_online(
        ["--images", frames, "--output", str(out), "--model-path", ckpt, "--chunk-length", "4",
         "--overlap", "2", "--max-kp", "20", "--pixel-limit", "4000", "--no-metric-depth",
         "--compute-dtype", "float32", "--device", "cpu", "--mesh-voxel-size", "0.05"] + flags)
    for t in threading.enumerate():
        if t.name == "live-mesh":
            t.join(timeout=60)
    text = capsys.readouterr().out
    # 8 frames in chunks of 4 with overlap 2: 3 chunks and a padded 2-frame tail
    assert len(glob.glob(str(out / "dense" / "dense_*.npz"))) == result["num_chunks"] == 4
    ticks = [line for line in text.splitlines() if line.startswith("live mesh")]
    assert ticks and all(line.startswith(("live mesh: ", "live mesh skipped: "))
                         for line in ticks), ticks
    if "--export-mesh" in flags:
        if "mesh" in result["artifacts"]:
            mesh = read_mesh_ply(result["artifacts"]["mesh"])
            assert np.isfinite(mesh["vertices"]).all()
            assert TSDFVolume.load(str(out / "fused_volume.npz")).shape
        else:
            assert "mesh export skipped" in text
    else:
        assert "mesh" not in result["artifacts"] and not (out / "fused_mesh.ply").exists()
