"""The port's multi-device package (``pi3_slam_tpu_torch/parallel``) and its
callers (the sharded chunk step, the creator's and the online driver's dp
groups) against the JAX package's, on the CPU.

The JAX side runs on conftest's 8 virtual CPU devices; the port lays its
meshes over ``devices=["cpu"] * n`` (a device may repeat in the port's mesh,
as on one card). Both sides run fp32, the JAX side on its XLA path. The
tolerances, each stated where it is used:

* ring attention and ``shard_attention`` (against the JAX ``sharded_sdpa``):
  the JAX tests' atol 3e-5 and 5e-5
  (fp32 attention summed in another order), against the plain reference and
  against the JAX ring;
* ``sharded_block_mlp``: rtol / atol 1e-5, fp32 products in two frameworks
  (the JAX side runs its Pallas kernel in interpret mode);
* the sharded Pi3 step and chunk step: the JAX tests' atol 2e-4 on points and
  poses (2e-2 on the keypoint-sampled points), the port's tp partials summed
  in another order than XLA's;
* chunk files: ``tests/test_torch_chunk_creator.py``'s FLOAT_TOL and its
  intrinsics check (the focal solve is ill-posed on random weights);
* the dp-only paths of the port against its own single-device path: bit for
  bit, since each replica runs the single-device step unchanged.
"""

import glob
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_pi3_model import TINY, make_tiny_params  # noqa: E402
from test_torch_chunk_creator import FLOAT_TOL, _check_intrinsics  # noqa: E402

from pi3_slam_tpu.models.convert import save_pi3_checkpoint  # noqa: E402
from pi3_slam_tpu.ops.attention import sdpa_reference as jax_sdpa_reference  # noqa: E402
from pi3_slam_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from pi3_slam_tpu.parallel import make_sharded_pi3_step as jax_sharded_pi3_step  # noqa: E402
from pi3_slam_tpu.parallel import pi3_input_sharding  # noqa: E402
from pi3_slam_tpu.parallel.context import sharded_block_mlp as jax_sharded_block_mlp  # noqa: E402
from pi3_slam_tpu.parallel.context import sharded_sdpa as jax_sharded_sdpa  # noqa: E402
from pi3_slam_tpu.parallel.context import tp_mesh_context as jax_mesh_context  # noqa: E402
from pi3_slam_tpu.parallel.ring import ring_attention as jax_ring  # noqa: E402
from pi3_slam_tpu.slam import OfflineChunkCreator as JaxCreator  # noqa: E402
from pi3_slam_tpu.slam import OfflineCreatorConfig as JaxCreatorConfig  # noqa: E402
from pi3_slam_tpu.slam import chunk_creator as jax_cc  # noqa: E402
from pi3_slam_tpu.slam import online as jax_online  # noqa: E402

from pi3_slam_tpu_torch.models.convert import build_pi3, pi3_state_from_jax  # noqa: E402
from pi3_slam_tpu_torch.models.pi3 import Pi3Config  # noqa: E402
from pi3_slam_tpu_torch.ops import _build  # noqa: E402
from pi3_slam_tpu_torch.ops.attention import sdpa_reference  # noqa: E402
from pi3_slam_tpu_torch.parallel import make_mesh, make_sharded_pi3_step  # noqa: E402
from pi3_slam_tpu_torch.parallel.context import (  # noqa: E402
    shard_attention,
    sharded_block_mlp,
    tp_mesh_context,
)
from pi3_slam_tpu_torch.parallel.ring import ring_attention  # noqa: E402
from pi3_slam_tpu_torch.slam import chunk_creator as cc  # noqa: E402
from pi3_slam_tpu_torch.slam import online  # noqa: E402
from pi3_slam_tpu_torch.slam.config import OfflineCreatorConfig, OnlineConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU8 = ["cpu"] * 8
PORT_TINY = Pi3Config.from_json(TINY.to_json())


@pytest.fixture(scope="module")
def params():
    return make_tiny_params()


@pytest.fixture(scope="module")
def model(params):
    tree = jax.tree.map(np.asarray, params)
    return build_pi3(PORT_TINY, pi3_state_from_jax(tree), torch.device("cpu"), torch.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----- the mesh -----


def test_make_mesh_axis_names_shapes_and_too_few_devices():
    """The JAX axis names ("sp" only when > 1) and shapes; a list too short
    raises (the JAX function asserts); a device may repeat."""
    for args, kw in (((2, 4), {}), ((1, 2), {"n_sp": 4}), ((8, 1), {})):
        got, want = make_mesh(*args, CPU8, **kw), jax_make_mesh(*args, **kw)
        assert got.axis_names == want.axis_names
        assert got.shape == dict(want.shape)
        assert got.devices.shape == want.devices.shape
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        make_mesh(3, 3, CPU8)
    with pytest.raises(AssertionError):
        jax_make_mesh(3, 3)
    mesh = make_mesh(2, 2, CPU8, n_sp=2)
    assert mesh.size == 8 and mesh.replica(1).shape == {"dp": 1, "tp": 2, "sp": 2}
    assert mesh.replica(1).whole_size == 8


@pytest.mark.parametrize("dp,tp,sp", [(4, 4, 1), (16, 1, 1), (2, 2, 3), (1, 1, 1)])
def test_mesh_set_up_clamps_as_the_jax_creator(dp, tp, sp, capsys, tmp_path):
    """sp, tp and dp clamped in that order to 8 devices, the config fields
    set to the mesh's (all 1 when the product is 1), the same printed line."""
    kw = dict(data_parallel_chunks=dp, tensor_parallel=tp, sequence_parallel=sp,
              use_metric_depth=False)
    want = JaxCreator(JaxCreatorConfig(output_dir=str(tmp_path), **kw), pi3_config=TINY)
    want_out = capsys.readouterr().out
    cfg = OfflineCreatorConfig(**kw)
    got = cc.setup_mesh(cfg, CPU8, "device mesh")
    fields = ("data_parallel_chunks", "tensor_parallel", "sequence_parallel")
    assert [getattr(cfg, f) for f in fields] == [getattr(want.config, f) for f in fields]
    if want.mesh is None:
        assert got is None
    else:
        assert got.shape == dict(want.mesh.shape)
        line = [ln for ln in want_out.splitlines() if ln.startswith("device mesh")]
        assert line == [ln for ln in capsys.readouterr().out.splitlines()
                        if ln.startswith("device mesh")]


# ----- ring attention and the sharded pieces -----


def _jax_ring(q, k, v, sp, n_pad=0):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    spec = P(None, "sp", None, None)
    return np.asarray(shard_map(
        lambda a, b, c: jax_ring(a, b, c, "sp", n_pad=n_pad), mesh=jax_make_mesh(1, 1, n_sp=sp),
        in_specs=(spec, spec, spec), out_specs=spec, check_rep=False)(q, k, v))


def test_ring_attention_matches_jax_with_a_padded_tail(rng):
    """sp 8 at T 512, and T 480 padded to 512 (4 zero rows on the last
    shard, taken out by their count): within 3e-5 of plain attention (the
    JAX test's bound) and of the JAX ring."""
    B, T, H, D, sp = 2, 512, 2, 64, 8
    q, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))

    def port(q, k, v, n_pad=0):
        ts = T // sp
        shards = [[torch.from_numpy(x[:, s * ts : (s + 1) * ts]) for s in range(sp)]
                  for x in (q, k, v)]
        return np.concatenate([_np(o) for o in ring_attention(*shards, n_pad=n_pad)], axis=1)

    got = port(q, k, v)
    ref = _np(sdpa_reference(*(torch.from_numpy(x) for x in (q, k, v))))
    np.testing.assert_allclose(got, ref, atol=3e-5)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, sp), atol=3e-5)

    tr = 480
    padded = [np.pad(x[:, :tr], ((0, 0), (0, T - tr), (0, 0), (0, 0))) for x in (q, k, v)]
    got2 = port(*padded, n_pad=T - tr)[:, :tr]
    ref2 = np.asarray(jax_sdpa_reference(*(jnp.asarray(x[:, :tr]) for x in (q, k, v))))
    np.testing.assert_allclose(got2, ref2, atol=3e-5)
    np.testing.assert_allclose(got2, _jax_ring(*padded, sp, n_pad=T - tr)[:, :tr], atol=3e-5)


def test_shard_attention_rings_long_sequences_as_jax_sharded_sdpa(rng):
    """A (1, 2, 4) mesh at T 4100 (>= the long-sequence threshold, 4100 % 4
    != 0: padded to 4104): each tp shard's head through shard_attention on
    its 4 sp devices, as models/layers.py::sharded_attention splits them;
    within 5e-5 (the JAX test's bound) of plain attention and of the JAX
    sharded_sdpa on the same mesh."""
    q, k, v = (rng.normal(size=(1, 4100, 2, 64)).astype(np.float32) for _ in range(3))
    mesh = make_mesh(1, 2, CPU8, n_sp=4)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    assert all(len(mesh.sp_devices(j)) == 4 for j in range(2))
    got = np.concatenate([
        _np(shard_attention(qt[:, :, j : j + 1], kt[:, :, j : j + 1], vt[:, :, j : j + 1],
                            mesh.sp_devices(j)))
        for j in range(2)], axis=2)
    ref = _np(sdpa_reference(qt, kt, vt))
    np.testing.assert_allclose(got, ref, atol=5e-5)
    with jax_mesh_context(jax_make_mesh(1, 2, n_sp=4)):
        want = np.asarray(jax_sharded_sdpa(*(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2)])
def test_sharded_block_mlp_matches_jax(rng, dp, sp):
    """Rows split over dp (batch) and sp (tokens), the block MLP on each
    piece: within 1e-5 of the JAX sharded_block_mlp (its Pallas kernel in
    interpret mode) and within 1e-6 of the port's unsharded block MLP (the
    CPU's matrix products may block rows of another count otherwise; the
    kernel on the card computes a row alike whatever the row count)."""
    B, T, C, Hd = 2, 16, 128, 512
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * 0.05 for s in ((C,), (C,), (C, Hd), (Hd,),
                                                                  (Hd, C), (C,), (C,))]
    g, b, k1, c1, k2, c2, ls = w
    g = g + 1.0
    tw = [torch.from_numpy(a) for a in (g, b, k1.T.copy(), c1, k2.T.copy(), c2)]
    with tp_mesh_context(make_mesh(dp, 1, CPU8, n_sp=sp)):
        got = _np(sharded_block_mlp(torch.from_numpy(x), *tw, ls=torch.from_numpy(ls)))
    one = _np(sharded_block_mlp(torch.from_numpy(x), *tw, ls=torch.from_numpy(ls)))
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)
    with jax_mesh_context(jax_make_mesh(dp, 1, n_sp=sp)):
        want = np.asarray(jax_sharded_block_mlp(
            jnp.asarray(x), *(jnp.asarray(a) for a in (g, b, k1, c1, k2, c2)),
            ls=jnp.asarray(ls), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ----- the sharded Pi3 step -----


@pytest.mark.parametrize("dp,tp", [(4, 2), (8, 1)])
def test_sharded_pi3_step_matches_jax(params, model, rng, dp, tp):
    """fp32 forward over a (dp, tp) mesh against the JAX sharded step (and,
    at dp only, the port's single-device forward bit for bit): points and
    poses within 2e-4 (the JAX test's bound)."""
    imgs = rng.uniform(size=(dp, 2, 3, 28, 28)).astype(np.float32)
    step, replicas = make_sharded_pi3_step(model, make_mesh(dp, tp, CPU8))
    assert len(replicas) == dp and all(r.model is model for r in replicas)
    got = step(replicas, torch.from_numpy(imgs))
    mesh = jax_make_mesh(dp, tp)
    jstep, jparams = jax_sharded_pi3_step(params, TINY, mesh, compute_dtype=jnp.float32)
    want = jstep(jparams, jax.device_put(jnp.asarray(imgs), pi3_input_sharding(mesh)))
    for key in ("points", "camera_poses", "conf", "local_points"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=2e-4, err_msg=key)
    if tp == 1:
        with torch.no_grad():
            ref = [model(torch.from_numpy(imgs[i : i + 1])) for i in range(dp)]
        for key in ("points", "camera_poses"):
            np.testing.assert_array_equal(_np(got[key]), np.concatenate([_np(r[key]) for r in ref]))


def test_kv_merge_is_ignored_under_a_mesh(params, rng):
    """Under an active mesh (dp only here) the global blocks run exact, as
    in the JAX layers: a kv-merge-2 model on a dp-2 mesh gives the exact
    model's outputs bit for bit, and the JAX sharded step's within 2e-4;
    off the mesh kv-merge moves them."""
    import dataclasses

    tree = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(PORT_TINY, global_kv_merge=2)
    merged = build_pi3(cfg, pi3_state_from_jax(tree), torch.device("cpu"), torch.float32)
    exact = build_pi3(PORT_TINY, pi3_state_from_jax(tree), torch.device("cpu"), torch.float32)
    imgs = rng.uniform(size=(2, 4, 3, 28, 28)).astype(np.float32)
    step, replicas = make_sharded_pi3_step(merged, make_mesh(2, 1, CPU8))
    got = step(replicas, torch.from_numpy(imgs))
    with torch.no_grad():
        ref = [exact(torch.from_numpy(imgs[i : i + 1])) for i in range(2)]
        off = merged(torch.from_numpy(imgs[:1]))
    np.testing.assert_array_equal(_np(got["points"]),
                                  np.concatenate([_np(r["points"]) for r in ref]))
    assert not np.array_equal(_np(off["points"]), _np(ref[0]["points"]))
    jcfg = dataclasses.replace(TINY, global_kv_merge=2)
    mesh = jax_make_mesh(2, 1)
    jstep, jparams = jax_sharded_pi3_step(params, jcfg, mesh, compute_dtype=jnp.float32)
    want = jstep(jparams, jax.device_put(jnp.asarray(imgs), pi3_input_sharding(mesh)))
    np.testing.assert_allclose(_np(got["points"]), np.asarray(want["points"]), atol=2e-4)


def test_sharded_chunk_step_with_tensor_parallel_matches_jax(params, model, rng):
    """A (2, 2) mesh: two chunks, one on each dp replica, each forward under
    the tp split; poses within 2e-4 and keypoint points within 2e-2 of the
    JAX sharded chunk step (the JAX test's bounds), masks and colours as
    JAX's, intrinsics by the ill-posed focal solve's check."""
    B, N, H, W = 2, 2, 28, 28
    imgs = rng.uniform(size=(B, N, 3, H, W)).astype(np.float32)
    kps = rng.uniform(2, 26, size=(B, N, 6, 2)).astype(np.float32)
    step = cc.make_sharded_chunk_step(model, 0.1, 0.03, True, make_mesh(2, 2, CPU8))
    # the port's step takes uint8 frames (the loader's); the JAX step floats
    u8 = np.round(imgs * 255).astype(np.uint8)
    got = step([torch.from_numpy(u8[b]) for b in range(B)],
               [torch.from_numpy(kps[b]) for b in range(B)])
    jstep, shard = jax_cc.make_sharded_chunk_step(TINY, jnp.float32, 0.1, 0.03, True,
                                                  jax_make_mesh(2, 2))
    want = jstep(shard(params), jnp.asarray(u8.astype(np.float32) / 255.0), jnp.asarray(kps))
    for b in range(B):
        np.testing.assert_allclose(_np(got[b]["camera_poses"]), np.asarray(want["camera_poses"][b]),
                                   atol=2e-4)
        np.testing.assert_allclose(_np(got[b]["points_kp"]), np.asarray(want["points_kp"][b]),
                                   atol=2e-2)
        np.testing.assert_array_equal(_np(got[b]["masks_kp"]), np.asarray(want["masks_kp"][b]))
        np.testing.assert_allclose(_np(got[b]["colors_kp"]), np.asarray(want["colors_kp"][b]),
                                   atol=1e-5)
        _check_intrinsics(np.asarray(want["intrinsics"][b]), _np(got[b]["intrinsics"]))


# ----- the creator and the online driver -----


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """tests/test_chunk_dp.py's 8 frames: one random image moving right."""
    d = tmp_path_factory.mktemp("frames")
    base = np.random.default_rng(9).integers(30, 220, (64, 84, 3)).astype(np.uint8)
    for i in range(8):
        Image.fromarray(np.roll(base, 3 * i, axis=1)).save(d / f"f_{i:03d}.png")
    return sorted(glob.glob(os.path.join(str(d), "*.png")))


@pytest.fixture(scope="module")
def ckpt(params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_pi3_checkpoint(path, params, TINY)
    return path


CREATOR = dict(chunk_length=4, overlap=2, pixel_limit=4000, use_metric_depth=False,
               max_keypoints=20, compute_dtype="float32")


def _port_chunks(tmp, ckpt, frames, **kw):
    cfg = OfflineCreatorConfig(output_dir=str(tmp), device="cpu", checkpoint_path=ckpt,
                               **CREATOR, **kw)
    creator = cc.OfflineChunkCreator(cfg, devices=CPU8)
    return creator, creator.process_and_save(frames)


def _jax_chunks(tmp, params, frames, **kw):
    creator = JaxCreator(JaxCreatorConfig(output_dir=str(tmp), **CREATOR, **kw), pi3_config=TINY)
    creator.params = params
    return creator, creator.process_and_save(frames)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_chunk(got, want):
    """Key by key, as tests/test_torch_chunk_creator.py holds the CLIs."""
    assert set(got) == set(want)
    for key in sorted(want):
        a, b = want[key], got[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key == "intrinsics":
            _check_intrinsics(a, b)
        elif key in FLOAT_TOL:
            np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), err_msg=key,
                                       **FLOAT_TOL[key])
        elif key == "colors":
            assert np.abs(b.astype(int) - a.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)


@pytest.mark.parametrize("sp", [1, 2])
def test_creator_dp2_matches_jax_and_the_single_device_creator(params, ckpt, frames, tmp_path,
                                                              sp):
    """dp 2 (and dp 2 x sp 2) over a CPU mesh from ``devices=``: 4 chunks in
    two groups, the 2-frame tail padded in the second; the chunk files match
    the JAX creator's on the same mesh key by key, and the dp-only ones equal
    the port's single-device creator's bit for bit; the records give each
    group's launches once and the manifest names the groups."""
    creator, recs = _port_chunks(tmp_path / "port", ckpt, frames, data_parallel_chunks=2,
                                 sequence_parallel=sp)
    assert creator.mesh.shape == ({"dp": 2, "tp": 1} if sp == 1 else {"dp": 2, "tp": 1, "sp": 2})
    assert [r["dp_group"] for r in recs] == [0, 0, 1, 1]
    assert [r["num_frames"] for r in recs] == [4, 4, 4, 2]
    assert all(not any(r["launches"].values()) for r in recs)  # the CPU runs no kernel
    jcreator, jpaths = _jax_chunks(tmp_path / "jax", params, frames, data_parallel_chunks=2,
                                   sequence_parallel=sp)
    assert jcreator.mesh is not None
    for rec, jpath in zip(recs, jpaths):
        _same_chunk(_load(rec["path"]), _load(jpath))
    with open(tmp_path / "port" / "chunks_manifest.json") as f, \
            open(tmp_path / "jax" / "chunks_manifest.json") as g:
        man, jman = __import__("json").load(f), __import__("json").load(g)
    assert [m.pop("dp_group") for m in man] == [0, 0, 1, 1]
    for m, j in zip(man, jman):
        assert m["file"] == j["file"] and m["num_frames"] == j["num_frames"]
    if sp == 1:
        _, single = _port_chunks(tmp_path / "single", ckpt, frames)
        for rec, one in zip(recs, single):
            a, b = _load(rec["path"]), _load(one["path"])
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_online_dp2_group_items_match_jax_and_the_single_device_run(params, ckpt, frames,
                                                                    tmp_path):
    """The online driver at dp 2: one group's pulled items against the JAX
    class's (_dispatch_group / _finish_group on the same two chunks: step
    outputs within 1e-5, keypoints and paths exactly); the whole run over 8
    frames (4 chunks, two groups) equal to the single-device run's
    trajectory, with the queue reading dp 2 and every chunk consumed."""
    kw = dict(chunk_length=4, overlap=2, pixel_limit=4000, use_metric_depth=False,
              max_keypoints=20, compute_dtype="float32")
    slam = online.Pi3SLAMOnline(
        OnlineConfig(output_dir=str(tmp_path / "p"), device="cpu", checkpoint_path=ckpt,
                     data_parallel_chunks=2, **kw), devices=CPU8)
    jslam = jax_online.Pi3SLAMOnline(
        jax_online.OnlineConfig(output_dir=str(tmp_path / "j"), data_parallel_chunks=2, **kw),
        pi3_config=TINY)
    jslam._host_params = jslam.params = params
    jslam._make_steps()
    from pi3_slam_tpu_torch.data import ChunkDataset, calculate_target_size

    size = calculate_target_size(frames[0], 4000)
    ds = ChunkDataset(frames, 4, 2, size)
    group = [ds[0], ds[3]]  # a full chunk and the padded tail
    items = slam._finish_group(slam._dispatch_group(group, 2))
    jitems = jslam._finish_group(jslam._dispatch_group(group, 2))
    assert len(items) == len(jitems) == 2
    for it, jt in zip(items, jitems):
        assert it["batch"] is jt["batch"]
        np.testing.assert_array_equal(it["kps"], jt["kps"])
        host = cc.slice_tail(it["dev"], it["batch"]["images"].shape[0])
        jhost = {k: np.asarray(v) for k, v in jt["dev"].items()}
        for key in ("points_kp", "local_points_kp", "conf_kp", "camera_poses", "colors_kp"):
            n = host[key].shape[0]
            np.testing.assert_allclose(host[key], jhost[key][:n], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
        np.testing.assert_array_equal(host["masks_kp"], jhost["masks_kp"][: host["masks_kp"].shape[0]])
    run = online.Pi3SLAMOnline(
        OnlineConfig(output_dir=str(tmp_path / "p2"), device="cpu", checkpoint_path=ckpt,
                     data_parallel_chunks=2, **kw), devices=CPU8)
    assert run.process_image_paths(frames)["num_chunks"] == 4
    single = online.Pi3SLAMOnline(
        OnlineConfig(output_dir=str(tmp_path / "p1"), device="cpu", checkpoint_path=ckpt, **kw))
    single.process_image_paths(frames)
    np.testing.assert_array_equal(run._merged_trajectory()[0], single._merged_trajectory()[0])
    status = run.queue_status()
    assert (status["chunks_produced"], status["chunks_consumed"], status["chunks_inflight"],
            status["data_parallel_chunks"]) == (4, 4, 0, 2)
    assert len(run.chunk_launches) == 4


# ----- threads through the kernel wrappers (the CPU halves; tests/test_torch_cuda.py
# launches the kernels) -----


def test_launch_counts_lose_nothing_across_threads():
    """count_launch from 8 threads at once: every increment is counted."""
    class Wrapper:
        launches = 0
        launches_fp32 = 0

    def hammer(fp32):
        for _ in range(5000):
            _build.count_launch(Wrapper, fp32)

    threads = [threading.Thread(target=hammer, args=(i % 2 == 0,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (Wrapper.launches, Wrapper.launches_fp32) == (20000, 20000)


def test_first_build_runs_once_under_the_lock(monkeypatch):
    """Eight threads load one library at once: it is built once and every
    thread gets the same handle (the build here is a stand-in that waits, so
    that the threads meet)."""
    built = []
    release = threading.Event()

    def slow_build(name):
        built.append(name)
        release.wait(2.0)
        return "lib.so", 0.0

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    handles = []
    threads = [threading.Thread(target=lambda: handles.append(_build.load_library("probe")))
               for _ in range(8)]
    for t in threads:
        t.start()
    release.set()
    for t in threads:
        t.join()
    assert built == ["probe"] and len(handles) == 8 and len({id(h) for h in handles}) == 1
