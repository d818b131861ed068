"""The port's Pi3 model against the JAX package's ``pi3_forward`` on the CPU.

A tiny config whose attention head dim is 64 everywhere (the GPU kernels'
contract): C=128, 2 heads, 2 encoder blocks, 4 decoder blocks, head depth 1.
Both sides get the same JAX-layout parameter tree (every leaf perturbed, so
norms, biases and LayerScales all matter) and the same images, and run in
fp32; the JAX side takes its XLA path (``on_tpu_platform()`` is false on the
CPU). Tolerances are fp32 ones through ~10 blocks.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.models import dinov2 as jax_dinov2
from pi3_slam_tpu.models import pi3 as jax_pi3

from pi3_slam_tpu_torch.models.convert import (
    build_pi3,
    init_pi3_params,
    load_pi3_checkpoint,
    pi3_state_from_jax,
)
from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
from pi3_slam_tpu_torch.models.pi3 import Pi3, Pi3Config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = Pi3Config(
    encoder=DinoV2Config(embed_dim=128, depth=2, num_heads=2, pos_embed_size=6),
    dec_embed_dim=128, dec_num_heads=2, dec_depth=4, head_dim=128, head_depth=1,
    head_num_heads=2, camera_dim=32,
)
JAX_CFG = jax_pi3.Pi3Config.from_json(CFG.to_json())
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturbed_tree(seed):
    rng = np.random.default_rng(seed)
    tree = init_pi3_params(seed, CFG)
    return jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )


def test_numpy_init_matches_jax_init():
    ours = jax.tree.leaves(init_pi3_params(3, CFG))
    ref = jax.tree.leaves(jax_pi3.init_pi3_params(3, JAX_CFG))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_state_dict_covers_every_parameter():
    state = pi3_state_from_jax(init_pi3_params(0, CFG))
    model = Pi3(CFG, device="meta")
    assert set(state) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert tuple(state[name].shape) == tuple(p.shape), name


def test_built_model_holds_contiguous_weights_apart_from_the_tree():
    """The converters hand transposed kernels over as strided views; the
    built model holds every weight contiguous (the kernels read them so) and
    equal to the tree's, and writes none of it back into the tree."""
    tree = init_pi3_params(0, CFG)
    kernel = tree["decoder"]["even_blocks"]["fc1_kernel"][0]
    before = kernel.copy()
    model = build_pi3(CFG, pi3_state_from_jax(tree), torch.device("cpu"), torch.float32)
    assert all(t.is_contiguous() for t in [*model.parameters(), *model.buffers()])
    weight = model.decoder[0].fc1.weight
    np.testing.assert_array_equal(weight.detach().numpy(), kernel.T)
    with torch.no_grad():
        weight.add_(1.0)
    np.testing.assert_array_equal(kernel, before)


@pytest.mark.parametrize("n_frames,hw", [(3, (42, 56)), (2, (28, 70))])
def test_pi3_forward_matches_jax(n_frames, hw):
    tree = _perturbed_tree(1)
    imgs = np.random.default_rng(2).random((1, n_frames, 3) + hw, dtype=np.float32)
    want = jax_pi3.pi3_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), JAX_CFG)
    model = build_pi3(CFG, pi3_state_from_jax(tree), torch.device("cpu"), torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5, rtol=1e-4,
                                   err_msg=key)


def test_encoder_matches_jax():
    """DINOv2 patchify, pos-embed interpolation, register tokens, blocks."""
    tree = _perturbed_tree(4)
    imgs = np.random.default_rng(5).standard_normal((2, 3, 42, 70)).astype(np.float32)
    jcfg = jax_dinov2.DinoV2Config(**CFG.encoder.__dict__)
    want = jax_dinov2.dinov2_forward(
        jax.tree.map(jnp.asarray, tree["encoder"]), jnp.asarray(imgs), jcfg
    )
    model = build_pi3(CFG, pi3_state_from_jax(tree), torch.device("cpu"), torch.float32)
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(imgs))
    for key in ("cls_token", "register_tokens", "patch_tokens"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5, err_msg=key)


def test_checkpoint_round_trip(tmp_path):
    from pi3_slam_tpu.models.convert import save_pi3_checkpoint

    tree = _perturbed_tree(6)
    path = str(tmp_path / "pi3.npz")
    save_pi3_checkpoint(path, tree, JAX_CFG)
    loaded, cfg = load_pi3_checkpoint(path)
    assert cfg == CFG
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_port_imports_and_runs_without_jax():
    """The port never imports JAX nor the JAX package: a fresh interpreter
    imports every module (the SfM, reconstructor, localization, telemetry and
    probe modules included), runs a tiny forward, a tiny bundle adjustment, a
    Sim3 fit, the APE scorer, the appearance and localization solvers, a
    tiny TSDF fusion with its raycast, mesh file and metrics, the viewer, the
    debug projections' numbers, a tiny MoGe v1 through its converter, the
    probe table, the trace reader and the repo-root tools' helpers, and finds
    neither 'jax' nor 'pi3_slam_tpu' nor a test module in sys.modules."""
    code = textwrap.dedent(
        """
        import sys, pkgutil, importlib, torch
        import pi3_slam_tpu_torch
        for m in pkgutil.walk_packages(pi3_slam_tpu_torch.__path__, "pi3_slam_tpu_torch."):
            importlib.import_module(m.name)
        from pi3_slam_tpu_torch.models.convert import build_pi3, init_pi3_params, pi3_state_from_jax
        from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
        from pi3_slam_tpu_torch.models.pi3 import Pi3Config
        cfg = Pi3Config(encoder=DinoV2Config(embed_dim=128, depth=1, num_heads=2, pos_embed_size=4),
                        dec_embed_dim=128, dec_num_heads=2, dec_depth=2, head_dim=128,
                        head_depth=1, head_num_heads=2, camera_dim=16)
        model = build_pi3(cfg, pi3_state_from_jax(init_pi3_params(0, cfg)), torch.device("cpu"),
                          torch.float32)
        with torch.no_grad():
            out = model(torch.rand(1, 2, 3, 28, 28))
        assert out["points"].shape == (1, 2, 28, 28, 3)
        # the SfM path: a tiny bundle adjustment, a Sim3 fit, the APE scorer
        import numpy as np
        from pi3_slam_tpu_torch.geometry.sim3 import robust_umeyama
        from pi3_slam_tpu_torch.sfm.ba import bundle_adjust, make_problem
        from pi3_slam_tpu_torch.utils.evaluation import ape_translation
        eye = np.tile(np.eye(3), (2, 1, 1))
        prob = make_problem(eye, [[0, 0, 0], [1, 0, 0]], [[0, 0, 5], [1, 1, 6]],
                            np.tile([500.0, 500, 320, 240], (2, 1)), [[0, 1], [1, 0]],
                            np.full((2, 2, 2), 300.0), np.ones((2, 2)))
        assert torch.isfinite(bundle_adjust(prob, iterations=2).points).all()
        pts = torch.rand(10, 3)
        assert float(robust_umeyama(pts, 2 * pts).scale) > 1.9
        assert ape_translation(np.random.rand(5, 3), np.random.rand(5, 3)).rmse >= 0
        # the appearance path: ALIKED, ZNCC refinement, the Sim3 pose graph
        from pi3_slam_tpu_torch.models.aliked import (CONFIGS, aliked_extract,
            aliked_state_from_jax, build_aliked, init_aliked_params)
        from pi3_slam_tpu_torch.ops.correlation import zncc_refine_observations
        from pi3_slam_tpu_torch.sfm.posegraph import (optimize_sim3_pose_graph,
            sequential_edges, stack_sim3)
        cfg = CONFIGS["aliked-t16"]
        aliked = build_aliked(cfg, aliked_state_from_jax(init_aliked_params(0, cfg)))
        assert aliked_extract(aliked, torch.rand(1, 3, 32, 48), 20)["descriptors"].shape == (1, 20, 64)
        uv, _, _ = zncc_refine_observations(torch.rand(2, 32, 32), torch.zeros(3, dtype=torch.long),
            torch.full((3, 2), 16.0), torch.ones((3, 1), dtype=torch.long), torch.full((3, 1, 2), 16.0))
        assert torch.isfinite(uv).all()
        i, j, meas = sequential_edges(3)
        res = optimize_sim3_pose_graph(stack_sim3(meas + meas[:1]), i, j, stack_sim3(meas), device="cpu")
        assert res.final_cost <= res.initial_cost + 1e-9
        # the second camera and georeferencing: PnP, the telemetry priors, COLMAP's quaternions
        from pi3_slam_tpu_torch.geometry.transforms import rotation_matrix_to_quaternion
        from pi3_slam_tpu_torch.sfm.localize import ransac_pnp
        from pi3_slam_tpu_torch.sfm.priors import geodetic_to_enu
        X = torch.rand(40, 3) + torch.tensor([0.0, 0.0, 4.0])
        pnp = ransac_pnp(X, 500 * X[:, :2] / X[:, 2:] + 320, torch.tensor([500.0, 500, 320, 320]),
                         num_samples=16, device="cpu")
        assert int(pnp.num_inliers) == 40
        assert geodetic_to_enu(np.array([[48.0, 11.0, 500.0]]))[0].shape == (1, 3)
        assert float(rotation_matrix_to_quaternion(torch.eye(3))[0]) == 1.0
        # dense mapping: fusion, raycast, surface nets, the mesh file and its metrics
        from pi3_slam_tpu_torch.io.mesh import read_mesh_ply, write_mesh_ply
        from pi3_slam_tpu_torch.mapping import TSDFConfig, fuse_tsdf, raycast_depth
        from pi3_slam_tpu_torch.utils.mesh_eval import evaluate_mesh
        vol = fuse_tsdf(np.full((2, 12, 16), 2.0), np.tile([10.0, 10, 8, 6], (2, 1)),
                        np.tile(np.eye(3), (2, 1, 1)), np.zeros((2, 3)),
                        config=TSDFConfig(voxel_size=0.1), device="cpu")
        verts, faces, _ = vol.extract_mesh()
        assert len(faces) and raycast_depth(vol, [10.0, 10, 8, 6], np.eye(3), np.zeros(3), 12, 16,
                                            device="cpu")["mask"].any()
        import os, tempfile
        mesh_path = os.path.join(tempfile.mkdtemp(), "mesh.ply")
        write_mesh_ply(verts, faces, mesh_path)
        assert len(read_mesh_ply(mesh_path)["faces"]) == len(faces)
        assert np.isfinite(evaluate_mesh(verts, faces, verts, n_samples=100).chamfer)
        # the viewer (console lines), the debug projections, MoGe v1 and its
        # converter, the probe table, the trace reader
        import contextlib, io, json, os, tempfile, types
        from pi3_slam_tpu_torch.viz.visualizer import OnlineVisualizer
        vis = OnlineVisualizer(threaded=False)
        vis.update(types.SimpleNamespace(points=np.zeros((3, 3)), colors=np.zeros((3, 3)),
                                         track_valid=np.ones(3), centers=np.zeros((2, 3)),
                                         rotations=np.tile(np.eye(3), (2, 1, 1))))
        assert vis.state.chunk_count == 1
        from pi3_slam_tpu_torch.sfm.reconstruction import ChunkReconstruction
        from pi3_slam_tpu_torch.sfm.serialization import debug_projection_data
        rec = ChunkReconstruction(frame_names=["a", "b"], rotations=eye, centers=np.zeros((2, 3)),
            intrinsics=np.tile([50.0, 50, 16, 12], (2, 1)), points=np.array([[0.0, 0, 4]]),
            colors=np.zeros((1, 3)), track_frame=np.zeros(1, int), track_kp=np.zeros(1, int),
            track_uv=np.full((1, 2), 16.0), track_valid=np.ones(1), obs_frame=np.array([[0, 1]]),
            obs_uv=np.array([[[16.0, 12], [17, 12]]]), obs_valid=np.ones((1, 2)), image_width=32,
            image_height=24)
        assert [float(d["errors"][0]) for d in debug_projection_data(rec, 2, device="cpu")] == [0.0, 1.0]
        from pi3_slam_tpu_torch.models.convert import (build_moge_v1, convert_moge_v1_state_dict,
            moge_v1_state_from_jax, random_moge_v1_state_dict)
        from pi3_slam_tpu_torch.models.moge_v1 import MoGeV1Config, moge_v1_infer
        mc = {"encoder": "dinov2_vits14", "dim_proj": 32, "dim_upsample": [32, 32, 32],
              "intermediate_layers": [0, 1]}
        cfg = MoGeV1Config.from_model_config(mc)
        tree = convert_moge_v1_state_dict(random_moge_v1_state_dict(cfg, 0), mc)
        assert MoGeV1Config.from_model_config(json.loads(tree["_v1_config_json"])) == cfg
        v1 = build_moge_v1(cfg, moge_v1_state_from_jax(tree), torch.device("cpu"))
        with torch.no_grad():
            assert moge_v1_infer(v1, torch.rand(3, 28, 42), 6)["depth"].shape == (28, 42)
        from pi3_slam_tpu_torch.tools import perf_lab, trace_summary
        assert "kv-accuracy" in perf_lab.PROBES and perf_lab.ALL[0] == "global"
        trace = os.path.join(tempfile.mkdtemp(), "chunk_trace.json")
        with open(trace, "w") as f:
            json.dump({"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0,
                                        "dur": 5.0}]}, f)
        with contextlib.redirect_stdout(io.StringIO()):
            assert trace_summary.main([os.path.dirname(trace)]) == 0
        assert trace_summary.summarize(trace)["device_total_us"] == 5.0
        # the repo-root tools: the synthetic scene, the frames, the drift
        # helpers, the importer; none of them reaches for a test module
        from pi3_slam_tpu_torch.tools import (ablate_observation_fan, import_reference_chunks,
            kv_merge_drift, perf_online_floor, perf_pipeline, smoke_e2e, synthetic)
        d = tempfile.mkdtemp()
        assert synthetic.write_synthetic_chunks(d, np.random.default_rng(0)).shape == (14, 3)
        assert len(perf_pipeline.make_frames(os.path.join(d, "frames"), 2, 24, 32)) == 2
        assert kv_merge_drift.sharpen_params({"q_norm_scale": np.ones(2)}, 8.0)["q_norm_scale"][0] == 8
        assert "camera_poses_cw" in import_reference_chunks.convert_chunk(
            {"camera_poses": torch.eye(4)[None]})
        assert not [m for m in sys.modules if m.split(".")[0].startswith(("test_", "tests"))]
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        assert "pi3_slam_tpu" not in sys.modules, sorted(
            m for m in sys.modules if m.split(".")[0] == "pi3_slam_tpu")
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
