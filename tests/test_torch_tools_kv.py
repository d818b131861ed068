"""The port's ``kv_merge_drift`` tool against the JAX package's
``tools/kv_merge_drift.py`` on the CPU: the same frames and sharpened tree,
the port's tiny forwards on the JAX tree within the JAX test's bounds and
near the JAX drift, and the tool's rows."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pi3_slam_tpu_torch.tools import kv_merge_drift

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its runs are chains of small
    operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    """The JAX package's tools/kv_merge_drift.py."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_kv_merge_drift", os.path.join(REPO, "tools", "kv_merge_drift.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def kv_runs():
    """The JAX tiny tree sharpened 8x, the tool's frames (seed 1000, 8 frames of
    42x56), and the exact and merged (2, 4) forwards of both packages."""
    import jax
    import jax.numpy as jnp

    from pi3_slam_tpu.models import pi3_forward
    from test_pi3_model import TINY, make_tiny_params

    jkv = _jax_tool()
    tree = make_tiny_params(0)
    jparams = jkv.sharpen_params(tree, 8.0)
    ntree = jax.tree.map(np.asarray, tree)
    params = kv_merge_drift.sharpen_params(ntree, 8.0)
    imgs = jkv.make_video_frames(np.random.default_rng(1000), 8, 42, 56)
    fwd = jax.jit(pi3_forward, static_argnames=("cfg",))
    model = kv_merge_drift.build_model(params, kv_merge_drift.TINY, "cpu")
    out = {}
    for m in (1, 2, 4):
        cfg = dataclasses.replace(TINY, global_kv_merge=m)
        out[m] = (jax.tree.map(np.asarray, fwd(jparams, jnp.asarray(imgs), cfg)),
                  kv_merge_drift.forward(model, imgs, m))
    return {"ntree": ntree, "jparams": jparams, "params": params, "jkv": jkv, "out": out}


def test_kv_merge_drift_inputs_match_jax(kv_runs):
    import jax

    jkv = kv_runs["jkv"]
    for seed, n in ((1000, 8), (1001, 16)):
        np.testing.assert_array_equal(
            kv_merge_drift.make_video_frames(np.random.default_rng(seed), n, 42, 56),
            jkv.make_video_frames(np.random.default_rng(seed), n, 42, 56))
    want = jax.tree_util.tree_flatten_with_path(kv_runs["jparams"])[0]
    got = jax.tree_util.tree_flatten_with_path(kv_runs["params"])[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    scaled = 0
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))
        scaled += jax.tree_util.keystr(path).endswith("['q_norm_scale']")
    assert scaled == 2  # the decoder's even and odd block stacks
    assert kv_merge_drift.sharpen_params(kv_runs["params"], 1.0) is kv_runs["params"]
    # the tool's tiny widths are the JAX test's
    from test_pi3_model import TINY

    assert json.loads(kv_merge_drift.TINY.to_json()) == dataclasses.asdict(TINY)


# The floor: the port's exact forward against the JAX one on the same tree
# measured point_rel 4.7e-7, trans_rel 2.6e-7, rot_deg 6.9e-3 (arccos of a
# trace near 3 resolves ~1e-2 degree on float32 rotations), conf_mad 6e-10.
# trans_rel is held to the JAX value within TRANS_TOL (~4x its floor), rot_deg
# within ROT_TOL; point_rel (~1e-6) and conf_mad sit at the floor and are held
# only to the JAX test's bounds.
TRANS_TOL = 1e-6
ROT_TOL = 0.05


@pytest.mark.parametrize("merge", [2, 4])
def test_kv_merge_drift_matches_jax(kv_runs, merge):
    out = kv_runs["out"]
    (j_exact, t_exact), (j_merged, t_merged) = out[1], out[merge]
    floor = kv_merge_drift.drift_metrics(j_exact, t_exact)
    assert floor["point_rel"] < 1e-5 and floor["trans_rel"] < 1e-6, floor
    d = kv_merge_drift.drift_metrics(t_exact, t_merged)
    want = kv_runs["jkv"].drift_metrics(j_exact, j_merged)
    # the JAX test's bounds (tests/test_kv_merge_drift.py) and its wiring check
    assert d["point_rel"] < 1e-4, d
    assert d["trans_rel"] < 2e-2, d
    assert d["rot_deg"] < 0.5, d
    assert d["conf_mad"] < 1e-4, d
    assert d["trans_rel"] > 1e-8, d
    assert abs(d["trans_rel"] - want["trans_rel"]) < TRANS_TOL, (d, want)
    assert abs(d["rot_deg"] - want["rot_deg"]) < ROT_TOL, (d, want)


def test_kv_merge_drift_tool_rows(kv_runs, capsys):
    """The tool's entry on the JAX tree: the loop's rows (merge 4 skipped where
    it does not divide the frames), the printed JSON, and the exact forward's
    drift against itself zero."""
    rows = kv_merge_drift.run(["--seeds", "0", "--frames", "6", "8", "--sharpen", "8",
                               "--merges", "2", "4", "--device", "cpu"],
                              make_params=lambda seed: kv_runs["ntree"])
    assert [(r["frames"], r["merge"]) for r in rows] == [(6, 2), (8, 2), (8, 4)]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rows
    exact = kv_runs["out"][1][1]
    assert kv_merge_drift.drift_metrics(exact, exact)["trans_rel"] == 0.0
