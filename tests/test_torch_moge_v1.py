"""The port's MoGe v1 (``models/moge_v1.py``), its converter and the bicubic
resize it runs on, against the JAX package's, on the CPU, in fp32.

One random v1 state dict in the reference naming (``moge/model/v1.py``'s
``state_dict``: ``models/convert.random_moge_v1_state_dict`` over the port's
module, seed 0), sized as ``tests/test_moge_v1_parity.py``'s MODEL_CONFIG (a
full-width ``dinov2_vits14`` backbone, narrow head widths), goes through both
packages' ``convert_moge_v1_state_dict``; both forwards run the same tree on a
126x168 frame at 81 tokens (a 7 x 10 patch grid). Its points head passes the
view-plane UV through, so the focal / shift solve is well posed; the trunk is
then held apart, at the head's input. Tolerances: the resize 1e-5 (fp32
matrices against torch's kernel); the backbone layers the head reads, points
and mask relative L2 1e-4 (12 fp32 blocks, then the head's convolutions up to
the input size); depth inside the mask and the intrinsics 1e-4 (the focal / shift
solve on those points); the mask equal except where the JAX score lies within
1e-4 of the threshold.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.models import moge_v1 as jm
from pi3_slam_tpu.models.convert import convert_moge_v1_state_dict as jax_convert
from pi3_slam_tpu.models.convert import load_params_npz as jax_load_params_npz
from pi3_slam_tpu.ops.interpolate import bicubic_resize_hw

from pi3_slam_tpu_torch.models.convert import (
    build_moge_v1,
    convert_moge_v1_state_dict,
    load_moge_v1_checkpoint,
    moge_v1_state_from_jax,
    random_moge_v1_state_dict,
    save_params_npz,
)
from pi3_slam_tpu_torch.models.moge_v1 import MoGeV1Config, moge_v1_forward, moge_v1_infer
from pi3_slam_tpu_torch.ops.interpolate import bicubic_resize
from pi3_slam_tpu_torch.tools import convert_checkpoint as tool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL_CONFIG = {  # tests/test_moge_v1_parity.py's
    "encoder": "dinov2_vits14", "intermediate_layers": 4, "dim_proj": 64,
    "dim_upsample": [64, 32, 32], "dim_times_res_block_hidden": 1, "num_res_blocks": 1,
    "remap_output": "exp", "res_block_norm": "group_norm", "num_tokens_range": [1200, 2500],
    "last_res_blocks": 0, "last_conv_channels": 32, "last_conv_size": 1,
}
NUM_TOKENS = 81
TOL = 1e-4


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("out_hw", [(14, 20), (70, 98), (20, 53), (160, 200)])
@pytest.mark.parametrize("antialias", [True, False])
def test_bicubic_resize_matches_jax(rng, out_hw, antialias):
    """Down- and upscales on both paths (torch's antialias path takes the
    A = -0.5 kernel even when it upsamples, the plain one A = -0.75): 1e-5."""
    x = rng.random((2, 37, 53, 3), dtype=np.float32)
    want = np.asarray(bicubic_resize_hw(jnp.asarray(x), out_hw, antialias=antialias))
    got = bicubic_resize(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw, antialias=antialias)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def state_dict():
    return random_moge_v1_state_dict(MoGeV1Config.from_model_config(MODEL_CONFIG), 0)


@pytest.fixture(scope="module")
def trees(state_dict):
    return convert_moge_v1_state_dict(state_dict, MODEL_CONFIG), jax_convert(state_dict,
                                                                             MODEL_CONFIG)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        {k: v for k, v in tree.items() if k != "_v1_config_json"})


def test_converters_give_one_tree(trees):
    """The same leaves under the same paths, and the same config string."""
    port, jax_tree = trees
    assert port["_v1_config_json"] == jax_tree["_v1_config_json"]
    got, want = _leaves(port), _leaves(jax_tree)
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) > 50
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_config_reads_legacy_keys_as_jax():
    for mc in (MODEL_CONFIG, {"encoder": "dinov2_vitl14", "trained_area_range": [250000, 500000],
                              "remap_output": True, "intermediate_layers": [3, 7, 11, 23]},
               {"encoder": "dinov2_vitb14", "remap_output": False, "unknown": 1}):
        got, want = MoGeV1Config.from_model_config(mc), jm.MoGeV1Config.from_model_config(mc)
        assert {k: getattr(got, k) for k in MoGeV1Config.__dataclass_fields__} == {
            k: getattr(want, k) for k in jm.MoGeV1Config.__dataclass_fields__}
        assert got.layer_indices == want.layer_indices
    full = MoGeV1Config(backbone="dinov2_vitl14")
    assert full.encoder_cfg.embed_dim == 1024 and full.encoder_cfg.depth == 24


@pytest.fixture(scope="module")
def outputs(trees):
    """Both forwards (the JAX one under jit) and both infers on one image,
    and the patch tokens of the backbone's layers that the head reads."""
    port_tree, jax_tree = trees
    cfg = MoGeV1Config.from_model_config(MODEL_CONFIG)
    jcfg = jm.MoGeV1Config.from_model_config(MODEL_CONFIG)
    model = build_moge_v1(cfg, moge_v1_state_from_jax(port_tree), torch.device("cpu"))
    image = np.random.default_rng(1).random((1, 3, 126, 168), dtype=np.float32)
    jparams = jax.tree.map(jnp.asarray, {k: v for k, v in jax_tree.items()
                                         if k != "_v1_config_json"})
    heads_read, head_forward = [], jm._head_forward

    def head(p, features, *args):
        heads_read.append([tokens for tokens, _ in features])
        return head_forward(p, features, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "_head_forward", head)
        want, want_layers = jax.jit(lambda p, x: (jm.moge_v1_forward(p, x, jcfg, NUM_TOKENS),
                                                  heads_read[-1]))(jparams, jnp.asarray(image))
    with pytest.MonkeyPatch.context() as mp:  # the infer reuses the forward above
        mp.setattr(jm, "moge_v1_forward", lambda *a, **k: want)
        want_infer = jax.jit(lambda p, x: jm.moge_v1_infer(p, x, jcfg, NUM_TOKENS))(
            jparams, jnp.asarray(image))
    got_layers = []
    hook = model.head.register_forward_pre_hook(
        lambda mod, args: got_layers.append([tokens.numpy() for tokens, _ in args[0]]))
    with torch.no_grad():
        got = moge_v1_forward(model, torch.from_numpy(image), NUM_TOKENS)
    hook.remove()
    with torch.no_grad():
        got_infer = moge_v1_infer(model, torch.from_numpy(image[0]), NUM_TOKENS)
    np_ = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return np_(want), np_(want_infer), {k: v.numpy() for k, v in got.items()}, {
        k: v.numpy() for k, v in got_infer.items()}, [np.asarray(t) for t in want_layers], \
        got_layers[0]


def test_forward_matches_jax(outputs):
    want, _, got, _, _, _ = outputs
    assert got["points"].shape == (1, 126, 168, 3) and got["mask"].shape == (1, 126, 168)
    for key in ("points", "mask"):
        assert _rel(got[key], want[key]) <= TOL, key


def test_trunk_matches_jax_at_the_head_input(outputs):
    """The points head passes the view-plane UV through, so the points
    mostly show that: the trunk is held on its own, each of the four
    layers the head reads (patch tokens, 7 x 10 of them) within relative
    L2 1e-4."""
    *_, want, got = outputs
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (1, 70, 384)
        assert _rel(g, w) <= TOL, i


def test_infer_matches_jax(outputs):
    """Depth inside the mask and the intrinsics within 1e-4 of their size;
    the masks equal away from the threshold; points inf outside the mask."""
    fwd, want, _, got, _, _ = outputs
    score = fwd["mask"][0]
    near = np.abs(score - 0.5) <= 1e-4
    assert ((got["mask"] != want["mask"][0]) & ~near).sum() == 0
    inside = got["mask"] & want["mask"][0]
    assert 0.05 < inside.mean() < 0.95
    d, w = got["depth"][inside], want["depth"][0][inside]
    assert np.abs(d - w).max() <= TOL * np.abs(w).max()
    np.testing.assert_allclose(got["intrinsics"], want["intrinsics"][0], rtol=0, atol=TOL)
    assert got["intrinsics"][0, 0] > 0.5  # well posed: a focal near 1
    assert np.isinf(got["points"][~got["mask"]]).all() and np.isfinite(got["points"][inside]).all()


def test_converter_tool_on_a_v1_checkpoint(state_dict, trees, tmp_path, capsys):
    """A v1 model.pt ({'model', 'model_config'}, torch.save): the tool says so
    and writes the JAX tree, which the JAX package and the port's loader
    read; the port's forward from it is the one above."""
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state_dict.items()},
                "model_config": MODEL_CONFIG}, tmp_path / "model.pt")
    out = str(tmp_path / "v1.npz")
    assert tool.main(["--model", "moge", "--input", str(tmp_path / "model.pt"), "--output",
                      out]) == 0
    assert "detected MoGe v1 checkpoint layout" in capsys.readouterr().out
    back = jax_load_params_npz(out)
    cfg = jm.MoGeV1Config.from_model_config(json.loads(str(back.pop("_v1_config_json"))))
    assert cfg == jm.MoGeV1Config.from_model_config(MODEL_CONFIG)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(trees[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    tree, pcfg = load_moge_v1_checkpoint(out)
    assert pcfg == MoGeV1Config.from_model_config(MODEL_CONFIG) and "_v1_config_json" not in tree
    path2 = str(tmp_path / "again.npz")
    save_params_npz(path2, trees[0])
    assert os.path.getsize(path2) > 0 and load_moge_v1_checkpoint(path2)[1] == pcfg
