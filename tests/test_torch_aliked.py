"""The port's ALIKED (``pi3_slam_tpu_torch/models/aliked.py``), its converter
and its extractor against the JAX package's, on the CPU.

The same numpy parameter trees and frames go through both. aliked-t16's
widths on a few 64 x 96 frames; the dense maps are fp32 convolutions on
both sides (relative L2 1e-5); detection on the same score map is held
exactly (the same integer positions and validity, sub-pixel offsets to
1e-5 px), including a map whose candidate slots are almost all tied at 0
(the filler slots past the NMS survivors) and one with equal peaks.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.models import aliked as jal
from pi3_slam_tpu.models import convert as jconv
from pi3_slam_tpu_torch.models import aliked as tal
from pi3_slam_tpu_torch.models import convert as tconv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = tal.CONFIGS["aliked-t16"]
JCFG = jal.CONFIGS["aliked-t16"]


def _tree(seed=0, cfg=CFG):
    """The random init with every BatchNorm statistic and bias perturbed, so
    each of them matters."""
    rng = np.random.default_rng(100 + seed)
    tree = tal.init_aliked_params(seed, cfg)

    def perturb(node):
        for k, v in node.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("bias", "running_mean") or k.endswith("_bias"):
                node[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k in ("weight", "running_var"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    perturb(tree)
    return tree


def _model(tree, cfg=CFG):
    return tal.build_aliked(cfg, tal.aliked_state_from_jax(tree))


def _frames(n=3, h=64, w=96, seed=1):
    return np.random.default_rng(seed).uniform(size=(n, 3, h, w)).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", ["aliked-t16", "aliked-n16", "aliked-n32"])
def test_init_is_the_jax_init(name):
    a, b = tal.init_aliked_params(3, tal.CONFIGS[name]), jal.init_aliked_params(3, jal.CONFIGS[name])
    flat_a = dict(_leaves(a))
    flat_b = dict(_leaves(b))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_b:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, node


@pytest.mark.parametrize("hw", [(64, 96), (40, 72)])
def test_dense_maps_match_jax(hw):
    """Feature and score maps within relative L2 1e-5; 40 rows pool to 20, 5
    and 1 (the single-row upsampling case)."""
    tree = _tree()
    x = _frames(2, *hw)
    jf, js = jal.aliked_dense_maps(tree, jnp.asarray(x), JCFG)
    with torch.no_grad():
        tf, ts = tal.aliked_dense_maps(_model(tree), torch.from_numpy(x))
    assert tf.shape == (2, *hw, CFG.dim) and ts.shape == (2, *hw)
    assert rel_l2(tf, jf) < 1e-5
    assert rel_l2(ts, js) < 1e-5


def _check_detection(got, want, threshold=1e-5):
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(want["scores"]))
    np.testing.assert_allclose(got["keypoints"].numpy(), np.asarray(want["keypoints"]),
                               atol=threshold, rtol=0)


def test_detection_matches_jax_on_a_score_map():
    tree = _tree()
    _, js = jal.aliked_dense_maps(tree, jnp.asarray(_frames()), JCFG)
    score = np.asarray(js)
    want = jal.detect_keypoints(jnp.asarray(score), 300, 2, 0.005)
    got = tal.detect_keypoints(torch.tensor(score), 300, 2, 0.005)
    _check_detection(got, want)
    # most slots are filler: ties at 0, in flat-index order
    assert (~got["valid"]).float().mean() > 0.3


def test_detection_keeps_xla_tie_order():
    """Equal planted peaks and an all-zero background: the top-k takes equal
    values lowest flat index first (XLA's order), and the filler slots
    (score 0, in the first rows, whose soft-argmax window wraps around the
    top border) land on the JAX coordinates."""
    h, w = 48, 64
    score = np.full((2, h, w), 1e-4, np.float32)
    rng = np.random.default_rng(7)
    for n in range(2):
        for _ in range(12):
            y, x = rng.integers(4, h - 4), rng.integers(4, w - 4)
            score[n, y, x] = 0.5  # equal peaks
        score[n, 10, 10] = score[n, 30, 50] = 0.75
    score[1, 5:8, 5:8] = 0.25  # a flat plateau: every pixel its own local max
    want = jal.detect_keypoints(jnp.asarray(score), 200, 2, 0.005)
    got = tal.detect_keypoints(torch.from_numpy(score), 200, 2, 0.005)
    _check_detection(got, want)
    assert (~got["valid"]).sum() > 300


def test_description_matches_jax():
    tree = _tree()
    jf, js = jal.aliked_dense_maps(tree, jnp.asarray(_frames()), JCFG)
    det = jal.detect_keypoints(js, 100, 2, 0.005)
    # keypoints at the border and at sub-pixel positions, as the filler slots lie
    kp = np.asarray(det["keypoints"]).copy()
    kp[:, :3] = [[0.0, 0.0], [95.0, 63.0], [94.6, 0.3]]
    want = jal.describe_keypoints(tree, jf, jnp.asarray(kp), JCFG)
    with torch.no_grad():
        got = tal.describe_keypoints(_model(tree), torch.from_numpy(np.asarray(jf)),
                                     torch.from_numpy(kp))
    assert got.shape == (3, 100, CFG.dim)
    assert rel_l2(got, want) < 1e-5
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(3)
    fmap = rng.standard_normal((2, 9, 11, 5)).astype(np.float32)
    xy = rng.uniform(-2, 13, (2, 7, 2)).astype(np.float32)
    xy[0, 0] = [10.0, 8.0]  # the last pixel
    want = np.stack([np.asarray(jal._bilinear_sample(jnp.asarray(fmap[i]), jnp.asarray(xy[i])))
                     for i in range(2)])
    got = tal.bilinear_sample(torch.from_numpy(fmap), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_extract_matches_jax(dtype):
    """The whole forward; uint8 frames are divided by 255 on both sides.
    Keypoints to 1e-4 px (the score maps differ by fp32 rounding), the same
    validity, descriptors within relative L2 1e-4."""
    tree = _tree()
    x = _frames()
    if dtype == "uint8":
        x = (x * 255).astype(np.uint8)
    want = jal.aliked_extract(tree, jnp.asarray(x), JCFG, max_keypoints=120)
    got = tal.aliked_extract(_model(tree), torch.from_numpy(x), 120)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["keypoints"].numpy(), np.asarray(want["keypoints"]), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=1e-5,
                               atol=1e-7)
    assert rel_l2(got["descriptors"], want["descriptors"]) < 1e-4


def _lightglue_state_dict(cfg=CFG, seed=5):
    """A lightglue-named state dict from the port's own init (the module's
    state dict is in that naming), every leaf perturbed."""
    return {k: v.numpy() for k, v in tal.aliked_state_from_jax(_tree(seed, cfg)).items()}


def test_converter_matches_jax_and_refuses_unknown_keys():
    sd = _lightglue_state_dict()
    want = jconv.convert_aliked_state_dict(sd, model_name="aliked-t16")
    got = tconv.convert_aliked_state_dict(sd, model_name="aliked-t16")
    assert got.pop("_model_name") == want.pop("_model_name") == "aliked-t16"
    a, b = dict(_leaves(got)), dict(_leaves(want))
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the state dict is the module's: converting back gives the tree it came
    # from (in float32, as the module holds it)
    for k, v in _leaves(_tree(5)):
        np.testing.assert_array_equal(a[k], np.float32(v), err_msg=k)
    sd["desc_head.unexpected_new_layer.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unmatched"):
        tconv.convert_aliked_state_dict(sd)


def test_convert_cli_writes_the_jax_tree(tmp_path):
    """python -m pi3_slam_tpu_torch.tools.convert_checkpoint --model aliked on
    a .pth state dict writes the tree of the JAX tool on the same file, and
    the extractor loads it into both packages with the named variant."""
    from pi3_slam_tpu_torch.tools import convert_checkpoint as tool
    from tools import convert_checkpoint as jax_tool

    src = tmp_path / "aliked-t16.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _lightglue_state_dict().items()}, src)
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "jax.npz")
    args = ["--model", "aliked", "--aliked-name", "aliked-t16", "--input", str(src)]
    assert tool.main(args + ["--output", ours]) == 0
    jax_tool.main(args + ["--output", theirs])
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tree, cfg = tconv.load_aliked_checkpoint(ours)
    assert cfg == CFG and "_model_name" not in tree


def _npz(tmp_path, seed=0):
    path = str(tmp_path / f"aliked_t16_{seed}.npz")
    tconv.save_params_npz(path, {**_tree(seed), "_model_name": "aliked-t16"})
    return path


def test_extractor_batches_and_matches_jax(tmp_path):
    """Mini-batches of 2 frames give what one batch of all 5 gives (to fp32
    rounding: a convolution over another batch size may sum in another
    order), and the JAX extractor's outputs (its frames padded to its
    batch); colours are bilinear samples of the frames."""
    from pi3_slam_tpu.utils.keypoints import ALIKEDExtractor as JaxExtractor
    from pi3_slam_tpu_torch.utils.keypoints import ALIKEDExtractor

    path = _npz(tmp_path)
    x = (_frames(5) * 255).astype(np.uint8)
    small = ALIKEDExtractor(path, max_num_keypoints=80, frame_batch=2, device="cpu")
    whole = ALIKEDExtractor(path, max_num_keypoints=80, frame_batch=8, device="cpu")
    assert small.cfg == CFG
    a, b = small.extract_with_colors(x), whole.extract_with_colors(x)
    assert a.keys() == b.keys() == {"keypoints", "descriptors", "scores", "valid", "colors"}
    for k in ("valid", "colors"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["keypoints"], b["keypoints"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-7)
    assert rel_l2(a["descriptors"], b["descriptors"]) < 1e-5
    want = JaxExtractor(path, max_num_keypoints=80, frame_batch=4).extract_with_colors(x)
    np.testing.assert_array_equal(a["valid"], want["valid"])
    np.testing.assert_allclose(a["keypoints"], want["keypoints"], atol=1e-4, rtol=0)
    assert rel_l2(a["descriptors"], want["descriptors"]) < 1e-4
    assert np.abs(a["colors"].astype(int) - want["colors"].astype(int)).max() <= 1


def test_factory_falls_back_to_grid_loudly(tmp_path, capsys):
    from pi3_slam_tpu_torch.utils.keypoints import (
        ALIKEDExtractor,
        GridKeypointExtractor,
        create_keypoint_extractor,
        grid_keypoints,
    )

    ex = create_keypoint_extractor("aliked", max_num_keypoints=30,
                                   aliked_checkpoint_path=_npz(tmp_path), device="cpu")
    assert isinstance(ex, ALIKEDExtractor) and ex.max_num_keypoints == 30
    grid = create_keypoint_extractor("aliked", max_num_keypoints=30, device="cpu")
    assert isinstance(grid, GridKeypointExtractor)
    assert "falling back to grid keypoints" in capsys.readouterr().out
    out = grid.extract_with_colors(_frames(2))
    np.testing.assert_array_equal(out["keypoints"][1], grid_keypoints(64, 96, 30))
    assert out["colors"].dtype == np.uint8
    with pytest.raises(ValueError):
        create_keypoint_extractor("sift")


def test_creator_without_weights_runs_grid(tmp_path, capsys):
    """--keypoints aliked without --aliked-path: the warning, then grid
    chunks (no descriptors), as the JAX creator does."""
    from PIL import Image

    from pi3_slam_tpu_torch import create_offline_chunks as cli
    from test_torch_chunk_creator import CFG as PI3
    from pi3_slam_tpu_torch.models.convert import init_pi3_params, save_pi3_checkpoint

    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        Image.fromarray((_frames(1, 48, 64, i)[0].transpose(1, 2, 0) * 255).astype(np.uint8)).save(
            frames / f"f_{i}.png")
    ckpt = str(tmp_path / "pi3.npz")
    save_pi3_checkpoint(ckpt, init_pi3_params(0, PI3), PI3)
    cli.main(["--images", str(frames), "--model-path", ckpt, "--output", str(tmp_path / "o"),
              "--chunk-length", "3", "--overlap", "1", "--max-kp", "10", "--pixel-limit", "2000",
              "--device", "cpu", "--no-metric-depth", "--keypoints", "aliked"])
    assert "falling back to grid keypoints" in capsys.readouterr().out
    with np.load(os.path.join(tmp_path, "o", "chunks", "chunk_000000.npz")) as z:
        assert "descriptors" not in z.files and "keypoint_valid" not in z.files
