"""The port's MoGe-2 against the JAX package's, on the CPU, in fp32.

Backbone ``dinov2_vits14`` (full width: 384, 12 blocks, 6 heads) with the
neck and head widths of tests/test_moge_parity.py, at 140x140 with 100
tokens. Both packages get the same JAX-layout tree: the port's numpy
``init_moge_params`` with every float leaf perturbed (so norms and biases
matter). The port runs NCHW inside and keeps the JAX layouts at its outputs.
Tolerances: fp32 through 12 transformer blocks and ~30 convolutions, stated
per output, relative to the output's size.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.models import dinov2 as jax_dinov2
from pi3_slam_tpu.models import moge_model as jm
from pi3_slam_tpu.models.convert import load_params_npz as jax_load_params_npz
from pi3_slam_tpu.ops.interpolate import bilinear_resize_hw

from pi3_slam_tpu_torch.models import moge_model as tm
from pi3_slam_tpu_torch.models.convert import (
    build_moge,
    init_moge_params,
    load_moge_checkpoint,
    moge_state_from_jax,
    moge_vits_config,
    save_params_npz,
)
from pi3_slam_tpu_torch.models.moge import MoGeRunner
from pi3_slam_tpu_torch.ops.interpolate import bilinear_resize


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = moge_vits_config(num_tokens_range=(100, 400))
JAX_CFG = jm.MoGeConfig.from_json(CFG.to_json())
NUM_TOKENS = 100


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, {k: v for k, v in tree.items() if k != "_config_json"})


@pytest.fixture(scope="module")
def tree():
    rng = np.random.default_rng(1)
    t = init_moge_params(0, CFG)
    return jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)
        if a.dtype.kind == "f" else a, t)


@pytest.fixture(scope="module")
def model(tree):
    return build_moge(CFG, moge_state_from_jax(tree), torch.device("cpu"))


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(2).random((1, 3, 140, 140), dtype=np.float32)


def _close(got, want, rel, what):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{what}: max |err| {err} vs max |ref| {np.abs(want).max()}"


@pytest.mark.parametrize("out_hw", [(14, 20), (70, 98), (20, 53), (160, 200)])
@pytest.mark.parametrize("antialias", [True, False])
def test_bilinear_resize_matches_jax(rng, out_hw, antialias):
    """Down- and upscales, both antialias branches (the input resize uses
    True, the output resizes False). fp32 matrices vs torch's kernel: 1e-5."""
    x = rng.random((2, 37, 53, 3), dtype=np.float32)
    want = np.asarray(bilinear_resize_hw(jnp.asarray(x), out_hw, antialias=antialias))
    got = bilinear_resize(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw, antialias=antialias)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2])
def test_group_norm_matches_jax(rng, groups):
    x = rng.normal(size=(2, 64, 9, 11)).astype(np.float32) * 3 + 1
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bias = (0.1 * rng.normal(size=64)).astype(np.float32)
    want = jm.group_norm(jnp.asarray(x.transpose(0, 2, 3, 1)), groups, jnp.asarray(scale),
                         jnp.asarray(bias))
    norm = torch.nn.GroupNorm(groups, 64)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = tm.group_norm(torch.from_numpy(x), norm)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5)


def test_pixel_shuffle_order_matches_jax(rng):
    """torch's channel-major (c, i, j) PixelShuffle on NCHW is the JAX
    pixel_shuffle_nhwc on NHWC, exactly."""
    x = rng.normal(size=(2, 12, 5, 7)).astype(np.float32)
    want = jm.pixel_shuffle_nhwc(jnp.asarray(x.transpose(0, 2, 3, 1)), 2)
    got = torch.nn.functional.pixel_shuffle(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_conv_stack_matches_jax(tree, model, rng):
    """The neck on random level inputs: replicate-padded convolutions,
    GroupNorms, residual blocks, pixel-shuffle resamplers. fp32: 1e-5 of max."""
    hw = [(5 * 2**i, 7 * 2**i) for i in range(5)]
    feats = [rng.normal(size=(1, c, h, w)).astype(np.float32)
             for c, (h, w) in zip(CFG.neck.dim_in, hw)]
    want = jm.conv_stack_forward(_to_jax(tree)["neck"],
                                 [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats], JAX_CFG.neck)
    with torch.no_grad():
        got = model.neck([torch.from_numpy(f) for f in feats])
    assert len(got) == len(want)
    for level, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), 1e-5, f"level {level}")


def test_intermediate_layers_match_jax(tree, model, rng):
    images = rng.normal(size=(1, 3, 140, 112)).astype(np.float32)
    jcfg = jax_dinov2.DinoV2Config(**dataclasses.asdict(CFG.encoder_cfg))
    want = jax_dinov2.dinov2_intermediate_layers(_to_jax(tree)["backbone"], jnp.asarray(images),
                                                 jcfg, [2, 11, 5])
    with torch.no_grad():
        got = model.backbone.intermediate_layers(torch.from_numpy(images), [2, 11, 5])
    for (gp, gc), (wp, wc) in zip(got, want):
        _close(gp.numpy(), np.asarray(wp), 1e-5, "patch tokens")
        _close(gc.numpy(), np.asarray(wc), 1e-5, "cls token")


def test_moge_forward_matches_jax(tree, model, image):
    """points within 1e-4 of their max and metric_scale 1e-5 relative (12
    fp32 blocks, then the ConvStacks up to 160x160); the mask, a sigmoid of
    logits as large as the points (~40 here), within 1e-3."""
    want = jm.moge_forward(_to_jax(tree), jnp.asarray(image), JAX_CFG, NUM_TOKENS)
    with torch.no_grad():
        got = model(torch.from_numpy(image), NUM_TOKENS)
    assert set(got) == set(want) == {"points", "mask", "metric_scale"}
    assert got["points"].shape == (1, 140, 140, 3) and got["mask"].shape == (1, 140, 140)
    _close(got["points"].numpy(), np.asarray(want["points"]), 1e-4, "points")
    _close(got["mask"].numpy(), np.asarray(want["mask"]), 1e-3, "mask")
    np.testing.assert_allclose(got["metric_scale"].numpy(), np.asarray(want["metric_scale"]),
                               rtol=1e-5)


def _hold_depth(got, want, img, out, model, num_tokens):
    """The port's depth ``got`` against JAX's ``want`` for one (3, H, W)
    image, given the shift of the JAX forward's output ``out`` (see
    test_moge_infer_depth_matches_jax)."""
    pts, mask = np.asarray(out["points"][0]), np.asarray(out["mask"][0]) > 0.5
    scale = float(out["metric_scale"][0])
    from pi3_slam_tpu.geometry.focal import recover_focal_shift

    _, jshift = recover_focal_shift(jnp.asarray(pts[None]), jnp.asarray(mask[None]))
    with torch.no_grad():
        port_out = model(torch.from_numpy(img[None]), num_tokens)
        z = port_out["points"][0, ..., 2].numpy()
    assert got.shape == want.shape == img.shape[1:]
    finite = np.isfinite(got)
    assert finite.sum() >= 10  # enough valid pixels for a metric scale
    shift = got[finite] / scale - z[finite]  # the port's own shift, per pixel
    np.testing.assert_allclose(shift, shift.mean(), atol=1e-4)
    given = (z + float(jshift[0])) * scale
    both = finite & np.isfinite(want)
    _close(given[both], want[both], 1e-4, "depth given the JAX shift")
    assert (finite != np.isfinite(want)).mean() < 0.01


def test_moge_infer_depth_matches_jax(tree, model, image):
    """Depth = (z + shift) * metric_scale inside the mask, inf outside. The
    focal / shift solve on random-weight points can be ill-posed (ROADMAP
    Queue 3), so the depth is held given the JAX shift: the port's depth
    minus its own shift's contribution, plus JAX's, must match, and the
    validity masks agree away from depth ~ 0."""
    jtree = _to_jax(tree)
    img = image[0]
    want = np.asarray(jm.moge_infer_depth(jtree, jnp.asarray(img), JAX_CFG, NUM_TOKENS))
    with torch.no_grad():
        got = tm.moge_infer_depth(model, torch.from_numpy(img), NUM_TOKENS).numpy()
    out = jm.moge_forward(jtree, jnp.asarray(img[None]), JAX_CFG, NUM_TOKENS)
    _hold_depth(got, want, img, out, model, NUM_TOKENS)


def test_batched_runner_on_a_dp_mesh_matches_jax(tree, tmp_path):
    """shard_params over a dp-2 CPU mesh (``devices=``), then
    infer_depth_batch_async on two first frames (uint8, as the creator hands
    them over): one frame on each replica, each depth bit for bit the
    runner's single-frame depth, and held to the JAX runner's dp-sharded
    batch given the JAX shift. The replicas share the runner's weights."""
    from pi3_slam_tpu.models.moge import MoGeRunner as JaxRunner
    from pi3_slam_tpu.parallel import make_mesh as jax_make_mesh

    from pi3_slam_tpu_torch.parallel import make_mesh

    path = str(tmp_path / "moge.npz")
    # the runner's token count is the range's top: 100 tokens, as above
    cfg = dataclasses.replace(CFG, num_tokens_range=(NUM_TOKENS, NUM_TOKENS))
    save_params_npz(path, {**tree, "_config_json": cfg.to_json()})
    runner = MoGeRunner(path, torch.device("cpu"))
    imgs = np.random.default_rng(4).integers(0, 256, (2, 3, 140, 140), dtype=np.uint8)
    single = [runner.infer_depth(im) for im in imgs]
    runner.shard_params(make_mesh(2, 1, devices=["cpu"] * 2))
    assert [m for _, m in runner._replicas] == [runner.model] * 2
    got = [d.numpy() for d in runner.infer_depth_batch_async(imgs)]
    for g, s in zip(got, single):
        np.testing.assert_array_equal(g, s)
    jrunner = JaxRunner(path)
    jrunner.shard_params(jax_make_mesh(2, 1))
    want = np.asarray(jrunner.infer_depth_batch_async(imgs))
    floats = imgs.astype(np.float32) / 255.0
    forward = jax.jit(lambda p, x: jm.moge_forward(p, x, JAX_CFG, NUM_TOKENS))
    for b in range(2):
        out = forward(_to_jax(tree), jnp.asarray(floats[b : b + 1]))
        _hold_depth(got[b], want[b], floats[b], out, runner.model, NUM_TOKENS)


def test_port_written_npz_reads_back_in_jax(tree, tmp_path, image):
    """save_params_npz of the port's tree is a checkpoint the JAX package
    loads (load_params_npz + MoGeConfig.from_params) and the port's runner
    runs."""
    path = str(tmp_path / "moge.npz")
    save_params_npz(path, tree)
    back = jax_load_params_npz(path)
    assert jm.MoGeConfig.from_params(back) == JAX_CFG
    assert back["neck"]["input_blocks"][0] is not None and back["neck"]["output_blocks"][0] is None
    for a, b in zip(jax.tree.leaves(_to_jax(back)), jax.tree.leaves(_to_jax(tree))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ported, cfg = load_moge_checkpoint(path)
    assert cfg == CFG and "_config_json" not in ported
    runner = MoGeRunner(path, torch.device("cpu"))
    depth = runner.infer_depth((image[0] * 255).astype(np.uint8))
    assert depth.shape == (140, 140) and depth.dtype == np.float32
    with pytest.raises(FileNotFoundError, match="MoGe checkpoint not provided"):
        MoGeRunner(None, torch.device("cpu"))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_runner_builds_an_fp32_trunk_on_every_device(tree, tmp_path, monkeypatch, device):
    """MoGeRunner computes in fp32 as the JAX runner does
    (compute_dtype=jnp.float32): on the GPU its encoder blocks take the
    kernels' fp32 entries, not a bf16 trunk. The model builder is replaced
    here, so the CUDA case needs no GPU."""
    import pi3_slam_tpu_torch.models.moge as runner_module

    path = str(tmp_path / "moge.npz")
    save_params_npz(path, tree)
    built = []
    monkeypatch.setattr(runner_module, "build_moge",
                        lambda cfg, state, dev, trunk: built.append((dev.type, trunk)))
    MoGeRunner(path, torch.device(device))
    assert built == [(device, torch.float32)]
