"""The port's chunk creator CLI against the JAX package's, on the CPU.

Both CLIs run on the same 8 synthetic PNGs with one tiny Pi3 checkpoint
written by the JAX package's ``save_pi3_checkpoint``, with
``--device cpu --compute-dtype float32``. Windows of 5 with overlap 2 give
chunks of 5, 5 and 2 frames. Their ``chunk_*.npz`` files are compared key by
key, with ``--no-pad-tail`` (the 2-frame tail runs unpadded on both sides)
for grid keypoints, grid keypoints with ``--save-dense``, and dense-only
``--keypoints none`` chunks (all ``--no-metric-depth``), and for grid
keypoints with MoGe-2 metric scale from one tiny random MoGe npz (written by
the port's ``save_params_npz``, read by both); and with the default tail
handling for grid keypoints: the tail is padded to 5 frames by repeating its
last frame, the padded frames take part in the global attention, and the
stored tail holds its 2 real frames.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

import create_offline_chunks as jax_cli
from pi3_slam_tpu.models import pi3 as jax_pi3
from pi3_slam_tpu.models.convert import save_pi3_checkpoint
from pi3_slam_tpu_torch import create_offline_chunks as torch_cli
from pi3_slam_tpu_torch.models.convert import init_pi3_params
from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
from pi3_slam_tpu_torch.models.pi3 import Pi3Config

# head dim 64 on every attention, as the GPU kernels require
CFG = Pi3Config(
    encoder=DinoV2Config(embed_dim=128, depth=2, num_heads=2, pos_embed_size=6),
    dec_embed_dim=128, dec_num_heads=2, dec_depth=4, head_dim=128, head_depth=1,
    head_num_heads=2, camera_dim=32,
)


MODES = {
    "grid": ["--no-pad-tail", "--no-metric-depth"],
    # strided dense maps beside the sparse tracks
    "grid+dense": ["--no-pad-tail", "--no-metric-depth", "--save-dense"],
    # full-resolution dense maps only
    "dense": ["--no-pad-tail", "--no-metric-depth", "--keypoints", "none"],
    # MoGe-2 metric scale (the npz path is appended)
    "grid+metric": ["--no-pad-tail", "--moge-path"],
    # the default tail handling: the 2-frame tail padded to 5 on both sides
    "grid+padded-tail": ["--no-metric-depth"],
}


def _tiny_moge_npz(path):
    """MoGe-2 with the ViT-S backbone, the widths of tests/test_moge_parity.py
    and 100 tokens (an 8 x 11 token grid at 42 x 56)."""
    from pi3_slam_tpu_torch.models.convert import init_moge_params, moge_vits_config, save_params_npz

    save_params_npz(path, init_moge_params(3, moge_vits_config(num_tokens_range=(100, 100))))
    return path


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("chunks")
    rng = np.random.default_rng(0)
    frames = root / "frames"
    frames.mkdir()
    for i in range(8):
        img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(frames / f"f_{i:03d}.png")
    tree = init_pi3_params(1, CFG)
    # perturb every leaf so norms, biases and LayerScales all matter
    tree = jax_pi3.jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), tree
    )
    mode = MODES[request.param]
    if request.param == "grid+padded-tail":
        # the global blocks' LayerScale at 1, so the global attention, where
        # the padded frames act, moves the tail beyond the tolerances below
        # (at the init's 0.01 padding moves its poses by ~7e-6 only)
        tree["decoder"]["odd_blocks"]["ls1"][:] = 1.0
    if mode[-1] == "--moge-path":
        mode = mode + [_tiny_moge_npz(str(root / "moge_tiny.npz"))]
        # a random Pi3 depth map is all depth edges, and then no pixel of frame
        # 0 is valid: a constant depth exp(0.5) and a high confidence leave
        # every pixel valid, so the metric scale is the median of MoGe's depth
        # over exp(0.5) (the channel-major z columns of the point head)
        p2 = CFG.patch_size**2
        tree["point_head"]["kernel"][:, 2 * p2:] = 0.0
        tree["point_head"]["bias"][2 * p2:] = 0.5
        tree["conf_head"]["bias"][:] += 4.0
    ckpt = str(root / "pi3_tiny.npz")
    save_pi3_checkpoint(ckpt, tree, jax_pi3.Pi3Config.from_json(CFG.to_json()))
    common = ["--images", str(frames), "--model-path", ckpt, "--chunk-length", "5",
              "--overlap", "2", "--max-kp", "20", "--pixel-limit", "2000",
              "--device", "cpu", "--compute-dtype", "float32",
              "--num-workers", "1"] + mode
    out_j, out_t = str(root / "jax"), str(root / "torch")
    assert jax_cli.main(common + ["--output", out_j]) == 0
    assert torch_cli.main(common + ["--output", out_t]) == 0
    return out_j, out_t


def _load(out):
    with open(os.path.join(out, "chunks_manifest.json")) as f:
        manifest = json.load(f)
    chunks = []
    for entry in manifest:
        with np.load(os.path.join(out, "chunks", entry["file"])) as z:
            chunks.append({k: z[k] for k in z.files})
    return manifest, chunks


def test_manifests_and_metadata_match(runs):
    out_j, out_t = runs
    man_j, _ = _load(out_j)
    man_t, _ = _load(out_t)
    assert man_t == man_j
    assert [m["num_frames"] for m in man_t] == [5, 5, 2]  # the tail's real frames, padded or not
    for name in ("chunk_metadata.json",):
        with open(os.path.join(out_j, name)) as a, open(os.path.join(out_t, name)) as b:
            assert json.load(a) == json.load(b)


# fp32 forward on both sides; stored as float16 (one fp16 ulp = 2^-11 rel)
FLOAT_TOL = {
    "points": dict(rtol=2e-3, atol=1e-3),
    "local_points": dict(rtol=2e-3, atol=1e-3),
    "conf": dict(rtol=2e-3, atol=1e-3),
    # the metric scale moves points and translations (fp32 MoGe on both sides,
    # median of per-pixel depth ratios)
    "metric_scale": dict(rtol=1e-4, atol=0),
    "camera_poses": dict(rtol=1e-5, atol=1e-5),
    "camera_poses_cw": dict(rtol=1e-5, atol=1e-5),
    "local_points_dense": dict(rtol=2e-3, atol=1e-3),
    "conf_dense": dict(rtol=2e-3, atol=1e-3),
}


def _check_intrinsics(a, b):
    """cx, cy and the fixed entries exactly. fx, fy come from a damped
    Gauss-Newton focal solve that is ill-posed on the random tiny model's
    geometry (focals of either sign, |f| from 1e-4 to 1e3 here), where 1e-7
    input differences flip accepted steps; they are checked only for shape
    and finiteness here, and the solver is held to the JAX one on well-posed
    pointmaps in tests/test_torch_ops.py."""
    fixed = np.ones(a.shape[1:], bool)
    fixed[0, 0] = fixed[1, 1] = False
    np.testing.assert_array_equal(b[:, fixed], a[:, fixed])
    assert np.isfinite(b).all()


@pytest.mark.parametrize("chunk", [0, 1, 2])
def test_chunk_files_match_key_by_key(runs, chunk):
    out_j, out_t = runs
    cj = _load(out_j)[1][chunk]
    ct = _load(out_t)[1][chunk]
    assert set(ct) == set(cj)
    for key in sorted(cj):
        a, b = cj[key], ct[key]
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if key == "intrinsics":
            _check_intrinsics(a, b)
        elif key in FLOAT_TOL:
            np.testing.assert_allclose(
                b.astype(np.float64), a.astype(np.float64), err_msg=key, **FLOAT_TOL[key]
            )
        elif key == "colors":  # uint8 of bilinear fp32 samples: rounding may differ by 1
            assert np.abs(b.astype(int) - a.astype(int)).max() <= 1
        else:  # masks, keypoints, paths, sizes, indices, rgb, strides
            np.testing.assert_array_equal(b, a, err_msg=key)


def test_metric_scale_stored_exactly_with_moge(runs, request):
    """With --moge-path every chunk of both CLIs carries a finite
    metric_scale (the key-by-key comparison holds the values to each other);
    with --no-metric-depth none does."""
    metric = "--moge-path" in MODES[request.node.callspec.params["runs"]]
    for out in runs:
        for chunk in _load(out)[1]:
            assert ("metric_scale" in chunk) == metric
            if metric:
                assert np.isfinite(chunk["metric_scale"]) and chunk["metric_scale"] > 0


@pytest.mark.parametrize("name", ["bfloat16", "float32", "float16"])
def test_compute_dtype_is_not_refused_on_the_card(name):
    """--compute-dtype float32 runs on the GPU (the kernels' fp32 entries),
    as the JAX creator computes it on its device; the creator's check is the
    same on every device and refuses only names without an entry."""
    import torch

    from pi3_slam_tpu_torch.slam.chunk_creator import compute_dtype

    if name == "float16":
        with pytest.raises(ValueError):
            compute_dtype(name)
    else:
        assert compute_dtype(name) == getattr(torch, name)
