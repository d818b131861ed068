"""The port's chunk-creation CLI: the same options as the JAX package's
``create_offline_chunks.py``, a clear non-zero exit for every flag that
names a part not ported yet, and no quiet CPU fallback for ``--device cuda``.
"""

import os

import pytest
import torch

import create_offline_chunks as jax_cli
from pi3_slam_tpu_torch import create_offline_chunks as torch_cli
from pi3_slam_tpu_torch.device import select_device


def _option_strings(parser):
    return {s for action in parser._actions for s in action.option_strings}


def test_parser_has_every_jax_option():
    jax_opts = _option_strings(jax_cli.build_parser())
    ours = _option_strings(torch_cli.build_parser())
    assert jax_opts <= ours, sorted(jax_opts - ours)


def test_defaults_match_except_device():
    jax_args = vars(jax_cli.build_parser().parse_args(["--images", "x"]))
    ours = vars(torch_cli.build_parser().parse_args(["--images", "x"]))
    assert ours.pop("device") == "cuda"
    jax_args.pop("device")
    assert ours == jax_args


@pytest.mark.parametrize(
    "flags,entry",
    [
        ([], "MoGe-2"),  # --metric-depth is the default
        (["--metric-depth"], "MoGe-2"),
        (["--no-metric-depth", "--keypoints", "aliked"], "ALIKED"),
        (["--no-metric-depth", "--refine-observations"], "ZNCC"),
        (["--no-metric-depth", "--global-kv-merge", "2"], "kv-merge"),
        (["--no-metric-depth", "--data-parallel-chunks", "2"], "multi-device"),
        (["--no-metric-depth", "--tensor-parallel", "2"], "multi-device"),
        (["--no-metric-depth", "--sequence-parallel", "2"], "multi-device"),
    ],
)
def test_unported_flags_exit_nonzero(tmp_path, capsys, flags, entry):
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["--images", str(tmp_path), "--output", str(tmp_path / "out")] + flags)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "not yet ported" in err and "ROADMAP.md" in err and entry in err
    assert not (tmp_path / "out").exists()


def test_cuda_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device("cuda")
    assert select_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _tiny_checkpoint_and_frames(tmp_path):
    """A tiny random Pi3 checkpoint and six 28x28 frames."""
    import numpy as np
    from PIL import Image

    from pi3_slam_tpu.models import pi3 as jax_pi3
    from pi3_slam_tpu.models.convert import save_pi3_checkpoint
    from pi3_slam_tpu_torch.models.convert import init_pi3_params
    from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config

    cfg = Pi3Config(
        encoder=DinoV2Config(embed_dim=128, depth=1, num_heads=2, pos_embed_size=4),
        dec_embed_dim=128, dec_num_heads=2, dec_depth=2, head_dim=128, head_depth=1,
        head_num_heads=2, camera_dim=16,
    )
    ckpt = str(tmp_path / "pi3.npz")
    save_pi3_checkpoint(ckpt, init_pi3_params(0, cfg), jax_pi3.Pi3Config.from_json(cfg.to_json()))
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (28, 28, 3), dtype=np.uint8)).save(frames / f"{i}.png")
    return ["--images", str(frames), "--model-path", ckpt, "--output", str(tmp_path / "out"),
            "--chunk-length", "3", "--overlap", "1", "--pixel-limit", "800", "--no-metric-depth",
            "--device", "cpu"]


def test_profile_dir_traces_chunk_one_on_cpu(tmp_path):
    """--profile-dir writes a torch.profiler trace and summary of chunk 1."""
    prof = tmp_path / "prof"
    rc = torch_cli.main(_tiny_checkpoint_and_frames(tmp_path) + ["--profile-dir", str(prof)])
    assert rc == 0
    assert (prof / "chunk_trace.json").stat().st_size > 0
    assert "Self CPU" in (prof / "summary.txt").read_text()
    assert len(list((tmp_path / "out" / "chunks").glob("chunk_*.npz"))) == 3


def test_create_chunks_returns_per_chunk_records(tmp_path):
    """One record per chunk (path, frames, time, frames/s, kernel launches);
    a resumed chunk has no timing. No kernel runs on the CPU."""
    argv = _tiny_checkpoint_and_frames(tmp_path)
    records = torch_cli.create_chunks(argv)
    assert [r["num_frames"] for r in records] == [3, 3, 2]
    for r in records:
        assert r["path"].endswith(".npz") and os.path.exists(r["path"])
        assert r["fps"] == pytest.approx(r["num_frames"] / r["infer_s"])
        assert set(r["launches"].values()) == {0}
    resumed = torch_cli.create_chunks(argv + ["--resume"])
    assert [set(r) for r in resumed] == [{"path", "num_frames"}] * 3


def test_no_images_exits_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["--images", str(tmp_path), "--output", str(tmp_path / "out"),
                        "--no-metric-depth", "--device", "cpu"])
    assert exc.value.code == 2
    assert "no images found" in capsys.readouterr().err
