"""The port's chunk-creation CLI: the same options as the JAX package's
``create_offline_chunks.py``, the parallel flags clamped to the one device
of ``--device cpu``, no quiet CPU fallback for ``--device cuda``,
the JAX creator's contract for a missing MoGe checkpoint (a message, no
metric scale) and an error for a bad one, and ``--global-kv-merge``.
"""

import os

import pytest
import torch

import create_offline_chunks as jax_cli
from pi3_slam_tpu_torch import create_offline_chunks as torch_cli
from pi3_slam_tpu_torch.device import select_device


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    assert ours.pop("model") == "pi3"  # the port's --model (pi3 or vggt); the JAX CLI runs Pi3
    jax_args.pop("device")
    assert ours == jax_args


@pytest.mark.parametrize(
    "flag", ["--data-parallel-chunks", "--tensor-parallel", "--sequence-parallel"])
def test_parallel_flags_clamp_to_one_cpu_device(tmp_path, capsys, flag):
    """--device cpu lays the mesh over one device: each parallel flag at 2 is
    clamped to the single-device path, as the JAX CLI clamps it on one chip,
    and writes the same chunk files, bit for bit, as a run without it."""
    import numpy as np

    args = _tiny_checkpoint_and_frames(tmp_path)
    out = args.index("--output") + 1
    base = list(args)
    base[out] = str(tmp_path / "base")
    assert torch_cli.main(base) == 0
    assert torch_cli.main(args + [flag, "2"]) == 0
    assert "device mesh" not in capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "base" / "chunks"))
    assert names == sorted(os.listdir(tmp_path / "out" / "chunks")) and len(names) == 3
    for name in names:
        with np.load(tmp_path / "base" / "chunks" / name) as a, \
                np.load(tmp_path / "out" / "chunks" / name) as b:
            assert a.files == b.files
            for key in a.files:
                np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_cuda_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_device("cuda")
    assert select_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _tiny_checkpoint_and_frames(tmp_path, metric_depth=False):
    """A tiny random Pi3 checkpoint and six 28x28 frames (CLI arguments with
    --no-metric-depth unless ``metric_depth``)."""
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
            "--chunk-length", "3", "--overlap", "1", "--pixel-limit", "800", "--device", "cpu"
            ] + ([] if metric_depth else ["--no-metric-depth"])


def test_profile_dir_traces_chunk_one_on_cpu(tmp_path):
    """--profile-dir writes a torch.profiler trace and summary of chunk 1."""
    prof = tmp_path / "prof"
    rc = torch_cli.main(_tiny_checkpoint_and_frames(tmp_path) + ["--profile-dir", str(prof)])
    assert rc == 0
    assert (prof / "chunk_trace.json").stat().st_size > 0
    assert "Self CPU" in (prof / "summary.txt").read_text()
    assert len(list((tmp_path / "out" / "chunks").glob("chunk_*.npz"))) == 3


def test_device_timeline_takes_the_union_of_device_intervals(tmp_path):
    """Busy time counts overlapping kernels once; host events widen the
    window but are not busy."""
    import json

    from pi3_slam_tpu_torch.slam.chunk_creator import device_timeline

    events = [
        {"ph": "X", "cat": "cpu_op", "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "ts": 100.0, "dur": 300.0},
        {"ph": "X", "cat": "kernel", "ts": 200.0, "dur": 300.0},  # overlaps the first
        {"ph": "X", "cat": "gpu_memcpy", "ts": 600.0, "dur": 100.0},
        {"ph": "i", "cat": "instant", "ts": 5000.0},  # no duration: not timed
    ]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    t = device_timeline(str(trace))
    assert t["window_ms"] == pytest.approx(1.0)
    assert t["busy_ms"] == pytest.approx(0.5)
    assert t["idle_share"] == pytest.approx(0.5)


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
        assert r["metric_scale"] is None  # --no-metric-depth
    resumed = torch_cli.create_chunks(argv + ["--resume"])
    assert [set(r) for r in resumed] == [{"path", "num_frames"}] * 3


def test_no_images_exits_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        torch_cli.main(["--images", str(tmp_path), "--output", str(tmp_path / "out"),
                        "--no-metric-depth", "--device", "cpu"])
    assert exc.value.code == 2
    assert "no images found" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [[], ["--metric-depth"]])  # --metric-depth is the default
def test_metric_depth_without_moge_path_continues(tmp_path, capsys, flags):
    """The JAX creator's contract for a checkpoint that was not given: its
    message, then chunks without metric_scale."""
    import numpy as np

    records = torch_cli.create_chunks(_tiny_checkpoint_and_frames(tmp_path, True) + flags)
    out = capsys.readouterr().out
    assert ("MoGe unavailable (MoGe checkpoint not provided (convert with "
            "tools/convert_checkpoint.py --model moge); pipeline continues without metric "
            "depth); continuing without metric depth") in out
    assert len(records) == 3
    for r in records:
        assert r["metric_scale"] is None
        with np.load(r["path"]) as z:
            assert "metric_scale" not in z.files and "points" in z.files


@pytest.mark.parametrize("kind", ["corrupt", "absent"])
def test_bad_moge_path_raises(tmp_path, kind):
    """A given --moge-path that cannot be read raises: only a checkpoint
    that was not given is skipped."""
    moge = tmp_path / "moge.npz"
    if kind == "corrupt":
        moge.write_bytes(b"not an npz file")
    argv = _tiny_checkpoint_and_frames(tmp_path, True) + ["--moge-path", str(moge)]
    with pytest.raises((OSError, ValueError)):
        torch_cli.create_chunks(argv)
    assert not list((tmp_path / "out" / "chunks").glob("chunk_*.npz"))


def test_global_kv_merge_writes_chunks(tmp_path, monkeypatch):
    """--global-kv-merge 2 reaches the model (Pi3Config.global_kv_merge):
    3-frame chunks run exact, the 2-frame tail merged."""
    from pi3_slam_tpu_torch.slam.chunk_creator import OfflineChunkCreator

    seen = []
    orig = OfflineChunkCreator.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append(self.model.cfg.global_kv_merge)

    monkeypatch.setattr(OfflineChunkCreator, "__init__", init)
    records = torch_cli.create_chunks(_tiny_checkpoint_and_frames(tmp_path) + ["--global-kv-merge", "2"])
    assert seen == [2]
    assert [r["num_frames"] for r in records] == [3, 3, 2]
    assert all(os.path.exists(r["path"]) for r in records)
