"""The port's pipeline tools on the CPU: ``perf_pipeline`` (offline and
``--online``) at a tiny width against the JAX tool's frames and JSON keys and
the port's creator CLI's chunk files, and ``smoke_e2e`` end to end.

``perf_pipeline`` runs the head-dim-64 tiny config of
``tests/test_torch_chunk_creator.py`` (random weights from seed 0) on 9
frames in windows of 5 with overlap 2 (three chunks, the last a padded tail
of 3); the creator CLI is given the same weights as a checkpoint.
``smoke_e2e`` runs grid keypoints without the refinement, its weights a tiny
checkpoint; both CLIs read its embedded config.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pi3_slam_tpu_torch.models.convert import init_pi3_params, save_pi3_checkpoint
from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
from pi3_slam_tpu_torch.models.pi3 import Pi3Config
from pi3_slam_tpu_torch.tools import perf_pipeline, smoke_e2e

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

# head dim 64 on every attention, as the GPU kernels require
CFG = Pi3Config(
    encoder=DinoV2Config(embed_dim=128, depth=2, num_heads=2, pos_embed_size=6),
    dec_embed_dim=128, dec_num_heads=2, dec_depth=4, head_dim=128, head_depth=1,
    head_num_heads=2, camera_dim=32,
)

COMMON = ["--frames", "9", "--chunk-length", "5", "--overlap", "2", "--pixel-limit", "1000",
          "--device", "cpu"]


def _jax_json_keys():
    """The keys of each dict the JAX tools/perf_pipeline.py prints (json.dumps
    of a dict literal), read from its source: [offline keys, online keys]."""
    path = os.path.join(REPO, "tools", "perf_pipeline.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            keys = [k.value for k in node.args[0].keys]
            found[keys[0] if keys[0] != "metric" else node.args[0].values[0].value] = keys
    return found["steady_state_chunk_creation_fps"], found["steady_state_online_fps"]


def test_make_frames_are_the_jax_tools_bytes(tmp_path):
    spec = importlib.util.spec_from_file_location("jax_perf_pipeline",
                                                  os.path.join(REPO, "tools", "perf_pipeline.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    want = jax_tool.make_frames(str(tmp_path / "jax"), 4, 24, 40)
    got = perf_pipeline.make_frames(str(tmp_path / "torch"), 4, 24, 40)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for a, b in zip(want, got):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # frames that exist are kept, not written again
    os.utime(got[0], (0, 0))
    perf_pipeline.make_frames(str(tmp_path / "torch"), 4, 24, 40)
    assert os.stat(got[0]).st_mtime == 0


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The offline run, then the online run on its workdir, recording the
    thread of every online stamp."""
    import threading

    from pi3_slam_tpu_torch.slam.online import Pi3SLAMOnline

    work = str(tmp_path_factory.mktemp("perf_pipeline"))
    offline = perf_pipeline.run(["--workdir", work] + COMMON, pi3_config=CFG)
    threads = []
    orig = Pi3SLAMOnline._consume_finish

    def spy(self, ctx):
        threads.append(threading.current_thread().name)
        return orig(self, ctx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Pi3SLAMOnline, "_consume_finish", spy)
        online = perf_pipeline.run(["--workdir", work, "--online"] + COMMON, pi3_config=CFG)
    return work, offline, online, threads


def test_perf_pipeline_offline_line_and_chunks(pipeline, tmp_path):
    from pi3_slam_tpu_torch.create_offline_chunks import create_chunks

    work, offline, _, _ = pipeline
    assert list(offline) == _jax_json_keys()[0]
    assert offline["metric"] == "steady_state_chunk_creation_fps"
    rates = offline["per_chunk_fps"]
    assert len(rates) == 2 and all(r > 0 for r in rates)  # three chunks, the first has no interval
    assert offline["value"] == sorted(rates)[len(rates) // 2]
    assert offline["forward_only_fps"] == perf_pipeline.FORWARD_FPS
    assert offline["pipeline_vs_forward"] == round(offline["value"] / perf_pipeline.FORWARD_FPS, 3)
    assert offline["chunk_compression"] == "default"

    # the creator CLI on the same frames with the same weights and settings
    ckpt = str(tmp_path / "pi3_tiny.npz")
    save_pi3_checkpoint(ckpt, init_pi3_params(0, CFG), CFG)
    out = str(tmp_path / "cli")
    create_chunks(["--images", os.path.join(work, "frames"), "--model-path", ckpt, "--output", out,
                   "--chunk-length", "5", "--overlap", "2", "--pixel-limit", "1000", "--max-kp",
                   "400", "--no-metric-depth", "--device", "cpu", "--num-workers", "2"])
    tool = os.path.join(work, "chunks_out")
    for name in ("chunks_manifest.json", "chunk_metadata.json"):
        with open(os.path.join(tool, name)) as fa, open(os.path.join(out, name)) as fb:
            assert json.load(fa) == json.load(fb)
    names = sorted(os.listdir(os.path.join(tool, "chunks")))
    assert names == sorted(os.listdir(os.path.join(out, "chunks"))) and len(names) == 3
    for name in names:
        with np.load(os.path.join(tool, "chunks", name)) as a, \
                np.load(os.path.join(out, "chunks", name)) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


def test_perf_pipeline_online_line(pipeline):
    """The online line; in the pipelined mode every chunk is stamped once, on
    the consumer thread."""
    work, _, online, threads = pipeline
    assert list(online) == _jax_json_keys()[1]
    assert online["metric"] == "steady_state_online_fps"
    assert online["num_chunks"] == 3
    rates = online["per_chunk_fps"]
    assert len(rates) == 2 and all(r > 0 for r in rates)
    assert online["value"] == sorted(rates)[len(rates) // 2]
    assert online["overall_fps"] > 0
    assert online["pipeline_vs_forward"] == round(online["value"] / perf_pipeline.FORWARD_FPS, 3)
    assert threads == ["sfm-consumer"] * 3
    # the online run reused the offline run's frames
    assert len(os.listdir(os.path.join(work, "frames"))) == 9


def test_smoke_e2e_on_the_cpu(monkeypatch, tmp_path, capfd):
    """grid keypoints, no refinement, a tiny checkpoint: both CLIs run in
    processes of their own and every artifact check runs."""
    def tiny_weights(work, keypoints):
        path = os.path.join(work, "pi3_tiny.npz")
        save_pi3_checkpoint(path, init_pi3_params(0, CFG), CFG)
        return path, None

    monkeypatch.setattr(smoke_e2e, "save_random_weights", tiny_weights)
    # the CLIs' processes inherit one intra-op thread, as this module runs
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("MKL_NUM_THREADS", "1")
    work = str(tmp_path / "smoke")
    assert smoke_e2e.main(["--workdir", work, "--device", "cpu", "--keypoints", "grid",
                           "--skip-refine", "--frames", "13", "--pixel-limit", "6000"]) == 0
    out = capfd.readouterr().out
    assert "[smoke] OK create_offline_chunks" in out and "[smoke] OK reconstruct_offline" in out
    assert out.count("[smoke] OK artifact") == 9  # the manifest and eight reconstruction files
    assert "[smoke] OK 4 raycast previews" in out
    assert out.strip().splitlines()[-1] == f"[smoke] ALL STAGES PASSED (workdir {work})"
