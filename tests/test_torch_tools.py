"""The port's repo-root tools (``pi3_slam_tpu_torch/tools``) against the JAX
package's ``tools/*.py`` on the CPU.

* ``synthetic``: the same ``.npz`` arrays as
  ``tests/test_system_ape.write_synthetic_chunks`` for the same seed.
* ``import_reference_chunks``: the package's ``.pt`` fabricator writes the
  fixture's files; both tools on one reference ``.pt`` directory give the
  same files, then the port's reconstructor on the port's output the JAX
  reconstructor's poses on the JAX output.
* ``perf_online_floor`` and ``ablate_observation_fan``: one run of each
  package on the same scene.
* Every device tool refuses to run without a GPU unless told ``--device cpu``.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from pi3_slam_tpu_torch.tools import (ablate_observation_fan, import_reference_chunks,
                                      kv_merge_drift, perf_online_floor, perf_pipeline,
                                      smoke_e2e, synthetic)
from test_import_reference_chunks import reference_chunk_dir  # noqa: F401  (fixture)

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


def _jax_tool(name):
    """A repo-root tools/<name>.py module of the JAX package."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_main(module, argv):
    """A JAX tool's main() under ``argv``; its last stdout line as JSON."""
    old, sys.argv = sys.argv, ["tool", *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            module.main()
    finally:
        sys.argv = old
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --- the synthetic scene -------------------------------------------------

SCENES = {
    "quick": {},
    "outliers": dict(n_frames=30, n_landmarks=800, chunk_length=10, overlap=3, n_kp=40,
                     noise_px=0.4, step=0.08, yaw_rate=0.0007, conf_outliers=True,
                     frame_name_fn=lambda i: f"{1_600_000_000_000 + 100 * i:013d}.png"),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_synthetic_chunks_match_the_jax_generator(scene, tmp_path):
    from test_system_ape import write_synthetic_chunks

    kw = SCENES[scene]
    want = write_synthetic_chunks(tmp_path / "jax", np.random.default_rng(3), **kw)
    got = synthetic.write_synthetic_chunks(str(tmp_path / "torch"), np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(got, want)
    names = sorted(os.listdir(tmp_path / "jax" / "chunks"))
    assert names == sorted(os.listdir(tmp_path / "torch" / "chunks")) and len(names) >= 3
    for name in names:
        a, b = _npz(tmp_path / "jax" / "chunks" / name), _npz(tmp_path / "torch" / "chunks" / name)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name}:{k}")
    meta = [json.loads((tmp_path / side / "chunk_metadata.json").read_text())
            for side in ("jax", "torch")]
    assert meta[0] == meta[1]


# --- import_reference_chunks ----------------------------------------------

def test_reference_pt_chunks_are_the_fixtures_files(reference_chunk_dir, tmp_path):  # noqa: F811
    """The package's fabricator (chip_smoke.py phase 13 (d)) writes the
    fixture's files byte for byte."""
    out = str(tmp_path / "fabricated")
    synthetic.write_reference_pt_chunks(out)
    names = sorted(os.path.relpath(os.path.join(d, f), reference_chunk_dir)
                   for d, _, files in os.walk(reference_chunk_dir) for f in files)
    assert names == ["chunk_metadata.json", "chunks/chunk_000000.pt", "chunks/chunk_000001.pt",
                     "chunks_manifest.json"]
    for name in names:
        with open(os.path.join(reference_chunk_dir, name), "rb") as a, \
                open(os.path.join(out, name), "rb") as b:
            assert a.read() == b.read(), name
    assert sorted(os.listdir(out)) == sorted(os.listdir(reference_chunk_dir))


def test_import_reference_chunks_matches_jax_and_reconstructs(reference_chunk_dir, tmp_path,  # noqa: F811
                                                              capsys):
    from pi3_slam_tpu.io import read_tum_trajectory as jax_read_tum
    from pi3_slam_tpu.slam import OfflineReconstructor, ReconstructorConfig
    from pi3_slam_tpu_torch.io.tum import read_tum_trajectory
    from pi3_slam_tpu_torch.reconstruct_offline import reconstruct

    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert _jax_tool("import_reference_chunks").main([reference_chunk_dir, out_j]) == 0
    capsys.readouterr()
    assert import_reference_chunks.main([reference_chunk_dir, out_t]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == (f"done -> {out_t} (reconstruct with: python -m "
                    f"pi3_slam_tpu_torch.reconstruct_offline --chunks {out_t})")
    names = sorted(os.listdir(os.path.join(out_j, "chunks")))
    assert names == sorted(os.listdir(os.path.join(out_t, "chunks"))) == [
        "chunk_000000.npz", "chunk_000001.npz"]
    for name in names:
        a, b = (_npz(os.path.join(out, "chunks", name)) for out in (out_j, out_t))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for meta in ("chunks_manifest.json", "chunk_metadata.json"):
        with open(os.path.join(out_j, meta)) as fa, open(os.path.join(out_t, meta)) as fb:
            assert json.load(fa) == json.load(fb)

    # the port's reconstructor CLI (python -m pi3_slam_tpu_torch.reconstruct_offline) on the
    # port's import, as the JAX test runs its reconstructor: 4 + 4 - 2 shared frames
    res = reconstruct(["--chunks", out_t, "--output", str(tmp_path / "rec_t"), "--device", "cpu",
                       "--ba-iterations", "2"])
    assert len(res["reconstructions"]) == 2
    got = read_tum_trajectory(res["artifacts"]["trajectory"])["positions"]
    assert got.shape == (6, 3) and np.isfinite(got).all()

    # Against the JAX reconstructor on the JAX import. The fixture's points are
    # random, not on the keypoints' rays: a second LM step on chunk 0 (cost
    # ~5e3) parts the two packages' centres by 1.1e-3 m, and after pruning one
    # track or none survives a chunk, so the alignment's refine BA (50 steps
    # under two camera priors) is underdetermined and rounding decides its
    # poses (0.15 m apart). One BA step and the alignment without its refine
    # are determined: there the poses agree.
    from pi3_slam_tpu_torch.slam.config import ReconstructorConfig as TorchConfig
    from pi3_slam_tpu_torch.slam.offline_reconstructor import OfflineReconstructor as TorchRec

    want = OfflineReconstructor(ReconstructorConfig(
        chunk_dir=out_j, output_dir=str(tmp_path / "rec_j"), ba_iterations=1,
        align_refine=False)).run()
    got = TorchRec(TorchConfig(chunk_dir=out_t, output_dir=str(tmp_path / "rec_t1"),
                               ba_iterations=1, align_refine=False, device="cpu")).run()
    assert [a.method for a in got["alignment"]] == [a.method for a in want["alignment"]]
    want = jax_read_tum(want["artifacts"]["trajectory"])["positions"]
    got = read_tum_trajectory(got["artifacts"]["trajectory"])["positions"]
    assert got.shape == want.shape == (6, 3)
    np.testing.assert_allclose(got, want, atol=1e-3)


# --- perf_online_floor and ablate_observation_fan ------------------------------

def test_perf_online_floor_matches_jax():
    argv = ["--chunks", "3", "--frames-per", "8", "--kp", "32", "--overlap", "2"]
    want = _run_jax_main(_jax_tool("perf_online_floor"), argv)
    got = perf_online_floor.run(argv + ["--device", "cpu"])
    assert got.keys() == want.keys()
    assert got["new_frames_per_chunk"] == want["new_frames_per_chunk"] == 6
    assert len(got["recon_s_per_chunk"]) == len(want["recon_s_per_chunk"]) == 4
    assert len(got["align_s_per_chunk"]) == 3
    # A solve either runs all 10 iterations in both packages or stops early
    # in both. Where it stops early, the relative cost decrease has reached
    # float32 rounding of the cost (chunk 2: 6.5e-8, one ulp of a cost of
    # ~938, against ftol 1e-6), so the stopping step can differ by more than
    # one; the final costs agree within 1.3e-7.
    full = [i == 10 for i in want["ba_iterations"]]
    assert [i == 10 for i in got["ba_iterations"]] == full, (got, want)
    assert any(full) and not all(full)


def test_ablate_observation_fan_matches_jax():
    want = _run_jax_main(_jax_tool("ablate_observation_fan"), ["--quick", "--seeds", "0"])
    got = ablate_observation_fan.run(["--quick", "--seeds", "0", "--device", "cpu"])
    assert [r.keys() for r in got] == [r.keys() for r in want]
    for g, w in zip(got, want):
        assert (g["fan"], g["seed"], g["alignments_ok"]) == (w["fan"], w["seed"], w["alignments_ok"])
        assert g["alignments_ok"] == "3/3"
        assert abs(g["ape_rmse_m"] - w["ape_rmse_m"]) < 1e-3, (g, w)


# --- no GPU, no run --------------------------------------------------------------

@pytest.mark.parametrize("tool", [perf_pipeline, perf_online_floor, smoke_e2e, kv_merge_drift,
                                  ablate_observation_fan],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_every_device_tool_needs_a_gpu(tool, monkeypatch, tmp_path):
    """Without a CUDA device the default --device cuda raises before any work
    (no frames, weights or chunks written), through the entry point; there is
    no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    argv = ["--workdir", str(tmp_path / "work")] if tool in (perf_pipeline, smoke_e2e) else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
    assert not os.path.exists(tmp_path / "work")
