"""The port's evaluation path on the CPU: the ground-truth tools
(``tools/make_7scenes_gt.py``, ``tools/make_euroc_gt.py``) against the JAX
package's, the eval tool (``tools/eval.py``) against the shell scripts'
steps and the JAX APE scorer, and whole runs of it on fabricated scenes.

The scenes are ``tools/smoke_eval_scripts.py``'s (as
``tests/test_eval_scripts.py`` runs the scripts on them), the checkpoint a
tiny Pi3 written by the port's ``save_pi3_checkpoint``. The GT files must be
byte-identical; the tool's APE is held to the JAX scorer's on the same
files within rtol 1e-4 (``tests/test_torch_reconstructor.py``'s bound).
"""

import os
import re
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import make_7scenes_gt as jax_7scenes_gt  # noqa: E402
import make_euroc_gt as jax_euroc_gt  # noqa: E402
import smoke_eval_scripts as sm  # noqa: E402
from test_pi3_model import TINY  # noqa: E402

from pi3_slam_tpu.utils import evaluation as jeval  # noqa: E402
from pi3_slam_tpu_torch.models.convert import init_pi3_params, save_pi3_checkpoint  # noqa: E402
from pi3_slam_tpu_torch.models.pi3 import Pi3Config  # noqa: E402
from pi3_slam_tpu_torch.tools import eval as eval_tool  # noqa: E402
from pi3_slam_tpu_torch.tools import make_7scenes_gt, make_euroc_gt  # noqa: E402

H, W = 120, 160
TINY_RUN = ["--chunk-length", "4", "--overlap", "2", "--max-kp", "16", "--device", "cpu"]
APE_LINE = re.compile(r"^(\S+) APE RMSE: ([0-9.eE+-]+|nan) m", re.M)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny checkpoint, two 7-Scenes scenes of 8 frames and a EuRoC MH_03
    of 408 frames (400 of them skipped) with its calibration."""
    root = tmp_path_factory.mktemp("eval_data")
    cfg = Pi3Config.from_json(TINY.to_json())
    ckpt = str(root / "pi3_tiny.npz")
    save_pi3_checkpoint(ckpt, init_pi3_params(0, cfg), cfg)
    sm.make_7scenes(str(root / "7scenes"), ["alpha", "beta"], 8, H, W)
    calib = sm.make_euroc(str(root / "euroc"), "MH_03", 408, H, W)
    return {"ckpt": ckpt, "7scenes": str(root / "7scenes"), "euroc": str(root / "euroc"),
            "calib": calib}


def test_7scenes_gt_is_byte_identical(data, tmp_path, capsys):
    seq = os.path.join(data["7scenes"], "alpha", "seq-01")
    assert jax_7scenes_gt.main([seq, str(tmp_path / "jax.txt")]) == 0
    jax_out = capsys.readouterr().out
    assert make_7scenes_gt.main([seq, str(tmp_path / "port.txt")]) == 0
    assert capsys.readouterr().out == jax_out.replace("jax.txt", "port.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--skip-start", "400"],
                                   ["--skip-start", "3", "--skip-end", "2", "--stride", "2"]],
                         ids=["all", "skip-400", "skip-end-stride"])
def test_euroc_gt_is_byte_identical(data, tmp_path, capsys, flags):
    mav0 = os.path.join(data["euroc"], "MH_03", "mav0")
    assert jax_euroc_gt.main([mav0, str(tmp_path / "jax.txt"), *flags]) == 0
    jax_out = capsys.readouterr().out
    assert make_euroc_gt.main([mav0, str(tmp_path / "port.txt"), *flags]) == 0
    assert capsys.readouterr().out == jax_out.replace("jax.txt", "port.txt")
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def _args(argv):
    return eval_tool.build_parser().parse_args(argv)


def test_7scenes_steps_are_the_scripts_flags():
    """eval_7scenes.sh:51-71 with MOGE_NPZ, KEYPOINTS=aliked ALIKED_NPZ, LOOP=1
    and REFINE=1 set, offline and MODE=online."""
    argv = ["7scenes", "D", "pi3.npz", "moge.npz", "OUT", "--chunk-length", "50", "--overlap", "5",
            "--max-kp", "300", "--max-obs", "7", "--keypoints", "aliked", "--aliked-npz", "a.npz",
            "--loop", "--refine", "--device", "cpu"]
    images = ["--images", "D/chess/seq-01/*.color.png", "--model-path", "pi3.npz",
              "--moge-path", "moge.npz", "--output", "OUT/chess"]
    assert eval_tool.steps_7scenes(_args(argv), "chess") == [
        ("create_offline_chunks", images + [
            "--resume", "--chunk-length", "50", "--overlap", "5", "--device", "cpu",
            "--keypoints", "aliked", "--aliked-path", "a.npz", "--max-kp", "300",
            "--refine-observations"]),
        ("reconstruct_offline", ["--chunks", "OUT/chess", "--loop-closure", "--device", "cpu",
                                 "--max-observations-per-track", "7"])]
    assert eval_tool.steps_7scenes(_args(argv + ["--mode", "online"]), "chess") == [
        ("pi3_slam_online", images + [
            "--chunk-length", "50", "--overlap", "5", "--keypoints", "aliked",
            "--aliked-path", "a.npz", "--max-kp", "300", "--refine-observations",
            "--loop-closure", "--max-observations-per-track", "7", "--device", "cpu",
            "--tum-integer-timestamps"])]


def test_7scenes_defaults_are_the_scripts():
    """eval_7scenes.sh's defaults: chunks of 100, overlap 20, 400 grid
    keypoints, 10 observations a track, no MoGe -> --no-metric-depth, the
    seven scenes, the card."""
    args = _args(["7scenes", "D", "pi3.npz"])
    assert args.scenes == ["chess", "fire", "heads", "office", "pumpkin", "redkitchen", "stairs"]
    assert args.out == "eval_7scenes_out" and args.mode == "offline"
    assert eval_tool.steps_7scenes(args, "fire") == [
        ("create_offline_chunks", [
            "--images", "D/fire/seq-01/*.color.png", "--model-path", "pi3.npz",
            "--no-metric-depth", "--output", "eval_7scenes_out/fire", "--resume",
            "--chunk-length", "100", "--overlap", "20", "--device", "cuda", "--keypoints", "grid",
            "--max-kp", "400"]),
        ("reconstruct_offline", ["--chunks", "eval_7scenes_out/fire", "--device", "cuda",
                                 "--max-observations-per-track", "10"])]


@pytest.mark.parametrize("seq,skip", [("MH_01", 700), ("MH_02", 600), ("MH_03", 400),
                                      ("V1_01", 0), ("V2_01", 0)])
def test_euroc_steps_are_the_scripts_flags(seq, skip):
    """eval_euroc.sh:44-56 and its start-frame skip table (:25-33)."""
    args = _args(["euroc", "E", "pi3.npz", "calib.json", "moge.npz", "OUT"])
    assert args.seqs == ["MH_01", "MH_02", "MH_03", "V1_01", "V1_02", "V2_01"]
    assert eval_tool.steps_euroc(args, seq) == [
        ("create_offline_chunks", [
            "--images", f"E/{seq}/mav0/cam0/data", "--resume", "--model-path", "pi3.npz",
            "--moge-path", "moge.npz", "--cam-dist-path", "calib.json", "--skip-start", str(skip),
            "--output", f"OUT/{seq}", "--chunk-length", "100", "--overlap", "20",
            "--device", "cuda", "--keypoints", "grid", "--max-kp", "400"]),
        ("reconstruct_offline", ["--chunks", f"OUT/{seq}", "--max-observations-per-track", "10",
                                 "--use-inverse-depth", "--device", "cuda"])]


def _ape_lines(out):
    return {name: float(v) for name, v in APE_LINE.findall(out)}


def _held_to_jax(result, n_poses):
    """The tool's APE against the JAX scorer on the same two files."""
    traj = os.path.join(os.path.dirname(result["gt"]), "trajectory_tum.txt")
    want = jeval.evaluate_tum_files(result["gt"], traj, align_sim3=True, max_diff=0.5)
    np.testing.assert_allclose(result["rmse"], want.rmse, rtol=1e-4)
    assert result["pairs"] == want.num_pairs == n_poses
    assert np.isfinite(result["rmse"])


@pytest.mark.parametrize("mode", ["offline", "online"])
def test_7scenes_run_on_the_cpu(data, tmp_path, capsys, mode):
    out = str(tmp_path / "out")
    results = eval_tool.run(["7scenes", data["7scenes"], data["ckpt"], "", out, "--scenes", "alpha",
                          "beta", "--mode", mode, "--max-obs", "4", *TINY_RUN])
    printed = capsys.readouterr().out
    apes = _ape_lines(printed)
    assert sorted(apes) == ["alpha", "beta"] and all(np.isfinite(list(apes.values())))
    mean = re.search(r"^mean\s+([0-9.]+) m  \(reference: 0\.069 m\)$", printed, re.M)
    assert "=== summary ===" in printed and mean
    assert float(mean.group(1)) == pytest.approx(np.mean([float(f"{v:.4f}") for v in apes.values()]),
                                                 abs=1e-4)
    for scene in ("alpha", "beta"):
        assert apes[scene] == pytest.approx(results[scene]["rmse"], abs=1e-4)
        assert results[scene]["gt"] == os.path.join(out, scene, "groundtruth_tum.txt")
        _held_to_jax(results[scene], 8)
    step = "pi3_slam_online" if mode == "online" else "create_offline_chunks"
    assert set(results["alpha"]["steps"]) == ({step} if mode == "online"
                                              else {step, "reconstruct_offline"})


def test_euroc_mh03_run_on_the_cpu(data, tmp_path, capsys):
    """MH_03's skip of 400 leaves the last 8 of 408 frames, undistorted with
    the radial-tangential calibration; index-aligned GT from the CSV."""
    out = str(tmp_path / "out")
    results = eval_tool.run(["euroc", data["euroc"], data["ckpt"], data["calib"], "", out,
                          "--seqs", "MH_03", *TINY_RUN])
    printed = capsys.readouterr().out
    assert "\n8 images\n" in printed
    line = re.search(r"^MH_03 APE RMSE: ([0-9.]+) m \(pairs (\d+)\)$", printed, re.M)
    assert line and int(line.group(2)) == 8
    assert float(line.group(1)) == pytest.approx(results["MH_03"]["rmse"], abs=1e-4)
    _held_to_jax(results["MH_03"], 8)


def test_ground_truth_from_gt_dir_and_a_missing_one(data, tmp_path, capsys):
    """A <gt-dir>/<name>.txt is used as it is; a EuRoC sequence without a
    ground-truth CSV prints the script's line and scores nothing."""
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    make_7scenes_gt.main([os.path.join(data["7scenes"], "beta", "seq-01"), str(gt_dir / "beta.txt")])
    results = eval_tool.run(["7scenes", data["7scenes"], data["ckpt"], "", str(tmp_path / "o"),
                          "--scenes", "beta", "--gt-dir", str(gt_dir), *TINY_RUN])
    assert results["beta"]["gt"] == str(gt_dir / "beta.txt")
    assert not (tmp_path / "o" / "beta" / "groundtruth_tum.txt").exists()

    sm.make_euroc(str(tmp_path / "euroc"), "V1_01", 6, H, W)
    os.remove(tmp_path / "euroc" / "V1_01" / "mav0" / "state_groundtruth_estimate0" / "data.csv")
    capsys.readouterr()
    results = eval_tool.run(["euroc", str(tmp_path / "euroc"), data["ckpt"], data["calib"], "",
                          str(tmp_path / "o2"), "--seqs", "V1_01", *TINY_RUN])
    assert results == {}
    assert "no ground truth at" in capsys.readouterr().out
