"""The 7-Scenes and EuRoC evaluations on the port: for each scene or
sequence, the steps of ``scripts/eval_7scenes.sh`` and
``scripts/eval_euroc.sh`` with the port's CLIs, run in this process, then the
Sim3-aligned APE against the ground truth.

    python -m pi3_slam_tpu_torch.tools.eval 7scenes <data_root> <pi3.npz> [moge.npz] [out_dir] \\
        [--mode offline|online] [--scenes chess fire ...]
    python -m pi3_slam_tpu_torch.tools.eval euroc <euroc_root> <pi3.npz> <calib.json> \\
        [moge.npz] [out_dir] [--seqs MH_01 ...]

The scripts' positional arguments, and their environment knobs as flags
(``--chunk-length``, ``--overlap``, ``--max-kp``, ``--max-obs``, ``--mode``,
``--scenes`` / ``--seqs``, ``--keypoints``, ``--aliked-npz``, ``--loop``,
``--refine``, ``--gt-dir``, ``--device``). The CLIs get the scripts' flags one
for one: ``--keypoints aliked --aliked-npz <npz>`` reaches both CLIs,
``--refine`` the chunk step (``--refine-observations``), ``--loop`` the
reconstruction (``--loop-closure``). Ground truth comes
from ``--gt-dir`` where it holds ``<scene>.txt``, else from the pose files
(``make_7scenes_gt``, ``make_euroc_gt``). Prints the scripts' lines:
``<scene> APE RMSE: <x> m`` and the summary for 7-Scenes, ``<seq> APE RMSE:
<x> m (pairs <n>)`` for EuRoC. A failed step raises; nothing is retried (a
CUDA fault is sticky to its context). ``--device cuda`` (the default) needs a
CUDA device; ``--device cpu`` is the explicit CPU mode.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

from ..create_offline_chunks import create_chunks
from ..device import select_device
from ..pi3_slam_online import run_online
from ..reconstruct_offline import reconstruct
from ..utils.evaluation import evaluate_tum_files
from . import make_7scenes_gt, make_euroc_gt

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENES = ["chess", "fire", "heads", "office", "pumpkin", "redkitchen", "stairs"]
SEQS = ["MH_01", "MH_02", "MH_03", "V1_01", "V1_02", "V2_01"]
# start frames skipped per EuRoC sequence (stationary initialization)
EUROC_SKIP = {"MH_01": 700, "MH_02": 600, "MH_03": 400}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="dataset", required=True)
    seven = sub.add_parser("7scenes", help="scripts/eval_7scenes.sh")
    seven.add_argument("data_root", help="<data_root>/<scene>/seq-01/*.color.png and *.pose.txt")
    seven.add_argument("pi3_npz")
    seven.add_argument("moge_npz", nargs="?", default="",
                       help="MoGe-2 weights; without them --no-metric-depth")
    seven.add_argument("out", nargs="?", default="eval_7scenes_out")
    seven.add_argument("--max-obs", type=int, default=10)
    seven.add_argument("--mode", choices=["offline", "online"], default="offline")
    seven.add_argument("--scenes", nargs="+", default=SCENES)
    seven.add_argument("--keypoints", default="grid")
    seven.add_argument("--aliked-npz", default="")
    seven.add_argument("--loop", action="store_true", help="--loop-closure")
    seven.add_argument("--refine", action="store_true", help="--refine-observations")
    seven.add_argument("--gt-dir", default=os.path.join(REPO, "scripts", "groundtruths", "7scenes"))
    euroc = sub.add_parser("euroc", help="scripts/eval_euroc.sh")
    euroc.add_argument("data_root", help="<euroc_root>/<seq>/mav0")
    euroc.add_argument("pi3_npz")
    euroc.add_argument("calib", help="cam0 calibration JSON")
    euroc.add_argument("moge_npz", nargs="?", default="")
    euroc.add_argument("out", nargs="?", default="eval_euroc_out")
    euroc.add_argument("--seqs", nargs="+", default=SEQS)
    euroc.add_argument("--gt-dir", default=os.path.join(REPO, "scripts", "groundtruths", "euroc"))
    for p in (seven, euroc):
        p.add_argument("--chunk-length", type=int, default=100)
        p.add_argument("--overlap", type=int, default=20)
        p.add_argument("--max-kp", type=int, default=400)
        p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return parser


def _moge(args) -> list:
    return ["--moge-path", args.moge_npz] if args.moge_npz else ["--no-metric-depth"]


def steps_7scenes(args, scene: str) -> list:
    """[(CLI name, argv)] for one scene: eval_7scenes.sh:51-71."""
    seq_dir = os.path.join(args.data_root, scene, "seq-01")
    out_dir = os.path.join(args.out, scene)
    kp = ["--keypoints", args.keypoints] + (["--aliked-path", args.aliked_npz]
                                            if args.aliked_npz else [])
    create_extra = ["--refine-observations"] if args.refine else []
    recon_extra = ["--loop-closure"] if args.loop else []
    model = ["--images", os.path.join(seq_dir, "*.color.png"), "--model-path", args.pi3_npz,
             *_moge(args), "--output", out_dir]
    chunks = ["--chunk-length", str(args.chunk_length), "--overlap", str(args.overlap)]
    if args.mode == "online":
        return [("pi3_slam_online", [
            *model, *chunks, *kp, "--max-kp", str(args.max_kp), *create_extra, *recon_extra,
            "--max-observations-per-track", str(args.max_obs), "--device", args.device,
            "--tum-integer-timestamps"])]
    return [("create_offline_chunks", [
                *model, "--resume", *chunks, "--device", args.device, *kp,
                "--max-kp", str(args.max_kp), *create_extra]),
            ("reconstruct_offline", [
                "--chunks", out_dir, *recon_extra, "--device", args.device,
                "--max-observations-per-track", str(args.max_obs)])]


def steps_euroc(args, seq: str) -> list:
    """[(CLI name, argv)] for one sequence: eval_euroc.sh:44-56."""
    out_dir = os.path.join(args.out, seq)
    return [("create_offline_chunks", [
                "--images", os.path.join(args.data_root, seq, "mav0", "cam0", "data"), "--resume",
                "--model-path", args.pi3_npz, *_moge(args), "--cam-dist-path", args.calib,
                "--skip-start", str(EUROC_SKIP.get(seq, 0)), "--output", out_dir,
                "--chunk-length", str(args.chunk_length), "--overlap", str(args.overlap),
                "--device", args.device, "--keypoints", "grid", "--max-kp", str(args.max_kp)]),
            ("reconstruct_offline", [
                "--chunks", out_dir, "--max-observations-per-track", "10", "--use-inverse-depth",
                "--device", args.device])]


CLIS = {"create_offline_chunks": create_chunks, "reconstruct_offline": reconstruct,
        "pi3_slam_online": run_online}


def _run_step(name: str, argv: list):
    print(f"python -m pi3_slam_tpu_torch.{name} " + " ".join(argv), flush=True)
    return CLIS[name](argv)


def _ground_truth(args, name: str, out_dir: str) -> str | None:
    """<gt-dir>/<name>.txt, else one built from the dataset's poses (None
    where a EuRoC sequence has no ground-truth file)."""
    gt = os.path.join(args.gt_dir, f"{name}.txt")
    if os.path.isfile(gt):
        return gt
    gt = os.path.join(out_dir, "groundtruth_tum.txt")
    if args.dataset == "7scenes":
        rc = make_7scenes_gt.main([os.path.join(args.data_root, name, "seq-01"), gt])
    else:
        mav0 = os.path.join(args.data_root, name, "mav0")
        if not os.path.isfile(os.path.join(mav0, "state_groundtruth_estimate0", "data.csv")):
            return None
        rc = make_euroc_gt.main([mav0, gt, "--skip-start", str(EUROC_SKIP.get(name, 0))])
    if rc:
        raise SystemExit(f"{name}: building the ground truth failed (exit code {rc})")
    return gt


def run(argv=None) -> dict:
    """Parse ``argv`` and evaluate every scene or sequence. Returns
    {name: {"rmse", "pairs", "seconds", "gt", "steps": {CLI name: its
    result}}}, the names without ground truth left out."""
    args = build_parser().parse_args(argv)
    select_device(args.device)
    plot = importlib.util.find_spec("matplotlib") is not None
    if not plot:
        print("matplotlib is not installed: no APE plot (evo_ape.png) is written")
    names, make_steps = ((args.scenes, steps_7scenes) if args.dataset == "7scenes"
                         else (args.seqs, steps_euroc))
    results = {}
    for name in names:
        print(f"=== {name} ===", flush=True)
        out_dir = os.path.join(args.out, name)
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        steps = {cli: _run_step(cli, step_argv) for cli, step_argv in make_steps(args, name)}
        seconds = time.perf_counter() - t0
        gt = _ground_truth(args, name, out_dir)
        if gt is None:
            print(f"no ground truth at {os.path.join(out_dir, 'groundtruth_tum.txt')} - "
                  "skipping APE")
            continue
        r = evaluate_tum_files(gt, os.path.join(out_dir, "trajectory_tum.txt"), align_sim3=True,
                               max_diff=0.5,
                               plot_path=os.path.join(out_dir, "evo_ape.png") if plot else None)
        if args.dataset == "7scenes":
            print(f"{name} APE RMSE: {r.rmse:.4f} m")
        else:
            print(f"{name} APE RMSE: {r.rmse:.4f} m (pairs {r.num_pairs})")
        results[name] = {"rmse": r.rmse, "pairs": r.num_pairs, "seconds": seconds, "gt": gt,
                         "steps": steps}
    if args.dataset == "7scenes":
        print("=== summary ===")
        values = {k: float(f"{v['rmse']:.4f}") for k, v in results.items()}
        for k, v in values.items():
            print(f"{k:12s} {v:.4f} m")
        print(f"{'mean':12s} {sum(values.values()) / len(values):.4f} m  (reference: 0.069 m)")
    return results


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
