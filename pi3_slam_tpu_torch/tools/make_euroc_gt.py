"""Build an index-aligned TUM ground-truth trajectory for a EuRoC sequence.

EuRoC ships ground truth as mav0/state_groundtruth_estimate0/data.csv
(timestamp_ns, p_RS_R_{x,y,z}, q_RS_R_{w,x,y,z}, ...). The offline
trajectory export stamps poses with integer frame indices, so this tool
interpolates the GT pose at every cam0 frame time and writes TUM with the
same integer indexing, honoring --skip-start / --skip-end / --stride. The
port's copy of the JAX package's tools/make_euroc_gt.py: the same arguments,
lines and file.

Usage:
  python -m pi3_slam_tpu_torch.tools.make_euroc_gt <seq>/mav0 gt/MH_01.txt [--skip-start 700]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from ..io.tum import write_tum_trajectory


def _slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    """Spherical interpolation of two (w, x, y, z) quaternions."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = q0 + u * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - u) * th) * q0 + np.sin(u * th) * q1) / np.sin(th)


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def interpolate_gt(gt_ts, gt_pos, gt_quat, frame_ts):
    """GT poses at the frame times -> (positions, rotations, valid)."""
    pos, rot, valid = [], [], []
    for t in frame_ts:
        j = int(np.searchsorted(gt_ts, t, side="right"))
        if j <= 0 or j >= len(gt_ts):
            pos.append(np.zeros(3))
            rot.append(np.eye(3))
            valid.append(False)
            continue
        t0, t1 = gt_ts[j - 1], gt_ts[j]
        u = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
        pos.append(gt_pos[j - 1] * (1 - u) + gt_pos[j] * u)
        rot.append(_quat_to_rot(_slerp(gt_quat[j - 1], gt_quat[j], float(u))))
        valid.append(True)
    return np.asarray(pos), np.asarray(rot), np.asarray(valid)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("mav0", help="Path to the sequence's mav0 directory")
    parser.add_argument("output", help="Output TUM file")
    parser.add_argument("--skip-start", type=int, default=0)
    parser.add_argument("--skip-end", type=int, default=0)
    parser.add_argument("--stride", type=int, default=1)
    args = parser.parse_args(argv)

    csv = os.path.join(args.mav0, "state_groundtruth_estimate0", "data.csv")
    data = np.loadtxt(csv, delimiter=",", skiprows=1, usecols=range(8))
    gt_ts, gt_pos, gt_quat = data[:, 0], data[:, 1:4], data[:, 4:8]  # quaternions (w, x, y, z)

    frames = sorted(glob.glob(os.path.join(args.mav0, "cam0", "data", "*.png")))
    if args.skip_end:
        frames = frames[args.skip_start : len(frames) - args.skip_end]
    elif args.skip_start:
        frames = frames[args.skip_start :]
    frames = frames[:: args.stride]
    if not frames:
        print("no cam0 frames found", file=sys.stderr)
        return 1
    frame_ts = np.array([float(os.path.basename(f).split(".")[0]) for f in frames])

    pos, rot, valid = interpolate_gt(gt_ts, gt_pos, gt_quat, frame_ts)
    # integer indices matching the pipeline's export; frames without GT
    # coverage keep their index but are dropped
    idx = np.flatnonzero(valid)
    write_tum_trajectory(args.output, pos[idx], rot[idx], timestamps=[float(i) for i in idx])
    print(f"wrote {idx.size}/{len(frames)} GT poses -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
