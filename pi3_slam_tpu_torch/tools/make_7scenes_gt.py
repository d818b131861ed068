"""Build a TUM ground-truth trajectory from 7-Scenes per-frame pose files.

7-Scenes ships frame-XXXXXX.pose.txt (4x4 camera-to-world) per frame; the
evaluation compares against a TUM file with integer frame timestamps, as the
pipeline's integer-timestamp trajectory export writes them. The port's copy
of the JAX package's tools/make_7scenes_gt.py: the same arguments, lines and
file.

Usage: python -m pi3_slam_tpu_torch.tools.make_7scenes_gt data/7scenes/chess/seq-01 gt/chess.txt
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from ..io.tum import write_tum_trajectory


def main(argv=None) -> int:
    argv = argv or sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 2
    seq_dir, out_path = argv
    pose_files = sorted(glob.glob(os.path.join(seq_dir, "frame-*.pose.txt")))
    if not pose_files:
        print(f"no pose files in {seq_dir}")
        return 1
    poses = np.stack([np.loadtxt(p) for p in pose_files])  # (N, 4, 4) camera-to-world
    write_tum_trajectory(out_path, poses[:, :3, 3], poses[:, :3, :3], integer_timestamps=True)
    print(f"wrote {len(pose_files)} poses -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
