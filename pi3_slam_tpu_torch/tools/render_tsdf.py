"""Raycast depth / normal renders of a saved TSDF volume (--save-volume).

    python -m pi3_slam_tpu_torch.tools.render_tsdf --volume out/fused_volume.npz \\
        --trajectory out/trajectory_tum.txt --views 6 --output renders/ [--device cpu]

The port's copy of the JAX package's tools/render_tsdf.py: the same flags and
lines, plus ``--device`` (the card by default), where the rays are traced
(``mapping/raycast.py``). Renders from evenly spaced trajectory poses (TUM
camera-to-world), or from an orbit around the volume center when no
trajectory is given. Companion to reconstruct_offline --render-previews for
volumes persisted with --save-volume: no re-fusing needed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--volume", required=True, help="fused_volume.npz")
    parser.add_argument("--trajectory", default=None,
                        help="TUM trajectory; evenly spaced poses are rendered "
                             "(default: an orbit around the volume)")
    parser.add_argument("--views", type=int, default=6)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--output", default="tsdf_renders")
    parser.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from ..mapping import TSDFVolume, raycast_depth
    from ..slam.offline_reconstructor import save_preview

    volume = TSDFVolume.load(args.volume)
    h, w = args.height, args.width
    intr = np.array([0.8 * w, 0.8 * w, w / 2, h / 2])

    poses = []  # (R world->cam, center)
    if args.trajectory:
        import torch

        from ..geometry.transforms import quaternion_to_rotation_matrix
        from ..io.tum import read_tum_trajectory

        traj = read_tum_trajectory(args.trajectory)
        q = traj["quaternions_xyzw"]
        # camera-to-world from TUM xyzw -> wxyz, in fp32 as the JAX tool computes it
        R_cw = quaternion_to_rotation_matrix(
            torch.as_tensor(q[:, [3, 0, 1, 2]], dtype=torch.float32)).numpy()
        pick = np.linspace(0, len(R_cw) - 1, min(args.views, len(R_cw))).astype(int)
        for i in pick:
            poses.append((R_cw[i].T, traj["positions"][i]))
    else:
        center = volume.origin + np.array(volume.shape) * volume.voxel_size / 2
        radius = 0.8 * float(np.max(volume.shape)) * volume.voxel_size
        for k in range(args.views):
            ang = 2 * np.pi * k / args.views
            c = center + radius * np.array([np.cos(ang), np.sin(ang), 0.3])
            z = center - c
            z = z / np.linalg.norm(z)
            up = np.array([0.0, 0.0, 1.0])
            x = np.cross(up, z)
            x = x / max(np.linalg.norm(x), 1e-9)
            y = np.cross(z, x)
            poses.append((np.stack([x, y, z]), c))

    os.makedirs(args.output, exist_ok=True)
    for j, (R, c) in enumerate(poses):
        out = raycast_depth(volume, intr, R, c, h, w, device=args.device)
        save_preview(out, args.output, j)
        print(f"view {j}: {out['mask'].mean():.0%} hit -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
