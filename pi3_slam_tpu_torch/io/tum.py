"""TUM trajectory files: ``timestamp tx ty tz qx qy qz qw`` lines under a
comment header.

Port of ``pi3_slam_tpu/io/tum.py``; the quaternions come from the port's
``rotation_matrix_to_quaternion`` in fp64 on the host.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..geometry.transforms import rotation_matrix_to_quaternion


def write_tum_trajectory(
    path: str,
    positions: np.ndarray,
    rotations: np.ndarray,
    timestamps: Sequence[float] | None = None,
    integer_timestamps: bool = True,
) -> None:
    """Write (N, 3) camera centers and (N, 3, 3) camera-to-world rotations;
    timestamps default to the frame indices (integers, as the reference's
    offline reconstructor writes them)."""
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    rotations = np.asarray(rotations, dtype=np.float64).reshape(-1, 3, 3)
    quats_wxyz = rotation_matrix_to_quaternion(torch.from_numpy(rotations)).numpy()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i in range(positions.shape[0]):
            if timestamps is not None:
                ts = f"{float(timestamps[i]):.9f}"
            elif integer_timestamps:
                ts = str(i)
            else:
                ts = f"{float(i):.9f}"
            x, y, z = positions[i]
            qw, qx, qy, qz = quats_wxyz[i]
            f.write(f"{ts} {x:.6f} {y:.6f} {z:.6f} {qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n")


def read_tum_trajectory(path: str) -> dict:
    """-> {'timestamps': (N,), 'positions': (N, 3), 'quaternions_xyzw': (N, 4)}."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 8:
                continue
            ts.append(vals[0])
            pos.append(vals[1:4])
            quat.append(vals[4:8])
    return {"timestamps": np.asarray(ts), "positions": np.asarray(pos),
            "quaternions_xyzw": np.asarray(quat)}
