"""TUM trajectory files: ``timestamp tx ty tz qx qy qz qw`` lines under a
comment header.

Port of ``pi3_slam_tpu/io/tum.py``. The quaternions are computed as that
writer computes them (:func:`quaternions_wxyz`), so both packages write the
same bytes for the same poses.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def quaternions_wxyz(rotations: np.ndarray) -> np.ndarray:
    """(N, 3, 3) float64 rotations -> (N, 4) float32 unit quaternions (w, x,
    y, z), w >= 0, with the arithmetic of the JAX writer: Shepperd's method
    (the JAX package's ``geometry/transforms.rotation_matrix_to_quaternion``)
    on float64 numpy entries in JAX's default 32-bit mode. Sums and differences of matrix
    entries, and the branch tests, are float64 numpy operations rounded to
    float32 where they meet a JAX operation; the rest is float32, and the
    norm's sum of squares is a chain of fused multiply-adds in component
    order (what XLA's CPU backend compiles ``jnp.linalg.norm`` to)."""
    f32 = np.float32
    m = [[rotations[:, i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]

    def scale(x):  # 2 sqrt(max(x, 1e-24)) in float32
        return np.sqrt(np.maximum(x.astype(f32), f32(1e-24))) * f32(2.0)

    def ratio(x, s):
        return x.astype(f32) / s

    s0 = scale(tr + 1.0)
    q0 = [f32(0.25) * s0, ratio(m[2][1] - m[1][2], s0), ratio(m[0][2] - m[2][0], s0),
          ratio(m[1][0] - m[0][1], s0)]
    s1 = scale(1.0 + m[0][0] - m[1][1] - m[2][2])
    q1 = [ratio(m[2][1] - m[1][2], s1), f32(0.25) * s1, ratio(m[0][1] + m[1][0], s1),
          ratio(m[0][2] + m[2][0], s1)]
    s2 = scale(1.0 + m[1][1] - m[0][0] - m[2][2])
    q2 = [ratio(m[0][2] - m[2][0], s2), ratio(m[0][1] + m[1][0], s2), f32(0.25) * s2,
          ratio(m[1][2] + m[2][1], s2)]
    s3 = scale(1.0 + m[2][2] - m[0][0] - m[1][1])
    q3 = [ratio(m[1][0] - m[0][1], s3), ratio(m[0][2] + m[2][0], s3),
          ratio(m[1][2] + m[2][1], s3), f32(0.25) * s3]
    q = np.where((tr > 0.0)[:, None], np.stack(q0, -1),
                 np.where(((m[0][0] >= m[1][1]) & (m[0][0] >= m[2][2]))[:, None], np.stack(q1, -1),
                          np.where((m[1][1] >= m[2][2])[:, None], np.stack(q2, -1),
                                   np.stack(q3, -1))))
    # fma(a, a, acc): the float64 product of two float32 values is exact, and
    # the float64 sum rounded to float32 is the fused result (barring a
    # double-rounding tie)
    sq = np.zeros(q.shape[0], f32)
    for k in range(4):
        sq = (q[:, k].astype(np.float64) ** 2 + sq).astype(f32)
    q = q / np.sqrt(sq)[:, None]
    return q * np.where(q[:, :1] < 0, f32(-1.0), f32(1.0))


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
    quats_wxyz = quaternions_wxyz(rotations)
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
