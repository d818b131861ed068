"""COLMAP text-model export (cameras.txt / images.txt / points3D.txt).

Port of ``pi3_slam_tpu/io/colmap.py``, writing the same bytes for the same
reconstructions: the quaternions come from the port's
``geometry/transforms.rotation_matrix_to_quaternion`` in one batched float32
call on the CPU, which gives the JAX function's bits.

Beyond the reference (which exports PLY + TUM only): the COLMAP text format
is the lingua franca of downstream novel-view pipelines (gaussian
splatting, nerfstudio, instant-ngp loaders), so a reconstruction produced
here can feed them directly. Conventions follow the official COLMAP
documentation: images.txt stores the world->camera rotation as a
(qw qx qy qz) quaternion and t = -R @ c; POINTS2D entries are
(x, y, point3d_id); points3D tracks list (image_id, point2d_idx) pairs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def write_colmap_text(recons: Sequence, out_dir: str) -> Dict[str, str]:
    """Export merged chunk reconstructions as a COLMAP text model.

    Frames shared between overlapping chunks are deduplicated by name
    (first occurrence wins, matching the PLY/TUM exports); observations
    from any chunk attach to the deduplicated image. Tracks of every chunk
    are exported (overlap tracks appear once per owning chunk, like the
    merged PLY).
    """
    os.makedirs(out_dir, exist_ok=True)

    # ---- images: dedup by name, first occurrence wins
    name_to_img: Dict[str, int] = {}
    img_rows: List[str] = []  # pose lines (observations appended later)
    img_cam: List[tuple] = []  # (fx, fy, cx, cy, w, h) per image
    img_pose: List[tuple] = []
    for r in recons:
        for j, nm in enumerate(r.frame_names):
            if nm in name_to_img:
                continue
            name_to_img[nm] = len(img_rows) + 1  # COLMAP ids are 1-based
            img_rows.append(nm)
            img_cam.append(
                (
                    float(r.intrinsics[j, 0]),
                    float(r.intrinsics[j, 1]),
                    float(r.intrinsics[j, 2]),
                    float(r.intrinsics[j, 3]),
                    int(r.image_width),
                    int(r.image_height),
                )
            )
            img_pose.append((r.rotations[j], r.centers[j]))

    # ---- points + per-image observation lists
    points: List[tuple] = []  # (xyz, rgb, track entries)
    img_points2d: List[List[tuple]] = [[] for _ in img_rows]  # (x, y, p3d_id)
    for r in recons:
        live = np.nonzero(r.track_valid > 0)[0]
        for t in live:
            p3d_id = len(points) + 1
            track_entries = []
            for m in range(r.obs_frame.shape[1]):
                if r.obs_valid[t, m] <= 0:
                    continue
                nm = r.frame_names[int(r.obs_frame[t, m])]
                img_id = name_to_img[nm]
                lst = img_points2d[img_id - 1]
                point2d_idx = len(lst)
                lst.append((float(r.obs_uv[t, m, 0]), float(r.obs_uv[t, m, 1]), p3d_id))
                track_entries.append((img_id, point2d_idx))
            rgb = np.clip(r.colors[t] * 255.0, 0, 255).astype(int)
            points.append((r.points[t], rgb, track_entries))

    # ---- cameras.txt (one PINHOLE camera per image; COLMAP permits this)
    cam_path = os.path.join(out_dir, "cameras.txt")
    with open(cam_path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for i, (fx, fy, cx, cy, w, h) in enumerate(img_cam):
            f.write(f"{i + 1} PINHOLE {w} {h} {fx:.6f} {fy:.6f} {cx:.6f} {cy:.6f}\n")

    # ---- images.txt
    img_path = os.path.join(out_dir, "images.txt")
    import torch

    from ..geometry.transforms import rotation_matrix_to_quaternion as _rmq

    # one batched call for every pose
    quats = (
        _rmq(torch.as_tensor(np.stack([R for R, _ in img_pose]), dtype=torch.float32)).numpy()
        if img_pose
        else np.zeros((0, 4))
    )  # (N, 4) as (w, x, y, z)
    with open(img_path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i, nm in enumerate(img_rows):
            R, c = img_pose[i]
            q = quats[i]
            t = -R @ c
            f.write(
                f"{i + 1} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
                f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} {i + 1} {nm}\n"
            )
            f.write(
                " ".join(f"{x:.3f} {y:.3f} {pid}" for x, y, pid in img_points2d[i])
                + "\n"
            )

    # ---- points3D.txt
    pts_path = os.path.join(out_dir, "points3D.txt")
    with open(pts_path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pid, (xyz, rgb, track) in enumerate(points, start=1):
            tr = " ".join(f"{img} {idx}" for img, idx in track)
            f.write(
                f"{pid} {xyz[0]:.6f} {xyz[1]:.6f} {xyz[2]:.6f} "
                f"{rgb[0]} {rgb[1]} {rgb[2]} 0.0 {tr}\n"
            )

    return {"cameras": cam_path, "images": img_path, "points3D": pts_path}
