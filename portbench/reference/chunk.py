"""One chunk as the offline creator stores it, worked out again in plain
PyTorch and NumPy from the chunk's image files.

The frames are decoded and sized as the loader sizes them (the first frame's
size scaled under the pixel limit to multiples of 14, OpenCV's INTER_AREA
when shrinking, bilinear PIL where OpenCV is missing), the grid keypoints
laid out as the creator lays them, the Pi3 forward of ``pi3.py`` run on the
chunk, the confidence and depth-edge masks and the keypoint sampling of
``focal.py`` taken, MoGe-2's metric depth of ``moge.py`` on the
first frame turned into the metric scale, and the stored arrays formed: world
and local keypoint points and the camera translations scaled, the
camera-to-world poses.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from PIL import Image

from .focal import depth_edge, sample_at

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def target_size(first_path: str, pixel_limit: int) -> tuple[int, int]:
    """(H, W): the first image scaled under pixel_limit, multiples of 14."""
    with Image.open(first_path) as im:
        W0, H0 = im.size
    scale = math.sqrt(pixel_limit / (W0 * H0))
    Wt, Ht = W0 * scale, H0 * scale
    k, m = round(Wt / 14), round(Ht / 14)
    while (k * 14) * (m * 14) > pixel_limit:
        if k / m > Wt / Ht:
            k -= 1
        else:
            m -= 1
    return max(1, m) * 14, max(1, k) * 14


def load_frames(paths, hw: tuple[int, int]) -> np.ndarray:
    """(N, 3, H, W) uint8 frames decoded as RGB and sized to hw."""
    th, tw = hw
    out = []
    for p in paths:
        with Image.open(p) as im:
            img = np.asarray(im.convert("RGB"))
        h, w = img.shape[:2]
        if (h, w) != (th, tw):
            if cv2 is not None:
                interp = cv2.INTER_AREA if (th < h or tw < w) else cv2.INTER_LINEAR
                img = cv2.resize(img, (tw, th), interpolation=interp)
            else:
                img = np.asarray(Image.fromarray(img).resize((tw, th), Image.BILINEAR))
        out.append(np.ascontiguousarray(img.transpose(2, 0, 1)))
    return np.stack(out)


def grid_keypoints(H: int, W: int, max_kp: int) -> np.ndarray:
    """(K, 2) float32 (x, y) grid at a spacing that gives about max_kp
    points inside a 5% margin; a deterministic subset where it gives more."""
    margin = min(H, W) * 0.05
    eff_h, eff_w = H - 2 * margin, W - 2 * margin
    if eff_h <= 0 or eff_w <= 0:
        s = max(H, W)
    else:
        s = max(8, min(int(np.sqrt((eff_h * eff_w) / max_kp)), min(H, W) // 4))
    xs = np.arange(margin, W - margin, s)
    ys = np.arange(margin, H - margin, s)
    if len(xs) == 0 or len(ys) == 0:
        return np.array([[W // 2, H // 2]], dtype=np.float32)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)
    if len(coords) > max_kp:
        rng = np.random.default_rng(H * 1_000_003 + W)
        coords = coords[np.sort(rng.permutation(len(coords))[:max_kp])]
    return coords


@torch.no_grad()
def chunk_outputs(model, images_u8: torch.Tensor, keypoints: torch.Tensor,
                  conf_threshold: float, edge_rtol: float, prec=None) -> dict:
    """The chunk step's outputs, float32, on the images' device."""
    images = images_u8.float() / 255.0
    out = model(images[None], prec)
    local, world = out["local_points"][0], out["points"][0]
    conf, poses = out["conf"][0], out["camera_poses"][0]
    masks = (torch.sigmoid(conf[..., 0]) > conf_threshold) & ~depth_edge(local[..., 2], edge_rtol)
    return {
        "points_kp": sample_at(world, keypoints),
        "local_points_kp": sample_at(local, keypoints),
        "conf_kp": sample_at(conf, keypoints, "nearest"),
        "masks_kp": sample_at(masks[..., None].float(), keypoints, "nearest")[..., 0] > 0.5,
        "camera_poses": poses,
        "camera_poses_probe": out["camera_poses_probe"][0],
        "depth0": local[0, ..., 2],
        "mask0": masks[0],
    }


def metric_scale(moge_depth: np.ndarray | None, depth0: np.ndarray, mask0: np.ndarray):
    """The median MoGe / Pi3 depth ratio over frame 0's valid pixels, None
    without MoGe or with fewer than 10 finite ratios."""
    if moge_depth is None:
        return None
    ratio = moge_depth[mask0] / np.maximum(depth0[mask0], 1e-9)
    ratio = ratio[np.isfinite(ratio)]
    return float(np.median(ratio)) if ratio.size >= 10 else None


def stored(outputs: dict, moge_depth: np.ndarray | None) -> dict:
    """The arrays the creator stores for a chunk, in float64 where it scales
    them: points, local_points, conf, masks, camera_poses and metric_scale
    (None where it is skipped); and the probe's poses, unscaled."""
    host = {k: v.double().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
            for k, v in outputs.items()}
    scale = metric_scale(moge_depth, host["depth0"], host["mask0"])
    points, local, poses = host["points_kp"], host["local_points_kp"], host["camera_poses"]
    if scale is not None:
        points, local = points * scale, local * scale
        poses = poses.copy()
        poses[:, :3, 3] *= scale
    return {"points": points, "local_points": local, "conf": host["conf_kp"],
            "masks": host["masks_kp"], "camera_poses": poses,
            "camera_poses_probe": host["camera_poses_probe"], "metric_scale": scale}
