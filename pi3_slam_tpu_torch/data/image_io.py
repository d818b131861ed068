"""Image loading and sizing.

Port of ``pi3_slam_tpu/data/image_io.py`` for image files (the chunk CLI
takes folders, globs or lists of images; video input is not ported):

* ``calculate_target_size`` scales the first image under the pixel budget,
  snapped to multiples of 14;
* images load as (3, H, W) uint8 (the device step normalises them: a
  quarter of a float32 upload); downscaling uses OpenCV's INTER_AREA,
  upscaling INTER_LINEAR.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

try:
    import cv2

    # the prefetch loader already decodes files in parallel
    cv2.setNumThreads(0)
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def calculate_target_size(first_image_path, pixel_limit: int = 255000) -> Tuple[int, int]:
    """(H, W) target size: scaled under pixel_limit, multiples of 14."""
    with Image.open(first_image_path) as im:
        W_orig, H_orig = im.size
    scale = math.sqrt(pixel_limit / (W_orig * H_orig)) if W_orig * H_orig > 0 else 1
    W_target, H_target = W_orig * scale, H_orig * scale
    k, m = round(W_target / 14), round(H_target / 14)
    while (k * 14) * (m * 14) > pixel_limit:
        if k / m > W_target / H_target:
            k -= 1
        else:
            m -= 1
    return (max(1, m) * 14, max(1, k) * 14)


def _resize(img: np.ndarray, target_hw: Tuple[int, int]) -> np.ndarray:
    """Resize an HWC image: INTER_AREA when downscaling, else linear."""
    h, w = img.shape[:2]
    th, tw = target_hw
    if (h, w) == (th, tw):
        return img
    if _HAS_CV2:
        interp = cv2.INTER_AREA if (th < h or tw < w) else cv2.INTER_LINEAR
        return cv2.resize(img, (tw, th), interpolation=interp)
    return np.asarray(Image.fromarray(img).resize((tw, th), Image.BILINEAR))


def load_image(path, target_hw: Tuple[int, int] | None = None, undistorter=None) -> np.ndarray:
    """One image -> (3, H, W) uint8."""
    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"))
    if undistorter is not None:
        img = undistorter.undistort_image(img)
    if target_hw is not None:
        img = _resize(img, target_hw)
    return np.ascontiguousarray(img.transpose(2, 0, 1))


def load_images(paths: Sequence, target_hw: Tuple[int, int], undistorter=None) -> np.ndarray:
    """A chunk of images -> (N, 3, H, W) uint8."""
    return np.stack([load_image(p, target_hw, undistorter) for p in paths])
