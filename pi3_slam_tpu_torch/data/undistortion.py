"""Camera calibration models and undistortion remapping.

Port of ``pi3_slam_tpu/data/undistortion.py``: vectorised numpy remap tables
for the four calibration models of ``example/*_calib.json`` (PINHOLE with
radial k1, k2; PINHOLE_RADIAL_TANGENTIAL in the OpenCV form;
DIVISION_UNDISTORTION; equidistant FISHEYE), applied with ``cv2.remap``.
The undistorted camera keeps the original focal length and principal point,
with unit aspect ratio.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class CalibratedCamera:
    model: str
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    skew: float = 0.0
    radial: Tuple[float, ...] = ()
    tangential: Tuple[float, float] = (0.0, 0.0)

    @classmethod
    def from_json(cls, data: dict, scale: float = 1.0) -> "CalibratedCamera":
        intr = data["intrinsics"]
        f = intr["focal_length"] * scale
        model = data["intrinsic_type"]
        n_radial = {"DIVISION_UNDISTORTION": 0, "FISHEYE": 4, "PINHOLE": 2,
                    "PINHOLE_RADIAL_TANGENTIAL": 3}
        if model not in n_radial:
            raise ValueError(f"unsupported intrinsic_type: {model}")
        if model == "DIVISION_UNDISTORTION":
            radial: Tuple[float, ...] = (intr.get("div_undist_distortion", 0.0),)
        else:
            radial = tuple(intr.get(f"radial_distortion_{i}", 0.0)
                           for i in range(1, n_radial[model] + 1))
        tangential = (0.0, 0.0)
        if model == "PINHOLE_RADIAL_TANGENTIAL":
            tangential = (intr.get("tangential_distortion_1", 0.0),
                          intr.get("tangential_distortion_2", 0.0))
        return cls(
            model=model,
            width=int(data["image_width"] * scale),
            height=int(data["image_height"] * scale),
            fx=f,
            fy=f * intr.get("aspect_ratio", 1.0),
            cx=intr["principal_pt_x"] * scale,
            cy=intr["principal_pt_y"] * scale,
            skew=intr.get("skew", 0.0),
            radial=radial,
            tangential=tangential,
        )

    def distort(self, x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Normalised camera coordinates -> distorted normalised coordinates."""
        if self.model == "PINHOLE":
            k1, k2 = (self.radial + (0.0, 0.0))[:2]
            r2 = x * x + y * y
            d = 1.0 + r2 * (k1 + k2 * r2)
            return x * d, y * d
        if self.model == "PINHOLE_RADIAL_TANGENTIAL":
            k1, k2, k3 = (self.radial + (0.0,) * 3)[:3]
            t1, t2 = self.tangential
            r2 = x * x + y * y
            d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            xd = x * d + 2 * t1 * x * y + t2 * (r2 + 2 * x * x)
            yd = y * d + t1 * (r2 + 2 * y * y) + 2 * t2 * x * y
            return xd, yd
        if self.model == "DIVISION_UNDISTORTION":
            # undistortion is xu = xd / (1 + lam rd^2); its inverse branch:
            # rd = (1 - sqrt(1 - 4 lam ru^2)) / (2 lam ru)
            lam = self.radial[0] if self.radial else 0.0
            if lam == 0.0:
                return x, y
            ru = np.sqrt(x * x + y * y)
            disc = np.maximum(1.0 - 4.0 * lam * ru * ru, 0.0)
            denom = 2.0 * lam * np.where(ru == 0, 1.0, ru)
            rd = np.where(ru == 0, 0.0, (1.0 - np.sqrt(disc)) / denom)
            scale = np.where(ru == 0, 1.0, rd / np.where(ru == 0, 1.0, ru))
            return x * scale, y * scale
        # FISHEYE (equidistant)
        k1, k2, k3, k4 = (self.radial + (0.0,) * 4)[:4]
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = np.where(r == 0, 1.0, theta_d / np.where(r == 0, 1.0, r))
        return x * scale, y * scale


class Undistorter:
    """Remap tables from undistorted pixels to the distorted image."""

    def __init__(self, cam: CalibratedCamera):
        self.cam = cam
        h, w = cam.height, cam.width
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        # inverse K of the undistorted twin: same fx, cx, cy; fy = fx; no skew
        y = (vv - cam.cy) / cam.fx
        x = (uu - cam.cx) / cam.fx
        xd, yd = cam.distort(x, y)
        self.map_x = (cam.fx * xd + cam.skew * yd + cam.cx).astype(np.float32)
        self.map_y = (cam.fy * yd + cam.cy).astype(np.float32)

    def undistort_image(self, img: np.ndarray) -> np.ndarray:
        """HWC image -> undistorted HWC image (bilinear remap)."""
        import cv2

        return cv2.remap(img, self.map_x, self.map_y, interpolation=cv2.INTER_LINEAR)


def create_undistorter(calib_path: str, scale: float = 1.0) -> Undistorter:
    with open(calib_path) as f:
        return Undistorter(CalibratedCamera.from_json(json.load(f), scale))
