"""The port's host data pipeline (pi3_slam_tpu_torch/data) against the JAX
package's (pi3_slam_tpu/data): same target sizes, the same chunk windows and
decoded bytes, in-order prefetch, and the same undistortion remap tables.
All host numpy code on identical inputs, so the comparisons are exact except
for the remap tables (float64 arithmetic of one formula, stored as float32:
equal to 1e-4 px)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
from PIL import Image

from pi3_slam_tpu.data import ChunkDataset as JaxChunkDataset
from pi3_slam_tpu.data import calculate_target_size as jax_target_size
from pi3_slam_tpu.data.datasets import chunk_windows as jax_chunk_windows
from pi3_slam_tpu.data.undistortion import create_undistorter as jax_create_undistorter
from pi3_slam_tpu_torch.data import ChunkDataset, PrefetchLoader, calculate_target_size, chunk_windows
from pi3_slam_tpu_torch.data.undistortion import create_undistorter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_frames(folder, n, hw, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"f{i:03d}.png")
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("hw,limit", [((480, 640), 255000 // 2), ((480, 640), 20000),
                                      ((100, 37), 255000), ((1080, 1920), 255000 // 2)])
def test_target_size_matches(tmp_path, hw, limit):
    (path,) = _write_frames(str(tmp_path), 1, hw)
    assert calculate_target_size(path, limit) == jax_target_size(path, limit)


@pytest.mark.parametrize("n,length,overlap", [(130, 100, 20), (8, 5, 2), (7, 3, 1), (1, 5, 2)])
def test_chunk_windows_match(n, length, overlap):
    assert chunk_windows(n, length, overlap) == jax_chunk_windows(n, length, overlap)


def test_chunk_dataset_matches(tmp_path):
    """Same windows, paths and decoded, resized pixels (downscale and upscale)."""
    paths = _write_frames(str(tmp_path), 7, (60, 80))
    for size in ((42, 56), (84, 112)):
        ours = ChunkDataset(paths, 4, 1, size)
        ref = JaxChunkDataset(paths, 4, 1, size)
        assert len(ours) == len(ref)
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert (a["chunk_idx"], a["start"], a["end"], a["paths"]) == (
                b["chunk_idx"], b["start"], b["end"], b["paths"])
            assert a["images"].dtype == b["images"].dtype
            np.testing.assert_array_equal(a["images"], b["images"])


def test_prefetch_loader_is_in_order_and_raises():
    class Slow:
        def __len__(self):
            return 9

        def __getitem__(self, i):
            if i == 7:
                raise KeyError("boom")
            return i

    items = []
    with pytest.raises(KeyError):
        for x in PrefetchLoader(Slow(), num_workers=3):
            items.append(x)
    assert items == list(range(len(items))) and len(items) <= 7

    class Fast(Slow):
        def __getitem__(self, i):
            return i

    assert list(PrefetchLoader(Fast(), num_workers=3)) == list(range(9))


def _calib(model):
    intr = {"aspect_ratio": 0.997, "focal_length": 50.0, "principal_pt_x": 33.0,
            "principal_pt_y": 23.5, "skew": 0.0}
    intr.update({
        "PINHOLE": dict(radial_distortion_1=-0.2, radial_distortion_2=0.05),
        "PINHOLE_RADIAL_TANGENTIAL": dict(radial_distortion_1=-0.28, radial_distortion_2=0.07,
                                          radial_distortion_3=0.01, tangential_distortion_1=2e-4,
                                          tangential_distortion_2=2e-5),
        "DIVISION_UNDISTORTION": dict(div_undist_distortion=-2e-4),
        "FISHEYE": dict(radial_distortion_1=-0.01, radial_distortion_2=0.002,
                        radial_distortion_3=1e-4, radial_distortion_4=-1e-5),
    }[model])
    return {"image_height": 48, "image_width": 64, "intrinsic_type": model, "intrinsics": intr}


@pytest.mark.parametrize("model", ["PINHOLE", "PINHOLE_RADIAL_TANGENTIAL", "DIVISION_UNDISTORTION",
                                   "FISHEYE", "euroc_cam0_calib.json",
                                   "division_undistortion_calib.json"])
def test_undistorter_matches(tmp_path, model):
    if model.endswith(".json"):
        path = os.path.join(REPO, "example", model)
    else:
        path = str(tmp_path / "calib.json")
        with open(path, "w") as f:
            json.dump(_calib(model), f)
    ours, ref = create_undistorter(path, 0.5), jax_create_undistorter(path, 0.5)
    np.testing.assert_allclose(ours.map_x, ref.map_x, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.map_y, ref.map_y, rtol=0, atol=1e-4)
    img = np.random.default_rng(1).integers(0, 256, (*ref.map_x.shape, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ours.undistort_image(img), ref.undistort_image(img))
