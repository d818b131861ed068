"""The focal / shift solve's CPU route (``ops/focal_shift``) on the CPU.

On a CPU tensor ``solve_shift`` runs the eager closed-form solve, which the
creator's intrinsics (``estimate_camera_parameters``) and MoGe's depth shift
(``recover_focal_shift``) ran before the solve had a kernel. The benchmark's
plain reference keeps a frozen copy of that solve (``portbench/reference/
focal.py``, which imports nothing of the program): the CPU route gives its
bits. The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``-k focal``); the JAX parity of the solve is ``tests/test_torch_ops.py``'s.
"""

import pytest
import torch

from portbench.reference import focal as frozen
from pi3_slam_tpu_torch import ops
from pi3_slam_tpu_torch.geometry.focal import estimate_camera_parameters, recover_focal_shift
from pi3_slam_tpu_torch.geometry.maps import normalized_view_plane_uv
from pi3_slam_tpu_torch.ops.focal_shift import solve_shift, solve_shift_plain
from pi3_slam_tpu_torch.ops.roofline import focal_shift_work


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pinhole(n, h, w, focal, shift, noise, seed):
    """n pointmaps (n, h, w, 3) of a pinhole camera (xy = uv (z + shift) /
    focal, z in [2, 3)) with Gaussian noise, and a random mask (70% on)."""
    g = torch.Generator().manual_seed(seed)
    uv = normalized_view_plane_uv(w, h)
    z = 2 + torch.rand(n, h, w, generator=g)
    xy = uv[None] * (z[..., None] + shift) / focal
    pts = torch.cat([xy, z[..., None]], dim=-1)
    pts = pts + noise * torch.randn(pts.shape, generator=g)
    return pts, torch.rand(n, h, w, generator=g) > 0.3


@pytest.mark.parametrize("size", [(64, 64), (32, 32)])
@pytest.mark.parametrize("noise", [0.0, 0.01, 0.03])
def test_the_cpu_route_gives_the_frozen_eager_solve_s_bits(noise, size):
    pts, mask = _pinhole(4, 56, 84, focal=1.3, shift=0.4, noise=noise, seed=int(noise * 100))
    got = recover_focal_shift(pts, mask, downsample_size=size)
    want = frozen.recover_focal_shift(pts, mask, downsample_size=size)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)
    if noise == 0.0:
        torch.testing.assert_close(got[0], torch.full((4,), 1.3), rtol=1e-5, atol=0)


def test_estimate_camera_parameters_takes_the_frozen_solve_s_focal():
    """The intrinsics from the CPU route's focal, a degenerate frame (all
    masked out) at focal 1 and shift 0."""
    pts, _ = _pinhole(3, 56, 84, focal=0.9, shift=-0.2, noise=0.01, seed=5)
    conf = torch.randn(pts.shape[:-1] + (1,), generator=torch.Generator().manual_seed(6)) + 2
    conf[1] = -10.0
    got = estimate_camera_parameters(pts, conf)
    focal, shift = frozen.recover_focal_shift(pts, torch.sigmoid(conf[..., 0]) > 0.1)
    assert torch.equal(got["focal"], focal) and torch.equal(got["shift"], shift)
    assert got["focal"][1] == 1.0 and got["shift"][1] == 0.0
    ar = 84 / 56
    assert torch.equal(got["fx"], focal / 2 * (1 + ar**2) ** 0.5 / ar * 84)
    assert torch.equal(got["intrinsics"][:, 1, 1], focal / 2 * (1 + ar**2) ** 0.5 * 56)


def test_solve_shift_on_cpu_is_the_plain_solve_and_counts_no_launch():
    pts, mask = _pinhole(2, 20, 30, focal=1.1, shift=0.3, noise=0.02, seed=7)
    points = pts.reshape(2, -1, 3)
    uv = normalized_view_plane_uv(30, 20).reshape(-1, 2)
    weight = mask.reshape(2, -1).float()
    before = ops.launch_counts()
    got = solve_shift(points, uv, weight, iterations=12)
    assert ops.launch_counts() == before  # CPU tensors never count a launch
    for g, w in zip(got, solve_shift_plain(points, uv, weight, iterations=12)):
        assert torch.equal(g, w)
    recover_focal_shift(pts, mask)
    assert ops.launch_counts() == before


def test_the_counts_carry_focal_shift_as_a_kernel_without_an_fp32_entry():
    """The wrapper is registered: its count is reported, reset and held by
    ``uncounted`` like every other; it has one fp32 kernel and no bf16 one,
    so no ``focal_shift_fp32`` key."""
    assert ops.KERNEL_WRAPPERS["focal_shift"] is solve_shift
    assert "focal_shift" not in ops.FP32_ENTRIES
    counts = ops.launch_counts()
    assert "focal_shift" in counts and "focal_shift_fp32" not in counts
    before = solve_shift.launches
    try:
        with ops.uncounted():
            solve_shift.launches += 5
        assert solve_shift.launches == before
        solve_shift.launches = 3
        ops.reset_launch_counts()
        assert ops.launch_counts()["focal_shift"] == 0
    finally:
        solve_shift.launches = before


def test_the_solve_s_work_is_counted_from_its_shapes():
    """The bound's operations and bytes at the creator's and MoGe-2's shapes:
    142 operations a point and iteration, 14 more a point; 16 bytes a point,
    8 a uv pair and 8 a frame."""
    flops, nbytes = focal_shift_work(100, 4096, 30)
    assert flops == 100 * 4096 * (142 * 30 + 14)
    assert nbytes == 100 * 4096 * 16 + 4096 * 8 + 100 * 8
    assert focal_shift_work(1, 4096, 0) == (4096 * 14, 4096 * 24 + 8)
