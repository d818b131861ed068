"""The focal / shift solve: a fixed-iteration damped Gauss-Newton over each
frame's scalar z-shift, batched over frames.

Given a pointmap P = (x, y, z) and the normalised view-plane uv, it
minimises |f * xy / (z + shift) - uv|^2 with f in closed form for each
shift. The JAX package differentiates the loss with jax.grad and
jax.jacfwd inside a lax.scan that XLA compiles into one program
(``pi3_slam_tpu/geometry/focal.py::_solve_shift_single``); here the first and
second derivatives in the shift are written out in closed form for all
frames at once (the same quantities: the loss is a rational function of one
scalar).

On a CUDA tensor :func:`solve_shift` launches the kernel of
``csrc/focal_shift.cu`` (its header has the design and the bound): the whole
solve in one launch, where :func:`solve_shift_plain`, run eagerly, makes
~5,600 small launches. On a CPU tensor it runs :func:`solve_shift_plain`.
Both compute in fp32 (TF32 is off, see ``device.py``; the kernel is built
without fused multiply-adds).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, count_launch, load_library


def _loss_and_derivatives(shift, xy, z, uv, w):
    """Per frame: loss L(shift) = sum (w * (f * xy/(z+shift) - uv))^2 with
    f = <w a, uv> / max(<w a, a>, 1e-12), a = xy / (z + shift); its first and
    second derivatives in shift; and f. shift (F,), xy (F, M, 2), z (F, M),
    uv (M, 2), w (F, M)."""
    d = z + shift[:, None]
    live = d.abs() >= 1e-12  # clamped denominators are constant in the shift
    d = torch.where(live, d, torch.full_like(d, 1e-12))[..., None]
    live = live[..., None].to(d.dtype)
    a = xy / d  # (F, M, 2) and its shift derivatives
    a1 = -a / d * live
    a2 = 2 * a / (d * d) * live
    wv = w[..., None]

    def total(x):
        return x.sum(dim=(1, 2))

    A, A1, A2 = total(wv * a * uv), total(wv * a1 * uv), total(wv * a2 * uv)
    b_raw = total(wv * a * a)
    b_live = (b_raw >= 1e-12).to(d.dtype)  # max(B, 1e-12) is constant below
    B = b_raw.clamp_min(1e-12)
    B1 = 2 * total(wv * a * a1) * b_live
    B2 = 2 * total(wv * (a1 * a1 + a * a2)) * b_live
    f = A / B
    num1 = A1 * B - A * B1
    f1 = num1 / (B * B)
    f2 = (A2 * B - A * B2) / (B * B) - 2 * B1 * num1 / (B * B * B)
    f, f1, f2 = f[:, None, None], f1[:, None, None], f2[:, None, None]
    r = f * a - uv
    r1 = f1 * a + f * a1
    r2 = f2 * a + 2 * f1 * a1 + f * a2
    w2 = wv * wv
    return total(w2 * r * r), 2 * total(w2 * r * r1), 2 * total(w2 * (r1 * r1 + r * r2)), f[:, 0, 0]


def solve_shift_plain(points, uv, weight, iterations: int = 30):
    """Damped-GN solve for every frame at once, in eager PyTorch. points
    (F, M, 3), uv (M, 2), weight (F, M) in {0, 1} -> (focal (F,), shift (F,))."""
    xy = points[..., :2]
    z = points[..., 2]
    w = weight.to(points.dtype)
    n = points.shape[0]
    shift = torch.zeros(n, dtype=points.dtype, device=points.device)
    lam = torch.full((n,), 1e-3, dtype=points.dtype, device=points.device)
    for _ in range(iterations):
        loss, g, h, _ = _loss_and_derivatives(shift, xy, z, uv, w)
        h_safe = torch.where(h.abs() < 1e-12, torch.full_like(h, 1e-12), h)
        new_shift = shift - g / (h_safe + lam * h_safe.abs())
        improved = _loss_and_derivatives(new_shift, xy, z, uv, w)[0] < loss
        shift = torch.where(improved, new_shift, shift)
        lam = torch.where(improved, (lam * 0.5).clamp_min(1e-6), lam * 4.0)
    focal = _loss_and_derivatives(shift, xy, z, uv, w)[3]
    # degenerate frame (fewer than 2 valid pixels): focal 1, shift 0
    valid = w.sum(-1) >= 2
    return torch.where(valid, focal, torch.ones_like(focal)), torch.where(
        valid, shift, torch.zeros_like(shift)
    )


# the most points a frame the kernel holds (16 a thread, 512 threads)
MAX_POINTS = 8192


@functools.cache
def _kernel():
    fn = load_library("focal_shift").pi3_focal_shift
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def solve_shift(points: torch.Tensor, uv: torch.Tensor, weight: torch.Tensor,
                iterations: int = 30) -> tuple[torch.Tensor, torch.Tensor]:
    """(focal (F,), shift (F,)) of points (F, M, 3), uv (M, 2), weight (F, M)
    in {0, 1}: :func:`solve_shift_plain`'s solve.

    A CUDA tensor runs the kernel of ``csrc/focal_shift.cu`` in one launch
    and does not wait for it (float32 points and uv on one device, M <=
    8192; the weight is taken in float32; anything else raises); a CPU tensor
    runs :func:`solve_shift_plain`."""
    if not points.is_cuda:
        return solve_shift_plain(points, uv, weight, iterations)
    n, m = points.shape[:2] if points.dim() == 3 else (-1, -1)
    if n < 0 or points.shape[2] != 3 or tuple(uv.shape) != (m, 2) or tuple(
            weight.shape) != (n, m):
        raise ValueError(f"solve_shift takes points (F, M, 3), uv (M, 2), weight (F, M); got "
                         f"{tuple(points.shape)}, {tuple(uv.shape)}, {tuple(weight.shape)}")
    if points.dtype != torch.float32 or uv.dtype != torch.float32:
        raise TypeError(f"focal_shift kernel takes float32, got {points.dtype} and {uv.dtype}")
    if not 1 <= m <= MAX_POINTS:
        raise ValueError(f"focal_shift kernel takes 1 to {MAX_POINTS} points a frame, got {m}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    dev = points.device
    if uv.device != dev or weight.device != dev:
        raise ValueError("solve_shift: points, uv and weight must be on one device")
    focal = torch.empty(n, device=dev, dtype=torch.float32)
    shift = torch.empty(n, device=dev, dtype=torch.float32)
    if n == 0:
        return focal, shift
    points, uv = points.contiguous(), uv.contiguous()
    weight = weight.to(torch.float32).contiguous()
    code = _kernel()(
        points.data_ptr(), uv.data_ptr(), weight.data_ptr(), focal.data_ptr(), shift.data_ptr(),
        n, m, iterations, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, "focal_shift")
    count_launch(solve_shift, fp32=False)
    return focal, shift


solve_shift.launches = 0
