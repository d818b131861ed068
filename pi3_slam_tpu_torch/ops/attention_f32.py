"""The fp32 attention kernel, ``csrc/attention_f32.cu``: the float32 entries
of the attention wrappers (``packed_attention``, ``partial_attention``,
``flash_attention``), which call these launchers for fp32 CUDA tensors.

Kernels over (B, T, H, D) q / k / v read through their strides (a
unit-stride last dim, the other strides multiples of 4 elements, 16-byte
aligned bases): the packed projection's q / k / v views need no copy, at
every head dim that is a multiple of 64 (:func:`kernel_for`): head dim 64
(every fp32 launch of the main paths, the partial one too) on the TMA +
``wgmma`` tf32 loop of ``csrc/bthd_attention_f32.cuh``, every wider one on
that loop's sliced variant, O in :func:`slices` of 128 columns. See the
sources' headers for the designs (3xTF32 products on the tensor cores).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, load_library

DV = 128  # columns of O a block of csrc/bthd_attention_f32.cuh's sliced variant owns


def _check_head_dim(d: int) -> None:
    if d <= 0 or d % 64:
        raise ValueError(f"the fp32 attention kernel takes head dims that are multiples of 64, "
                         f"got {d}")


def slices(d: int) -> int:
    """The column slices of O (DV wide, the last one's columns past d unused)
    a launch at head dim d takes: 1 at 64 (the unsliced loop) and up to 128,
    ceil(d / DV) above. Raises for d not a positive multiple of 64."""
    _check_head_dim(d)
    return -(-d // DV)


def kernel_for(d: int) -> str:
    """The kernel that runs the fp32 attention at head dim d (the same
    choice as ``csrc/attention_f32.cu``'s ``pi3_attention_f32``). Raises for
    d not a positive multiple of 64."""
    _check_head_dim(d)
    return "attention_f32_tma_kernel" if d == 64 else "attention_f32_wide_tma_kernel"


@functools.cache
def _kernel(name: str):
    fn = getattr(load_library("attention_f32"), name)
    n_ptr = 4 if name == "pi3_attention_f32" else 6
    n_int = 5 if name == "pi3_attention_f32" else 4
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _strides(x: torch.Tensor, name: str, device: torch.device, what: str) -> list[int]:
    if x.device != device:
        raise ValueError(f"{what}: {name} is on {x.device}, q on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} fp32 kernel takes float32 {name}, got {x.dtype}")
    if x.stride(3) != 1 or any(s % 4 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} needs a unit-stride last dim and 16-byte aligned rows, "
                         f"got strides {x.stride()}")
    return [x.stride(0), x.stride(1), x.stride(2)]


def _operands(q, k, v, what: str) -> list[int]:
    dev = q.device
    _check_head_dim(q.shape[-1])
    return [s for x, name in ((q, "q"), (k, "k"), (v, "v")) for s in _strides(x, name, dev, what)]


def attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  what: str) -> torch.Tensor:
    """softmax_2(scale * q.k^T) . v over fp32 (B, Tq, H, D) q and (B, Tk, H,
    D) k / v on the card -> (B, Tq, H, D) fp32 contiguous; any scale."""
    strides = _operands(q, k, v, what)
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), device=q.device, dtype=torch.float32)
    code = _kernel("pi3_attention_f32")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq, k.shape[1], h, d,
        *strides, float(scale), q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(code, what)
    return out


def partial_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kn: torch.Tensor,
                          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The bound-shift partial sums (acc, l) over fp32 q / k / v at head dim
    64 on the card (``partial_attention.flash_attention_partial``'s
    contract)."""
    what = "flash_attention_partial"
    strides = _operands(q, k, v, what)
    b, tq, h, d = q.shape
    if d != 64:
        raise ValueError(f"the partial attention kernel takes head dim 64, got {d}")
    dev = q.device
    kn32 = kn.to(device=dev, dtype=torch.float32).contiguous()
    acc = torch.empty((b, tq, h, d), device=dev, dtype=torch.float32)
    l = torch.empty((b, tq, h), device=dev, dtype=torch.float32)
    code = _kernel("pi3_partial_attention_f32")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kn32.data_ptr(), acc.data_ptr(), l.data_ptr(),
        b, tq, k.shape[1], h, *strides, float(scale), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, what)
    return acc, l
