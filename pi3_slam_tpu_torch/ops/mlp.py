"""The transformer MLP in one call: fc2(GELU_erf(fc1(x))).

Replaces ``pi3_slam_tpu/ops/pallas_mlp.py::mlp_fused_tpu``, the drop-in for
``models/layers.mlp``. On a CUDA tensor whose widths meet the kernel's rule
(:func:`mlp_kernel_supported`: C and hidden multiples of 128) it launches the
hand-written GEMMs of ``csrc/block_mlp.cu`` (entry ``pi3_mlp``, or
``pi3_mlp_f32`` for fp32 x: fc1 with the bias + GELU epilogue, then fc2 with
bias); other widths run
:func:`mlp_plain` on the card, as the JAX package runs XLA there. A CPU tensor
runs :func:`mlp_plain`. Weights use torch's ``nn.Linear`` layout: fc1
(hidden, C), fc2 (C, hidden).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import check_launch, count_launch, is_fp32, load_library
from .block_mlp import check_kernel_operands, kernel_vector


def mlp_kernel_supported(c: int, hidden: int) -> bool:
    """Widths the kernel takes (``mlp_fused_supported`` of the JAX package)."""
    return c % 128 == 0 and hidden % 128 == 0


def mlp_plain(
    x: torch.Tensor,
    fc1_weight: torch.Tensor,
    fc1_bias: torch.Tensor,
    fc2_weight: torch.Tensor,
    fc2_bias: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: the products are ``F.linear`` in x's dtype,
    GELU in fp32 (the kernel's contract), cast back before fc2."""
    h = F.linear(x, fc1_weight.to(x.dtype), fc1_bias.to(x.dtype))
    h = F.gelu(h.float()).to(x.dtype)
    return F.linear(h, fc2_weight.to(x.dtype), fc2_bias.to(x.dtype))


@functools.cache
def _kernel(name: str):
    fn = getattr(load_library("block_mlp"), name)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mlp(
    x: torch.Tensor,
    fc1_weight: torch.Tensor,
    fc1_bias: torch.Tensor,
    fc2_weight: torch.Tensor,
    fc2_bias: torch.Tensor,
) -> torch.Tensor:
    """x (..., C) -> fc2(GELU_erf(fc1(x))) (..., C).

    CUDA tensors must be bfloat16 or float32; the kernel runs when C and
    hidden are multiples of 128, and then x must meet
    :func:`~.block_mlp.check_kernel_operands` (contiguous, 16-byte aligned)."""
    c = x.shape[-1]
    hidden = fc1_weight.shape[0]
    if tuple(fc1_weight.shape) != (hidden, c) or tuple(fc2_weight.shape) != (c, hidden):
        raise ValueError("fc1/fc2 weights must be (hidden, C) / (C, hidden)")
    if not x.is_cuda:
        return mlp_plain(x, fc1_weight, fc1_bias, fc2_weight, fc2_bias)
    is_fp32(x, "mlp")
    if not mlp_kernel_supported(c, hidden):
        return mlp_plain(x, fc1_weight, fc1_bias, fc2_weight, fc2_bias)
    dev = x.device
    w1 = fc1_weight.to(device=dev, dtype=x.dtype).contiguous()
    w2 = fc2_weight.to(device=dev, dtype=x.dtype).contiguous()
    fp32 = check_kernel_operands(x, w1, w2, "mlp")
    b1, b2 = kernel_vector(fc1_bias, dev), kernel_vector(fc2_bias, dev)
    m = x.numel() // c
    hid = torch.empty((m, hidden), device=dev, dtype=x.dtype)
    out = torch.empty_like(x)
    code = _kernel("pi3_mlp_f32" if fp32 else "pi3_mlp")(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), hid.data_ptr(),
        out.data_ptr(), m, c, hidden, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, "mlp")
    count_launch(mlp, fp32)
    return out


mlp.launches = 0
mlp.launches_fp32 = 0
