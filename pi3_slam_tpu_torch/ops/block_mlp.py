"""The MLP half of a pre-norm transformer block in one call:
out = x + ls * fc2(GELU_erf(fc1(LN(x)))).

Replaces ``pi3_slam_tpu/ops/pallas_mlp.py::block_mlp_fused_tpu``. On a CUDA
tensor it launches the hand-written kernels of ``csrc/block_mlp.cu`` (see its
header); on a CPU tensor it runs :func:`block_mlp_plain`. Weights use torch's
``nn.Linear`` layout: fc1 (hidden, C), fc2 (C, hidden).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import check_launch, load_library


def block_mlp_plain(
    x: torch.Tensor,
    norm_weight: torch.Tensor,
    norm_bias: torch.Tensor,
    fc1_weight: torch.Tensor,
    fc1_bias: torch.Tensor,
    fc2_weight: torch.Tensor,
    fc2_bias: torch.Tensor,
    ls: torch.Tensor | None = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version. LayerNorm, GELU and the residual in fp32 (the
    kernel's contract); the two products are ``F.linear`` in x's dtype."""
    x32 = x.float()
    xn = F.layer_norm(x32, x.shape[-1:], norm_weight.float(), norm_bias.float(), eps).to(x.dtype)
    h = F.linear(xn, fc1_weight.to(x.dtype), fc1_bias.to(x.dtype))
    h = F.gelu(h.float()).to(x.dtype)
    y = F.linear(h, fc2_weight.to(x.dtype), fc2_bias.to(x.dtype)).float()
    if ls is not None:
        y = y * ls.float()
    return (x32 + y).to(x.dtype)


def check_kernel_operands(
    x: torch.Tensor, fc1_weight: torch.Tensor, fc2_weight: torch.Tensor, what: str
) -> None:
    """Raise unless the kernel takes these operands, before any launch:
    bfloat16 x, C and hidden multiples of 128, weights (hidden, C) /
    (C, hidden) in bfloat16, all three contiguous on 16-byte aligned bases
    (the tensor maps' rule; their rows are then multiples of 256 bytes)."""
    c = x.shape[-1]
    hidden = fc1_weight.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bfloat16, got {x.dtype}")
    if c % 128 or hidden % 128:
        raise ValueError(f"{what} kernel needs C and hidden divisible by 128, got {c}, {hidden}")
    if tuple(fc1_weight.shape) != (hidden, c) or tuple(fc2_weight.shape) != (c, hidden):
        raise ValueError("fc1/fc2 weights must be (hidden, C) / (C, hidden)")
    for name, t in (("x", x), ("fc1 weight", fc1_weight), ("fc2 weight", fc2_weight)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous bfloat16 on a 16-byte aligned base")


@functools.cache
def _kernel():
    fn = load_library("block_mlp").pi3_block_mlp
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def block_mlp(
    x: torch.Tensor,
    norm_weight: torch.Tensor,
    norm_bias: torch.Tensor,
    fc1_weight: torch.Tensor,
    fc1_bias: torch.Tensor,
    fc2_weight: torch.Tensor,
    fc2_bias: torch.Tensor,
    ls: torch.Tensor | None = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """x (..., C) -> x + ls * mlp(layer_norm(x)); ``ls`` None means 1.

    CUDA tensors must meet :func:`check_kernel_operands`.
    """
    if not x.is_cuda:
        return block_mlp_plain(
            x, norm_weight, norm_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, ls, eps
        )
    c = x.shape[-1]
    hidden = fc1_weight.shape[0]
    dev = x.device
    w1 = fc1_weight.to(device=dev, dtype=torch.bfloat16).contiguous()
    w2 = fc2_weight.to(device=dev, dtype=torch.bfloat16).contiguous()
    check_kernel_operands(x, w1, w2, "block_mlp")

    def vec(t: torch.Tensor | None, n: int) -> torch.Tensor:
        if t is None:
            return torch.ones(n, device=dev, dtype=torch.float32)
        return t.to(device=dev, dtype=torch.float32).contiguous()

    params = [vec(norm_weight, c), vec(norm_bias, c), w1, vec(fc1_bias, hidden), w2,
              vec(fc2_bias, c), vec(ls, c)]
    m = x.numel() // c
    xn = torch.empty_like(x)
    hid = torch.empty((m, hidden), device=dev, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    code = _kernel()(
        x.data_ptr(), *(p.data_ptr() for p in params), xn.data_ptr(), hid.data_ptr(),
        out.data_ptr(), m, c, hidden, float(eps), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, "block_mlp")
    block_mlp.launches += 1
    return out


block_mlp.launches = 0
