"""The MLP half of a pre-norm transformer block in one call:
out = x + ls * fc2(GELU_erf(fc1(LN(x)))).

Replaces ``pi3_slam_tpu/ops/pallas_mlp.py::block_mlp_fused_tpu``. On a CUDA
tensor it launches the hand-written kernels of ``csrc/block_mlp.cu`` (see its
header): the bf16 entry, or for fp32 x the fp32 one (``csrc/gemm_f32.cuh``,
fp32 throughout, as the JAX package runs the Pallas kernel on an fp32
model); any other dtype raises. On a CPU tensor it runs
:func:`block_mlp_plain`. Weights use torch's
``nn.Linear`` layout: fc1 (hidden, C), fc2 (C, hidden).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import check_launch, count_launch, is_fp32, load_library


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
) -> bool:
    """Raise unless the kernel takes these operands, before any launch:
    bfloat16 or float32 x, C and hidden multiples of 128, weights (hidden,
    C) / (C, hidden) in x's dtype, all three contiguous on 16-byte aligned
    bases (the tensor maps' and cp.async's rule; their rows are then
    multiples of 256 bytes). Returns whether the fp32 entry takes them."""
    c = x.shape[-1]
    hidden = fc1_weight.shape[0]
    fp32 = is_fp32(x, what)
    if c % 128 or hidden % 128:
        raise ValueError(f"{what} kernel needs C and hidden divisible by 128, got {c}, {hidden}")
    if tuple(fc1_weight.shape) != (hidden, c) or tuple(fc2_weight.shape) != (c, hidden):
        raise ValueError("fc1/fc2 weights must be (hidden, C) / (C, hidden)")
    for name, t in (("fc1 weight", fc1_weight), ("fc2 weight", fc2_weight)):
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, x {x.dtype}")
    for name, t in (("x", x), ("fc1 weight", fc1_weight), ("fc2 weight", fc2_weight)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous on a 16-byte aligned base")
    return fp32


def kernel_vector(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A bias, norm scale or LayerScale as the kernels read it: fp32,
    contiguous, on a 16-byte aligned base (their vector loads fault on any
    other), copied where it is not; a view into a flat state buffer may lie
    at any offset."""
    t = t.to(device=dev, dtype=torch.float32).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@functools.cache
def _kernel(name: str):
    fn = getattr(load_library("block_mlp"), name)
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
    w1 = fc1_weight.to(device=dev, dtype=x.dtype).contiguous()
    w2 = fc2_weight.to(device=dev, dtype=x.dtype).contiguous()
    fp32 = check_kernel_operands(x, w1, w2, "block_mlp")

    def vec(t: torch.Tensor | None, n: int) -> torch.Tensor:
        if t is None:
            return torch.ones(n, device=dev, dtype=torch.float32)
        return kernel_vector(t, dev)

    params = [vec(norm_weight, c), vec(norm_bias, c), w1, vec(fc1_bias, hidden), w2,
              vec(fc2_bias, c), vec(ls, c)]
    m = x.numel() // c
    xn = torch.empty_like(x)
    hid = torch.empty((m, hidden), device=dev, dtype=x.dtype)
    out = torch.empty_like(x)
    code = _kernel("pi3_block_mlp_f32" if fp32 else "pi3_block_mlp")(
        x.data_ptr(), *(p.data_ptr() for p in params), xn.data_ptr(), hid.data_ptr(),
        out.data_ptr(), m, c, hidden, float(eps), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, "block_mlp")
    count_launch(block_mlp, fp32)
    return out


block_mlp.launches = 0
block_mlp.launches_fp32 = 0
