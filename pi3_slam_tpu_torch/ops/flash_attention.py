"""softmax(q.k^T / sqrt(D)).v over (B, T, H, D) tensors.

Two entry points with the contracts of the TPU kernels they replace
(``pi3_slam_tpu/ops/pallas_attention.py``), which ``ops/attention.py::sdpa``
routes to by sequence length:

* :func:`flash_attention` — ``flash_attention_tpu`` (T > 1280).
* :func:`attention_single_pass` — ``attention_single_pass_tpu``
  (256 <= T <= 1280).

On a CUDA tensor both launch a hand-written kernel that reads q, k and v
through their strides (a unit-stride last dim and 16-byte aligned rows, such
as the q / k / v views of a qkv projection): bf16 ``csrc/attention.cu`` (see
its header) at every head dim that is a multiple of 64, 64 to 256 on the TMA
+ ``wgmma`` loop of ``csrc/bthd_attention.cuh``, wider head dims on its wide
variant (column slices of O); fp32 ``csrc/attention_f32.cu`` at the same head
dims, 64 to 256 in one pass and wider ones in column slices of O. Any other
dtype raises. On a CPU tensor both run :func:`blockwise_attention`, the
kernel's plain version.

Keys are masked by length, so Tk may differ from Tq on every route. The JAX
kernels and ``blockwise_attention`` assume Tk == Tq (they pad k to q's
lattice).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import check_launch, count_launch, is_fp32, load_library
from .attention_f32 import attention_f32

LOG2_E = math.log2(math.e)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, T, H, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d) or k.shape[1] < 1:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q {tuple(q.shape)}")


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_size: int = 1024
) -> torch.Tensor:
    """Online softmax over key blocks of ``block_size`` (the JAX package's
    ``blockwise_attention``), O(Tq * block) memory, fp32 accumulation; the
    plain version of :func:`flash_attention` and :func:`attention_single_pass`.

    The logits are fp32 products of the inputs scaled by D**-0.5 (the
    kernel's order; the JAX version scales q in its own dtype first), and P
    is cast to the input dtype for the PV product, as in both. Returns
    (B, Tq, H, D) in q's dtype."""
    _check(q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    q32 = q.float().transpose(1, 2)  # (B, H, Tq, D)
    acc = torch.zeros((b, h, tq, d), device=q.device, dtype=torch.float32)
    row_max = torch.full((b, h, tq, 1), -math.inf, device=q.device, dtype=torch.float32)
    row_sum = torch.zeros((b, h, tq, 1), device=q.device, dtype=torch.float32)
    for j in range(0, tk, block_size):
        kb = k[:, j : j + block_size].float().permute(0, 2, 3, 1)  # (B, H, D, bs)
        vb = v[:, j : j + block_size].transpose(1, 2)  # (B, H, bs, D)
        logits = torch.matmul(q32, kb).mul_(d**-0.5)
        new_max = torch.maximum(row_max, logits.amax(-1, keepdim=True))
        correction = torch.exp(row_max - new_max)  # 0 on the first block
        p = logits.sub_(new_max).exp_()
        row_sum = row_sum * correction + p.sum(-1, keepdim=True)
        acc = acc * correction + torch.matmul(p.to(q.dtype).float(), vb.float())
        row_max = new_max
    out = acc / row_sum.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


@functools.cache
def _kernel():
    fn = load_library("attention").pi3_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _strides(x: torch.Tensor, name: str, device: torch.device, what: str) -> tuple[int, int, int]:
    if x.device != device:
        raise ValueError(f"{what}: {name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bfloat16 {name}, got {x.dtype}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} needs a unit-stride last dim and 16-byte aligned rows, "
                         f"got strides {x.stride()}")
    return x.stride(0), x.stride(1), x.stride(2)


def _launch(entry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, what: str) -> torch.Tensor:
    b, tq, h, d = q.shape
    if d % 64:
        raise ValueError(f"the {what} kernel takes head dims that are multiples of 64, got {d}")
    if is_fp32(q, what):
        out = attention_f32(q, k, v, d**-0.5 * LOG2_E, what)
        count_launch(entry, True)
        return out
    dev = q.device
    strides = [s for x, name in ((q, "q"), (k, "k"), (v, "v")) for s in _strides(x, name, dev, what)]
    out = torch.empty((b, tq, h, d), device=dev, dtype=q.dtype)
    code = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq, k.shape[1], h, d,
        *strides, float(d**-0.5 * LOG2_E), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, what)
    count_launch(entry, False)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, Tq, H, D), k / v (B, Tk, H, D) -> (B, Tq, H, D); the long
    sequences (T > 1280) of ``sdpa``. CUDA tensors must be bfloat16 or
    float32 with D a multiple of 64."""
    _check(q, k, v)
    if not q.is_cuda:
        return blockwise_attention(q, k, v)
    return _launch(flash_attention, q, k, v, "flash_attention")


def attention_single_pass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same function for the frame-length sequences (256 <= T <= 1280) of
    ``sdpa``; on the card it launches the same kernel as
    :func:`flash_attention`."""
    _check(q, k, v)
    if not q.is_cuda:
        return blockwise_attention(q, k, v)
    return _launch(attention_single_pass, q, k, v, "attention_single_pass")


flash_attention.launches = 0
attention_single_pass.launches = 0
flash_attention.launches_fp32 = 0
attention_single_pass.launches_fp32 = 0
