"""Dots-only packed attention: the speed-of-light probe's twin of the packed
flash kernel, over the packed (B, T, 3*H*64) qkv layout -> (B, T, H*64).

Contract of the TPU kernel it replaces (``tools/perf_lab.py::bench_sol``,
``dots_kernel``): per head h,

    out[b, t, h*64:(h+1)*64] = bf16( sum_k bf16(q_h[t] . k_h[k]) * v_h[k] )

with both products accumulated in fp32, no softmax and no scale. q, k and v
sit at column offsets 0, H*64 and 2*H*64.

On a CUDA tensor :func:`dots_attention` launches the hand-written kernel
``csrc/dots_attention.cu`` (see its header: the products-only mode of the
TMA + ``wgmma`` loop of ``csrc/bthd_attention.cuh``); on a CPU tensor it runs
:func:`dots_attention_plain`, two ``torch.matmul`` calls per 1024-query block
over the whole key range (bf16 in, fp32 accumulate, bf16 logits and output:
the contract's rounding). On the card those two calls are cuBLAS's, so the
plain version's time is also the library's time for the same products.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, count_launch, load_library

HEAD_DIM = 64
Q_BLOCK = 1024  # queries per block of the plain version


def _check(qkv: torch.Tensor, num_heads: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"qkv must be (B, T, 3*{num_heads}*{HEAD_DIM}), got {tuple(qkv.shape)}")


def dots_attention_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: per 1024-query block, logits = q . k^T and
    out = logits . v, each a ``torch.matmul`` in the input dtype."""
    _check(qkv, num_heads)
    b, t, _ = qkv.shape
    x = qkv.view(b, t, 3, num_heads, HEAD_DIM)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, T, 64)
    kt = k.transpose(-1, -2)
    out = torch.empty((b, t, num_heads, HEAD_DIM), device=qkv.device, dtype=qkv.dtype)
    for i in range(0, t, Q_BLOCK):
        logits = torch.matmul(q[:, :, i : i + Q_BLOCK], kt)
        out[:, i : i + Q_BLOCK] = torch.matmul(logits, v).transpose(1, 2)
    return out.reshape(b, t, num_heads * HEAD_DIM)


@functools.cache
def _kernel():
    fn = load_library("dots_attention").pi3_dots_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dots_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, 3*H*64) -> (B, T, H*64). CUDA tensors must be bfloat16,
    contiguous and 16-byte aligned."""
    _check(qkv, num_heads)
    if not qkv.is_cuda:
        return dots_attention_plain(qkv, num_heads)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"dots_attention kernel takes bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("dots_attention: qkv must be contiguous and 16-byte aligned")
    b, t, _ = qkv.shape
    out = torch.empty((b, t, num_heads * HEAD_DIM), device=qkv.device, dtype=qkv.dtype)
    code = _kernel()(qkv.data_ptr(), out.data_ptr(), b, t, num_heads, qkv.device.index,
                     torch.cuda.current_stream(qkv.device).cuda_stream)
    check_launch(code, "dots_attention")
    count_launch(dots_attention, False)
    return out


dots_attention.launches = 0
