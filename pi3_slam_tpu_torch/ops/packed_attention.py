"""Attention over the packed (B, T, 3*H*D) qkv layout -> (B, T, H*D).

Two entry points with the contracts of the TPU kernels they replace
(``pi3_slam_tpu/ops/pallas_attention.py``):

* :func:`flash_attention_packed` — ``flash_attention_packed_tpu``, the
  decoder's global blocks (T = N frames x 643 tokens).
* :func:`attention_single_pass_packed` — ``attention_single_pass_packed_tpu``,
  the encoder, frame and head blocks (T = 643), with an optional ``q_scale``
  on the fp32 logits for callers whose q is not pre-scaled.

On a CUDA tensor both launch one hand-written kernel,
``csrc/packed_attention.cu`` (see its header for the design); on a CPU
tensor they run the plain PyTorch version beside it. The softmax is base 2:
the producer pre-scales q by D**-0.5 * log2(e), or ``q_scale`` carries it.
Keys at index >= ``true_t`` (the producer's zero padding) are ignored and the
output has ``true_t`` rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, load_library

HEAD_DIM = 64


def _check(qkv: torch.Tensor, num_heads: int, true_t: int | None) -> int:
    """Validate shapes; returns the number of valid rows."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, T, 3*{num_heads}*D), got {tuple(qkv.shape)}")
    if qkv.is_cuda and qkv.shape[-1] != 3 * num_heads * HEAD_DIM:
        raise ValueError(f"the packed attention kernel takes head dim {HEAD_DIM}")
    t = qkv.shape[1]
    t_valid = t if true_t is None else int(true_t)
    if not 0 < t_valid <= t:
        raise ValueError(f"true_t={true_t} outside (0, T={t}]")
    return t_valid


def packed_attention_plain(
    qkv: torch.Tensor,
    num_heads: int,
    true_t: int | None = None,
    q_scale: float = 1.0,
    q_block: int = 1024,
) -> torch.Tensor:
    """Plain PyTorch version: base-2 softmax(q_scale * q.k^T) . v in fp32,
    queries processed in blocks of ``q_block`` rows (a dense logit tensor at
    T = 64,300 and 16 heads would need 264 GB)."""
    t = _check(qkv, num_heads, true_t)
    b = qkv.shape[0]
    d = qkv.shape[-1] // (3 * num_heads)
    x = qkv[:, :t].float().view(b, t, 3, num_heads, d)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))  # (B, H, t, D)
    out = torch.empty((b, t, num_heads, d), device=qkv.device, dtype=torch.float32)
    kt = k.transpose(-1, -2)
    for i in range(0, t, q_block):
        s = torch.matmul(q[:, :, i : i + q_block], kt).mul_(q_scale)
        s.sub_(s.amax(-1, keepdim=True)).exp2_()
        o = torch.matmul(s, v).div_(s.sum(-1, keepdim=True))
        out[:, i : i + q_block] = o.transpose(1, 2)
    return out.reshape(b, t, num_heads * d).to(qkv.dtype)


@functools.cache
def _kernel():
    fn = load_library("packed_attention").pi3_packed_attention
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(qkv: torch.Tensor, num_heads: int, t_valid: int, scale_log2: float, what: str):
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be contiguous and 16-byte aligned")
    b, t, _ = qkv.shape
    out = torch.empty((b, t_valid, num_heads * HEAD_DIM), device=qkv.device, dtype=qkv.dtype)
    code = _kernel()(
        qkv.data_ptr(), out.data_ptr(), b, t, num_heads, t_valid, float(scale_log2),
        qkv.device.index, torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    check_launch(code, what)
    return out


def flash_attention_packed(
    qkv: torch.Tensor,
    num_heads: int,
    true_t: int | None = None,
    kn: torch.Tensor | None = None,
) -> torch.Tensor:
    """Global-block attention over packed qkv (q pre-scaled by the producer).

    ``kn`` is the TPU contract's per-head max |k| (B*H,), which the TPU
    kernel needed for its bound-shift softmax; the Hopper kernel keeps an
    exact running max, so ``kn`` is checked for shape and otherwise unused.
    """
    t_valid = _check(qkv, num_heads, true_t)
    if kn is not None and kn.numel() != qkv.shape[0] * num_heads:
        raise ValueError(f"kn must have B*H={qkv.shape[0] * num_heads} entries")
    if not qkv.is_cuda:
        return packed_attention_plain(qkv, num_heads, t_valid)
    out = _launch(qkv, num_heads, t_valid, 1.0, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out


def attention_single_pass_packed(
    qkv: torch.Tensor,
    num_heads: int,
    true_t: int | None = None,
    q_scale: float = 1.0,
) -> torch.Tensor:
    """Frame / encoder / head-block attention over packed qkv; ``q_scale``
    multiplies the fp32 logits (the encoder passes D**-0.5 * log2(e))."""
    t_valid = _check(qkv, num_heads, true_t)
    if not qkv.is_cuda:
        return packed_attention_plain(qkv, num_heads, t_valid, q_scale)
    out = _launch(qkv, num_heads, t_valid, q_scale, "attention_single_pass_packed")
    attention_single_pass_packed.launches += 1
    return out


flash_attention_packed.launches = 0
attention_single_pass_packed.launches = 0
