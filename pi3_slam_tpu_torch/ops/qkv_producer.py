"""Fused qkv producer: per-head qk-LayerNorm + RoPE2D + softmax scale + zero
row padding in one pass over the packed (B, T, 3*H*D) qkv projection.

Replaces the Pallas TPU kernel ``pi3_slam_tpu/ops/pallas_producer.py::
qkv_rope_producer_tpu`` (kernel ``_producer_kernel``). On a CUDA tensor
:func:`qkv_rope_producer` launches the hand-written kernel of
``csrc/qkv_producer.cu`` (its header has the design and the bound: bytes,
one read and one write of the tensor), in bf16 or, for an fp32 model's rows,
its fp32 entry (any other dtype raises); on a CPU tensor it runs
:func:`qkv_rope_producer_plain`.

On the GPU the producer emits ``out_t = T`` (the attention kernel masks by
length, so there is no padding lattice); ``out_t > T`` with zeroed rows stays
supported for the parity tests.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import check_launch, count_launch, is_fp32, load_library

LOG2_E = math.log2(math.e)
HEAD_DIM = 64


def _check(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, num_heads: int, out_t: int):
    """Validate shapes; returns the head dim D."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, T, 3*{num_heads}*D), got {tuple(qkv.shape)}")
    b, t, c3 = qkv.shape
    d = c3 // (3 * num_heads)
    if out_t < t:
        raise ValueError(f"out_t={out_t} < T={t}")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tuple(tab.shape) != (b, t, d):
            raise ValueError(f"{name} must be ({b}, {t}, {d}), got {tuple(tab.shape)}")
    return d


def qkv_rope_producer_plain(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    out_t: int,
    q_norm_scale: torch.Tensor | None = None,
    q_norm_bias: torch.Tensor | None = None,
    k_norm_scale: torch.Tensor | None = None,
    k_norm_bias: torch.Tensor | None = None,
    eps: float = 1e-5,
    return_k_norms: bool = False,
):
    """Plain PyTorch version of :func:`qkv_rope_producer` (fp32 arithmetic;
    any even head dim D, where the kernel takes D = 64)."""
    from .rope import rotate_pairs

    d = _check(qkv, cos, sin, num_heads, out_t)
    b, t, c3 = qkv.shape
    x = qkv.float().view(b, t, 3, num_heads, d)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    if q_norm_scale is not None:
        q = torch.nn.functional.layer_norm(q, (d,), q_norm_scale.float(), q_norm_bias.float(), eps)
        k = torch.nn.functional.layer_norm(k, (d,), k_norm_scale.float(), k_norm_bias.float(), eps)
    kn = (k * k).sum(-1).amax(1).sqrt().reshape(b * num_heads) if return_k_norms else None
    c = cos.float()[:, :, None, :]
    s = sin.float()[:, :, None, :]
    q = (q * c + rotate_pairs(q) * s) * (d**-0.5 * LOG2_E)
    k = k * c + rotate_pairs(k) * s
    out = torch.stack([q, k, v], dim=2).reshape(b, t, c3).to(qkv.dtype)
    if out_t > t:
        out = torch.nn.functional.pad(out, (0, 0, 0, out_t - t))
    return (out, kn) if return_k_norms else out


@functools.cache
def _kernel(name: str):
    fn = getattr(load_library("qkv_producer"), name)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def qkv_rope_producer(
    qkv: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    num_heads: int,
    out_t: int,
    q_norm_scale: torch.Tensor | None = None,
    q_norm_bias: torch.Tensor | None = None,
    k_norm_scale: torch.Tensor | None = None,
    k_norm_bias: torch.Tensor | None = None,
    eps: float = 1e-5,
    return_k_norms: bool = False,
):
    """Fused qk-norm + RoPE + scale + zero padding over packed qkv.

    qkv (B, T, 3*H*D), lane order (3, H, D); cos/sin (B, T, D) from
    ``rope_tables``; norm params (D,) per-head LayerNorm or None (head
    blocks). Returns (B, out_t, 3C): q normed, rotated and scaled by
    D**-0.5 * log2(e), k normed and rotated, v copied, rows >= T zero. With
    ``return_k_norms`` also the per-head max |k| (B*H,) fp32 (post-norm;
    RoPE preserves norms).

    A CUDA tensor runs the kernel of ``csrc/qkv_producer.cu`` (bfloat16 or
    float32, head dim 64, qkv and the fp32 tables and norm parameters
    contiguous on 16-byte aligned bases; anything else raises); a CPU tensor
    runs :func:`qkv_rope_producer_plain`.
    """
    if not qkv.is_cuda:
        return qkv_rope_producer_plain(
            qkv, cos, sin, num_heads, out_t, q_norm_scale, q_norm_bias,
            k_norm_scale, k_norm_bias, eps, return_k_norms,
        )
    if _check(qkv, cos, sin, num_heads, out_t) != HEAD_DIM:
        raise ValueError(f"qkv_rope_producer kernel takes head dim {HEAD_DIM}")
    fp32 = is_fp32(qkv, "qkv_rope_producer")
    b, t, c3 = qkv.shape
    dev = qkv.device
    cos, sin = (x.to(device=dev, dtype=torch.float32).contiguous() for x in (cos, sin))
    norm = [] if q_norm_scale is None else [
        p.to(device=dev, dtype=torch.float32).contiguous()
        for p in (q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias)]
    # 16-byte vector loads: every base aligned, qkv contiguous (the others are made so)
    if not qkv.is_contiguous() or any(x.data_ptr() % 16 for x in (qkv, cos, sin, *norm)):
        raise ValueError("qkv_rope_producer kernel needs contiguous qkv and 16-byte aligned bases")
    ptrs = [p.data_ptr() for p in norm] or [None] * 4
    out = torch.empty((b, out_t, c3), device=dev, dtype=qkv.dtype)
    kn_sq = torch.zeros((b * num_heads,), device=dev, dtype=torch.float32) if return_k_norms else None
    code = _kernel("pi3_qkv_producer_f32" if fp32 else "pi3_qkv_producer")(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), *ptrs, out.data_ptr(),
        None if kn_sq is None else kn_sq.data_ptr(), b, t, out_t, num_heads, float(eps),
        HEAD_DIM**-0.5 * LOG2_E, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, "qkv_rope_producer")
    count_launch(qkv_rope_producer, fp32)
    if return_k_norms:
        return out, kn_sq.sqrt()
    return out


qkv_rope_producer.launches = 0
qkv_rope_producer.launches_fp32 = 0
