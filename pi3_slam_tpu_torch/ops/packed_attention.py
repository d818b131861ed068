"""Attention over the packed (B, T, 3*H*D) qkv layout -> (B, T, H*D).

Two entry points with the contracts of the TPU kernels they replace
(``pi3_slam_tpu/ops/pallas_attention.py``):

* :func:`flash_attention_packed` — ``flash_attention_packed_tpu``, the
  decoder's global blocks (T = N frames x 643 tokens).
* :func:`attention_single_pass_packed` — ``attention_single_pass_packed_tpu``,
  the encoder, frame and head blocks (T = 643), with an optional ``q_scale``
  on the fp32 logits for callers whose q is not pre-scaled.

On a CUDA tensor both launch a hand-written kernel: bf16 qkv
``csrc/packed_attention.cu`` (see its header for the design), fp32 qkv the
fp32 kernel ``csrc/attention_f32.cu`` over the projection's q / k / v views
(``ops/attention_f32.py``), as the JAX package runs its Pallas kernels on an
fp32 model's activations; any other dtype raises. On a CPU tensor they run
the plain PyTorch version beside them. The softmax is base 2:
the producer pre-scales q by D**-0.5 * log2(e), or ``q_scale`` carries it.
Keys at index >= ``true_t`` (the producer's zero padding) are ignored and the
output has ``true_t`` rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, count_launch, is_fp32, load_library
from .attention_f32 import attention_f32

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
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{what}: qkv must be contiguous and 16-byte aligned")
    b, t, _ = qkv.shape
    if is_fp32(qkv, what):
        q, k, v = qkv.view(b, t, 3, num_heads, HEAD_DIM)[:, :t_valid].unbind(2)
        out = attention_f32(q, k, v, scale_log2, what)
        return out.view(b, t_valid, num_heads * HEAD_DIM)
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
    count_launch(flash_attention_packed, qkv.dtype == torch.float32)
    return out


def positive_scale(qkv: torch.Tensor, q_scale: float) -> tuple[torch.Tensor, float]:
    """(qkv', s) with s > 0 and the same logits s * q'.k as q_scale * q.k:
    the kernel keeps its running max on the unscaled logits, so it needs a
    positive scale. A negative scale is its magnitude on a copy with q
    negated; a zero scale is 1 on a copy with q zeroed (every logit 0, so
    uniform weights: a scale of 0 itself would make the kernel's first
    rescale exp2(-inf * 0) = NaN). A positive scale returns qkv itself."""
    if not q_scale <= 0:
        return qkv, q_scale
    qkv = qkv.clone()
    q = qkv[..., : qkv.shape[-1] // 3]
    if q_scale == 0:
        q.zero_()
        return qkv, 1.0
    q.neg_()
    return qkv, -q_scale


def attention_single_pass_packed(
    qkv: torch.Tensor,
    num_heads: int,
    true_t: int | None = None,
    q_scale: float = 1.0,
) -> torch.Tensor:
    """Frame / encoder / head-block attention over packed qkv; ``q_scale``
    multiplies the fp32 logits (the encoder passes D**-0.5 * log2(e)) and
    may take any value (in bf16 through :func:`positive_scale`)."""
    t_valid = _check(qkv, num_heads, true_t)
    if not qkv.is_cuda:
        return packed_attention_plain(qkv, num_heads, t_valid, q_scale)
    if qkv.dtype == torch.bfloat16:  # the fp32 kernel scales before its max: any scale
        qkv, q_scale = positive_scale(qkv, q_scale)
    out = _launch(qkv, num_heads, t_valid, q_scale, "attention_single_pass_packed")
    count_launch(attention_single_pass_packed, qkv.dtype == torch.float32)
    return out


flash_attention_packed.launches = 0
attention_single_pass_packed.launches = 0
flash_attention_packed.launches_fp32 = 0
attention_single_pass_packed.launches_fp32 = 0
