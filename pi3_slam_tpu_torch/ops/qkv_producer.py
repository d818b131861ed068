"""Fused qkv producer: per-head qk-LayerNorm + RoPE2D + softmax scale + zero
row padding in one pass over the packed (B, T, 3*H*D) qkv projection.

Replaces the Pallas TPU kernel ``pi3_slam_tpu/ops/pallas_producer.py::
qkv_rope_producer_tpu`` (kernel ``_producer_kernel``). The TPU version
computed its 64-lane LayerNorm statistics with an averaging-matrix matmul and
rotated with lane rolls; on the GPU both are a plain row reduction and index
arithmetic, written here as a Triton kernel (no matrix product: one
elementwise pass with two small reductions).

Bound on the H100: bytes. At the decoder shape (100, 643, 3072) bf16 the pass
reads 395 MB and writes 395 MB with ~20 flops per element, far below the
~295 flop/byte ridge. The design reads every element once and writes it once
(the rotation partner is a second, cached load of the same 128-byte row
segment) and keeps all arithmetic in fp32 registers.

On the GPU the producer emits ``out_t = T`` (the attention kernel masks by
length, so there is no padding lattice); ``out_t > T`` with zeroed rows stays
supported for the parity tests.
"""

from __future__ import annotations

import functools
import math

import torch

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
def _triton_kernel():
    """Define the Triton kernel on first use (``triton`` exists only where
    there is a GPU; importing this module must not need it)."""
    import triton
    import triton.language as tl

    @triton.jit
    def _norm_rope(row_ptr, valid, cols, partner, sign, cs, sn,
                   w_ptr, b_ptr, eps, HAS_NORM: tl.constexpr, D: tl.constexpr):
        x = tl.load(row_ptr + cols[None, :], mask=valid[:, None], other=0.0).to(tl.float32)
        xp = tl.load(row_ptr + partner[None, :], mask=valid[:, None], other=0.0).to(tl.float32)
        if HAS_NORM:
            mean = tl.sum(x, axis=1) / D
            xc = x - mean[:, None]
            var = tl.sum(xc * xc, axis=1) / D
            rstd = 1.0 / tl.sqrt(var + eps)
            w = tl.load(w_ptr + cols).to(tl.float32)
            bb = tl.load(b_ptr + cols).to(tl.float32)
            wp = tl.load(w_ptr + partner).to(tl.float32)
            bp = tl.load(b_ptr + partner).to(tl.float32)
            x = xc * rstd[:, None] * w[None, :] + bb[None, :]
            xp = (xp - mean[:, None]) * rstd[:, None] * wp[None, :] + bp[None, :]
        return x, x * cs + sign[None, :] * xp * sn

    @triton.jit
    def producer_kernel(
        qkv_ptr, cos_ptr, sin_ptr, qw_ptr, qb_ptr, kw_ptr, kb_ptr, out_ptr, kn_ptr,
        T, OUT_T, H, eps, scale,
        HAS_NORM: tl.constexpr, WANT_KN: tl.constexpr,
        BLOCK_T: tl.constexpr, D: tl.constexpr,
    ):
        pid_t = tl.program_id(0)
        h = tl.program_id(1)
        b = tl.program_id(2).to(tl.int64)
        c = H * D
        rows = pid_t * BLOCK_T + tl.arange(0, BLOCK_T)
        cols = tl.arange(0, D)
        partner = cols ^ (D // 4)  # rotation partner within each half
        sign = tl.where((cols % (D // 2)) < (D // 4), -1.0, 1.0)
        valid = rows < T
        in_rows = qkv_ptr + (b * T + rows[:, None]) * (3 * c)
        out_rows = out_ptr + (b * OUT_T + rows[:, None]) * (3 * c)
        store_mask = (rows < OUT_T)[:, None]
        tab = (b * T + rows[:, None]) * D + cols[None, :]
        cs = tl.load(cos_ptr + tab, mask=valid[:, None], other=0.0)
        sn = tl.load(sin_ptr + tab, mask=valid[:, None], other=0.0)

        _, q = _norm_rope(in_rows + h * D, valid, cols, partner, sign, cs, sn,
                          qw_ptr, qb_ptr, eps, HAS_NORM, D)
        q = tl.where(valid[:, None], q * scale, 0.0)
        tl.store(out_rows + h * D + cols[None, :], q.to(out_ptr.dtype.element_ty), mask=store_mask)

        kpre, k = _norm_rope(in_rows + c + h * D, valid, cols, partner, sign, cs, sn,
                             kw_ptr, kb_ptr, eps, HAS_NORM, D)
        if WANT_KN:
            sq = tl.sum(tl.where(valid[:, None], kpre * kpre, 0.0), axis=1)
            tl.atomic_max(kn_ptr + b * H + h, tl.max(sq, axis=0))
        k = tl.where(valid[:, None], k, 0.0)
        tl.store(out_rows + c + h * D + cols[None, :], k.to(out_ptr.dtype.element_ty), mask=store_mask)

        v = tl.load(in_rows + 2 * c + h * D + cols[None, :], mask=valid[:, None], other=0.0)
        tl.store(out_rows + 2 * c + h * D + cols[None, :], v, mask=store_mask)

    return producer_kernel


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

    A CUDA tensor runs the Triton kernel (bf16 only); a CPU tensor runs
    :func:`qkv_rope_producer_plain`.
    """
    if not qkv.is_cuda:
        return qkv_rope_producer_plain(
            qkv, cos, sin, num_heads, out_t, q_norm_scale, q_norm_bias,
            k_norm_scale, k_norm_bias, eps, return_k_norms,
        )
    if _check(qkv, cos, sin, num_heads, out_t) != HEAD_DIM:
        raise ValueError(f"qkv_rope_producer kernel takes head dim {HEAD_DIM}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv_rope_producer kernel takes bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    b, t, c3 = qkv.shape
    dev = qkv.device
    cos = cos.to(device=dev, dtype=torch.float32).contiguous()
    sin = sin.to(device=dev, dtype=torch.float32).contiguous()
    has_norm = q_norm_scale is not None
    if has_norm:
        norm = [p.to(device=dev, dtype=torch.float32).contiguous()
                for p in (q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias)]
    else:
        norm = [cos] * 4  # never read
    out = torch.empty((b, out_t, c3), device=dev, dtype=qkv.dtype)
    kn_sq = torch.zeros((b * num_heads,), device=dev, dtype=torch.float32)
    block_t = 64
    grid = (-(-out_t // block_t), num_heads, b)
    _triton_kernel()[grid](
        qkv, cos, sin, *norm, out, kn_sq,
        t, out_t, num_heads, float(eps), HEAD_DIM**-0.5 * LOG2_E,
        HAS_NORM=has_norm, WANT_KN=return_k_norms, BLOCK_T=block_t, D=HEAD_DIM,
        num_warps=4,
    )
    qkv_rope_producer.launches += 1
    if return_k_norms:
        return out, kn_sq.sqrt()
    return out


qkv_rope_producer.launches = 0
