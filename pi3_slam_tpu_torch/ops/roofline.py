"""The card's peaks and the least time a kernel call could take on it.

One yardstick for ``chip_smoke.py`` and ``tools/perf_lab.py``. The peaks
are the H100 SXM data sheet's: bf16 on the tensor cores, fp32 outside them,
device memory; the fp32 entries' products run on the tensor cores in TF32
(495 TFLOP/s) three times over (3xTF32). ``exp2`` runs on the
special-function units (FlashAttention-3, Shah et al. 2024, §3): at head dim
64 one ``exp2`` per logit weighs as much as the two products, so it is a
bound of its own, printed beside the products' and left out of
:func:`bound`.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_3XTF32 = 495e12 / 3
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 3.9e12


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time the card could take to
    move nbytes (each input read once, each output written once) and do
    flops at peak."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def exp2_ms(count: float) -> float:
    """The time of ``count`` exp2s on the special-function units, in ms."""
    return count / PEAK_EXP2 * 1e3


def attention_flops(b: int, h: int, tq: int, tk: int, d: int) -> float:
    """The two matrix products of attention (q.k^T and P.v), 2 flops per
    multiply-add."""
    return 4.0 * b * h * tq * tk * d


def attention_work(b: int, t: int, h: int, d: int, element_size: int) -> tuple[float, float]:
    """(flops, bytes) of self-attention over T tokens: q, k and v read and the
    output written once, each (b, t, h, d) of element_size bytes."""
    return attention_flops(b, h, t, t, d), 4 * b * t * h * d * element_size


def mlp_work(x, w1) -> tuple[float, float]:
    """(flops, bytes) of fc2(GELU(fc1 x)) (the block MLP's LayerNorm and
    residual add only bytes): x read and the output written in x's dtype,
    both weights once, the fp32 vectors."""
    hidden, c = w1.shape
    m = x.numel() // c
    e = x.element_size()
    return 4.0 * m * c * hidden, 2 * m * c * e + 2 * w1.numel() * e + (hidden + 4 * c) * 4
