"""Scaled dot-product attention over (B, T, H, D) tensors.

Port of ``pi3_slam_tpu/ops/attention.py``. :func:`sdpa` routes by shape
alone, before any launch (:func:`sdpa_route`), with the JAX dispatch's "on
TPU" read as "on CUDA":

* T >= 4096: the flash kernel on CUDA when D % 64 == 0, else
  :func:`~.flash_attention.blockwise_attention` (O(T * block) memory).
* 256 <= T <= 1280, D % 64 == 0, CUDA: the single-pass entry point.
* 1280 < T < 4096, D % 64 == 0, CUDA: the flash entry point.
* otherwise :func:`sdpa_reference` in plain torch on the tensor's device (the
  JAX package's XLA route, ``jax.nn.dot_product_attention``).

T is the query length. A kernel that cannot build or launch raises; nothing
falls back.
"""

from __future__ import annotations

import torch

from .flash_attention import attention_single_pass, blockwise_attention, flash_attention

# Sequences at least this long never materialise the (Tq, Tk) logits.
LONG_SEQUENCE_THRESHOLD = 4096
# From here up to SINGLE_PASS_MAX_T the single-pass entry point takes them.
MEDIUM_SEQUENCE_THRESHOLD = 256
SINGLE_PASS_MAX_T = 1280


def sdpa_route(t: int, d: int, is_cuda: bool) -> str:
    """The route of :func:`sdpa` for query length t and head dim d, on a
    CUDA tensor or not: "flash", "single_pass", "blockwise" or "plain"."""
    kernel = is_cuda and d % 64 == 0
    if t >= LONG_SEQUENCE_THRESHOLD:
        return "flash" if kernel else "blockwise"
    if kernel and t >= MEDIUM_SEQUENCE_THRESHOLD:
        return "single_pass" if t <= SINGLE_PASS_MAX_T else "flash"
    return "plain"


def sdpa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, implementation: str | None = None
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, T, H, D) -> (B, Tq, H, D).
    ``implementation`` exists for the JAX signature and must be None."""
    if implementation is not None:
        raise ValueError(f"sdpa takes implementation=None only, got {implementation!r}")
    route = sdpa_route(q.shape[1], q.shape[-1], q.is_cuda)
    if route == "flash":
        return flash_attention(q, k, v)
    if route == "single_pass":
        return attention_single_pass(q, k, v)
    if route == "blockwise":
        return blockwise_attention(q, k, v)
    return sdpa_reference(q, k, v)


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Explicit einsum version: logits in q's dtype, softmax in fp32, weights
    cast back to q's dtype."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention_score_matrix(
    q: torch.Tensor, k: torch.Tensor, frame_num: int, token_length: int
) -> torch.Tensor:
    """Frame-to-frame affinity (the reference's ``get_attn_score``):
    head-summed raw scores averaged over token blocks -> (B, frame_num,
    frame_num)."""
    d = q.shape[-1]
    score = torch.einsum("bqhd,bkhd->bqk", q * d**-0.5, k)  # sum over heads
    b = q.shape[0]
    score = score.reshape(b, frame_num, token_length, frame_num, token_length)
    return score.mean(dim=(2, 4))
