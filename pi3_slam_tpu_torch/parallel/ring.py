"""Sequence-parallel ring attention over the sp devices of a mesh.

Port of ``pi3_slam_tpu/parallel/ring.py``. The global attention's tokens are
split over sp devices; each device keeps its query shard while the key /
value shards move one device along the ring after every step, so after sp
steps every query shard has met every key shard.

The bound-shifted softmax makes the ring exact without an online-softmax
state: the row shift m_r = min(|q_r| * D**-0.5 * log2(e) * max_c |k_c| + 1,
120) uses the GLOBAL max key norm (a max over the shards before the ring), so
every step's partial numerator and denominator

    acc_r += sum_j 2**(s_rj - m_r) * v_j        l_r += sum_j 2**(s_rj - m_r)

add in one fixed base: no running max, no rescale, and the sum does not
depend on the order of the steps. Zero-padded tail keys add exactly
2**(-m_r) each to l and nothing to acc; they are taken out by their count at
the end.

On CUDA tensors each step is row 5's kernel,
``ops.partial_attention.flash_attention_partial`` (a counted launch; it
raises for a dtype or head dim it has no kernel for); CPU tensors run the
JAX package's plain step (the einsum in the inputs' dtype with fp32
accumulation).
"""

from __future__ import annotations

import math

import torch

from ..ops.partial_attention import MAX_SHIFT, flash_attention_partial

LOG2_E = math.log2(math.e)


def _plain_step(q, kc, vc, m_hat, scale):
    """One step's (acc, l) without the kernel, as the JAX ring's einsum step:
    logits of the q scaled in its dtype, P cast to v's dtype."""
    qs = (q * torch.tensor(scale, dtype=q.dtype)).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bqhk", qs.float(), kc.float())
    p = torch.exp2(logits - m_hat).to(vc.dtype)
    acc = torch.einsum("bqhk,bkhd->bqhd", p.float(), vc.float())
    return acc, p.float().sum(dim=-1, keepdim=True)


def ring_attention(q_shards: list, k_shards: list, v_shards: list, n_pad: int = 0) -> list:
    """Exact attention over sequence shards. q / k / v: the sp shards
    (B, T/sp, H, D), shard s on its ring device; ``n_pad``: the number of
    zero-padded tail keys in the whole sequence. Returns the output shards
    (B, T/sp, H, D), each on its query shard's device."""
    sp = len(q_shards)
    _, _, _, D = q_shards[0].shape
    scale = D**-0.5 * LOG2_E
    lead = q_shards[0].device

    # the global per-(b, h) max key norm, then each shard's row shifts
    kn = None
    for k in k_shards:
        loc = k.float().square().sum(-1).amax(dim=1).sqrt().to(lead)  # (B, H)
        kn = loc if kn is None else torch.maximum(kn, loc)
    kns = [kn.to(q.device) for q in q_shards]
    m_hat = []
    for q, kn_s in zip(q_shards, kns):
        qn = (q.float() * scale).square().sum(-1).sqrt()  # (B, Tq, H)
        m_hat.append((qn * kn_s[:, None, :] + 1.0).clamp_max(MAX_SHIFT)[..., None])

    use_kernel = q_shards[0].is_cuda
    acc = [torch.zeros(q.shape, device=q.device, dtype=torch.float32) for q in q_shards]
    l = [torch.zeros((*q.shape[:3], 1), device=q.device, dtype=torch.float32) for q in q_shards]
    kc, vc = list(k_shards), list(v_shards)
    for step in range(sp):
        for s, q in enumerate(q_shards):
            if use_kernel:
                a, ls = flash_attention_partial(q, kc[s], vc[s], kns[s])
                acc[s] += a
                l[s] += ls[..., None]
            else:
                a, ls = _plain_step(q, kc[s], vc[s], m_hat[s], scale)
                acc[s] += a
                l[s] += ls
        if step < sp - 1:  # shard s takes what shard s - 1 held
            kc = [kc[s - 1].to(q.device) for s, q in enumerate(q_shards)]
            vc = [vc[s - 1].to(q.device) for s, q in enumerate(q_shards)]

    outs = []
    for q, a, ls, m in zip(q_shards, acc, l, m_hat):
        denom = ls - n_pad * torch.exp2(-m)
        outs.append((a / denom.clamp_min(1e-30)).to(q.dtype))
    return outs
