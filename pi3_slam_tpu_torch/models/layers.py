"""Transformer building blocks.

Port of ``pi3_slam_tpu/models/layers.py``. One pre-norm ``Block`` covers the
DINOv2 encoder block and Pi3's decoder / head blocks: optional LayerScale,
optional per-head qk LayerNorm (eps 1e-5), optional RoPE2D. Weights are
torch ``nn.Linear`` (out, in).

The attention and MLP halves go through the kernel wrappers of ``ops/``: a
CUDA tensor launches the hand-written kernel, a CPU tensor runs its plain
PyTorch version. Which kernel a block takes is decided by shape alone.

* head dim 64, the packed route:
  * encoder blocks (no qk-norm, no RoPE): the qkv projection is the packed
    attention input as it stands; the softmax scale rides the fp32 logits
    (``q_scale``).
  * decoder / head blocks: the fused producer applies qk-norm, RoPE and the
    scale in one pass, then T <= 1280 runs the single-pass entry point and
    longer sequences (the decoder's global blocks) the flash entry point.
* any other head dim, the unpacked route (the JAX package's route off the
  TPU's packed path): the qkv projection viewed as (B, T, 3, H, D), qk-norm
  and RoPE in plain torch, then ``ops.attention.sdpa``.
* kv-merge global blocks (``Pi3Config.global_kv_merge`` > 1): qk-norm and RoPE
  in plain torch, k and v averaged over groups of frames, then the partial
  attention kernel with Tq != Tk (:func:`merged_kv_attention`).
* the MLP half: the fused block-MLP kernel where C and hidden are multiples
  of 128, else LayerNorm, :func:`mlp`, LayerScale and the residual.

Under an active device mesh (``parallel/context.py``), as in the JAX layers:

* kv-merge is ignored (every global block exact);
* with tp > 1 or sp > 1 attention takes the unpacked route
  (:func:`sharded_attention`): the heads on tp, each tp shard's qkv from the
  replicated projection, qk-norm and RoPE in plain torch, the rows-6/7
  kernels or the ring on sp, ``proj`` row-parallel with one all-reduce;
* with tp > 1 the MLP half is the Megatron pair of plain products
  (``TPShards.mlp``), else the block-MLP kernel on each dp / sp row shard;
* with dp only (tp = sp = 1) every block runs its single-device route.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import SINGLE_PASS_MAX_T, sdpa, sdpa_reference
from ..ops.mlp import mlp as fused_mlp
from ..ops.mlp import mlp_kernel_supported
from ..ops.packed_attention import attention_single_pass_packed, flash_attention_packed
from ..ops.partial_attention import flash_attention_partial
from ..ops.qkv_producer import qkv_rope_producer
from ..ops.rope import apply_rope
from ..parallel.context import (
    current_shards,
    current_tp_mesh,
    replicate_over_tp,
    shard_attention,
    sharded_block_mlp,
    to_device,
)

LOG2_E = math.log2(math.e)
QK_NORM_EPS = 1e-5
PACKED_HEAD_DIM = 64  # the head dim of the packed kernels and the producer


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(), eps).to(x.dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """x @ weight^T + bias in x's dtype (weights cast like the JAX path)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def apply_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer`` on x: through its tp shards where the active replica splits
    it (``parallel/mesh.pi3_param_shardings``), else :func:`linear`."""
    shards = current_shards()
    y = None if shards is None else shards.linear(x, layer)
    return linear(x, layer.weight, layer.bias) if y is None else y


def mlp(x: torch.Tensor, m: nn.Module) -> torch.Tensor:
    """fc2(GELU_erf(fc1(x))) with the ``fc1`` / ``fc2`` of ``m`` (a ``Block``
    or an ``Mlp``), through ``ops.mlp``."""
    return fused_mlp(x, m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias)


class Attention(nn.Module):
    """Self-attention weights: the qkv and output projections and the
    optional per-head qk LayerNorm (a ``Block`` holds the same attributes
    itself); run by :func:`attention`."""

    def __init__(self, dim: int, num_heads: int, qk_norm: bool = False, device=None):
        super().__init__()
        kw = dict(device=device)
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        head_dim = dim // num_heads
        self.q_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None
        self.k_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None


class Block(nn.Module):
    """Pre-norm block: x + ls1 * attn(norm1(x)); x + ls2 * mlp(norm2(x))."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: int = 4,
        qk_norm: bool = False,
        layerscale: bool = False,
        eps: float = 1e-6,
        device=None,
    ):
        super().__init__()
        kw = dict(device=device)
        self.num_heads = num_heads
        self.eps = eps
        self.norm1 = nn.LayerNorm(dim, eps=eps, **kw)
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        head_dim = dim // num_heads
        self.q_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None
        self.k_norm = nn.LayerNorm(head_dim, eps=QK_NORM_EPS, **kw) if qk_norm else None
        self.ls1 = nn.Parameter(torch.ones(dim, **kw)) if layerscale else None
        self.norm2 = nn.LayerNorm(dim, eps=eps, **kw)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio, **kw)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim, **kw)
        self.ls2 = nn.Parameter(torch.ones(dim, **kw)) if layerscale else None

    def forward(
        self,
        x: torch.Tensor,
        rope: tuple[torch.Tensor, torch.Tensor] | None = None,
        kv_groups: tuple[int, int, int] | None = None,
    ) -> torch.Tensor:
        """x (B, T, C); rope: (cos, sin) tables (B, T, head dim) from
        ``ops.rope.rope_tables``, or None; kv_groups: see :func:`attention`."""
        xn = layer_norm(x, self.norm1.weight, self.norm1.bias, self.eps)
        h = attention(xn, self, rope, kv_groups)
        if self.ls1 is not None:
            h = h * self.ls1.to(h.dtype)
        x = x + h
        mesh = current_tp_mesh()
        if mesh is not None and mesh.axis_size("tp") > 1:
            h = current_shards().mlp(layer_norm(x, self.norm2.weight, self.norm2.bias, self.eps),
                                     self.fc1, self.fc2)
        elif mlp_kernel_supported(x.shape[-1], self.fc1.out_features):
            return sharded_block_mlp(
                x,
                self.norm2.weight,
                self.norm2.bias,
                self.fc1.weight,
                self.fc1.bias,
                self.fc2.weight,
                self.fc2.bias,
                ls=self.ls2,
                eps=self.eps,
            )
        else:
            h = mlp(layer_norm(x, self.norm2.weight, self.norm2.bias, self.eps), self)
        if self.ls2 is not None:
            h = h * self.ls2.to(h.dtype)
        return x + h


def attention(
    x: torch.Tensor,
    attn: nn.Module,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    kv_groups: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Self-attention over x (B, T, C) -> (B, T, C) with the weights of
    ``attn`` (a ``Block`` or an ``Attention``).

    kv_groups = (n_frames, tokens_per_frame, merge): the global blocks' k/v
    merge; it applies when merge > 1 and merge divides n_frames, and the
    block takes the exact path otherwise (a 50-frame tail with merge 4), and
    under an active mesh."""
    mesh = current_tp_mesh()
    if mesh is not None and (mesh.axis_size("tp") > 1 or mesh.axis_size("sp") > 1):
        return sharded_attention(x, attn, rope, mesh)
    if (kv_groups is not None and kv_groups[2] > 1 and kv_groups[0] % kv_groups[2] == 0
            and mesh is None):
        return merged_kv_attention(x, attn, rope, kv_groups)
    b, t, c = x.shape
    h = attn.num_heads
    d = c // h
    qkv = linear(x, attn.qkv.weight, attn.qkv.bias)
    if d != PACKED_HEAD_DIM:
        q, k, v = _qk_norm_rope(qkv.view(b, t, 3, h, d).unbind(2), attn, rope)
        out = sdpa(q, k, v).reshape(b, t, c)
    elif attn.q_norm is None and rope is None:
        out = attention_single_pass_packed(qkv, h, q_scale=d**-0.5 * LOG2_E)
    else:
        if rope is None:  # qk-norm without RoPE: identity rotation
            rope = (
                torch.ones((b, t, d), device=x.device),
                torch.zeros((b, t, d), device=x.device),
            )
        norm = {}
        if attn.q_norm is not None:
            norm = dict(
                q_norm_scale=attn.q_norm.weight,
                q_norm_bias=attn.q_norm.bias,
                k_norm_scale=attn.k_norm.weight,
                k_norm_bias=attn.k_norm.bias,
                eps=attn.q_norm.eps,
            )
        packed = qkv_rope_producer(qkv, rope[0], rope[1], h, t, **norm)
        entry = attention_single_pass_packed if t <= SINGLE_PASS_MAX_T else flash_attention_packed
        out = entry(packed, h)
    return linear(out, attn.proj.weight, attn.proj.bias)


def _qk_norm_rope(
    qkv: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    attn: nn.Module,
    rope: tuple[torch.Tensor, torch.Tensor] | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """qk-norm (if ``attn`` has it) and RoPE (if given) on (B, T, H, D)
    q / k views, in plain torch, with the weights and tables on q's device;
    v passes through."""
    q, k, v = qkv
    dev = q.device
    if attn.q_norm is not None:
        qn, kn = attn.q_norm, attn.k_norm
        q = layer_norm(q, to_device(qn.weight, dev), to_device(qn.bias, dev), qn.eps)
        k = layer_norm(k, to_device(kn.weight, dev), to_device(kn.bias, dev), kn.eps)
    if rope is not None:
        cos, sin = rope[0].to(dev), rope[1].to(dev)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def sharded_attention(
    x: torch.Tensor,
    attn: nn.Module,
    rope: tuple[torch.Tensor, torch.Tensor] | None,
    mesh,
) -> torch.Tensor:
    """The unpacked route under a mesh with tp > 1 or sp > 1 (the JAX
    ``sharded_sdpa`` path). tp shard j, on its device, projects the
    replicated x with the replicated qkv weights (the JAX spec keeps qkv
    whole), keeps its H/tp heads, applies qk-norm and RoPE, attends over its
    sp devices (``context.shard_attention``) and multiplies by its rows of
    ``proj``; the partials meet in one all-reduce. With tp 1 the one shard
    holds every head and ``proj`` is a plain product."""
    b, t, c = x.shape
    h = attn.num_heads
    d = c // h
    tp = mesh.axis_size("tp")
    if h % tp:
        raise ValueError(f"{h} heads do not split over tp {tp}")
    hs = h // tp
    outs = []
    for j in range(tp):
        dev = mesh.device(tp=j)
        w, bias = to_device(attn.qkv.weight, dev), to_device(attn.qkv.bias, dev)
        qkv = linear(x.to(dev), w, bias).view(b, t, 3, h, d)[:, :, :, j * hs : (j + 1) * hs]
        q, k, v = _qk_norm_rope(qkv.unbind(2), attn, rope)
        outs.append(shard_attention(q, k, v, mesh.sp_devices(j)).reshape(b, t, hs * d))
    if tp == 1:
        return linear(outs[0].to(x.device), attn.proj.weight, attn.proj.bias)
    partials = [F.linear(o, wp.to(o.dtype)) for o, (wp, _) in zip(outs, current_shards().parts(attn.proj))]
    return replicate_over_tp(partials, attn.proj.bias, x.device)


def merged_kv_attention(
    x: torch.Tensor,
    attn: nn.Module,
    rope: tuple[torch.Tensor, torch.Tensor] | None,
    kv_groups: tuple[int, int, int],
) -> torch.Tensor:
    """Global attention with keys and values averaged over ``merge``
    consecutive frames per spatial position (FastVGGT-style; the JAX
    package's ``_merged_kv_attention``): queries keep full resolution, so
    QK^T and PV work drop by the merge factor.

    qk-norm and RoPE run here in plain torch on (B, T, H, D) (tokens of a
    group share a position, so the rotation commutes with the mean); the
    merged k and v are materialised once and the same tensors go to the
    partial kernel, whose fixed shift uses their global per-head max |k|.
    Head dims other than 64 take ``sdpa_reference``, as in the JAX package."""
    b, t, c = x.shape
    h = attn.num_heads
    d = c // h
    nf, tpf, m = kv_groups
    qkv = linear(x, attn.qkv.weight, attn.qkv.bias).view(b, t, 3, h, d).unbind(2)
    q, k, v = _qk_norm_rope(qkv, attn, rope)

    def merge(a: torch.Tensor) -> torch.Tensor:
        return a.reshape(b, nf // m, m, tpf, h, d).mean(dim=2).reshape(b, (nf // m) * tpf, h, d)

    k, v = merge(k), merge(v)
    if d != PACKED_HEAD_DIM:
        out = sdpa_reference(q, k, v)
    else:
        kn = k.float().square().sum(-1).amax(dim=1).sqrt()  # (B, H)
        acc, l = flash_attention_partial(q, k, v, kn)
        out = (acc / l.clamp_min(1e-30)[..., None]).to(x.dtype)
    return linear(out.reshape(b, t, c), attn.proj.weight, attn.proj.bias)
