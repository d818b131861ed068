"""The active mesh of a forward, and the sharded pieces the model calls.

Port of ``pi3_slam_tpu/parallel/context.py``. The mesh reaches
``models/layers.py`` through a context variable, so model code takes no mesh
argument: a sharded step sets it around each replica's forward to the
replica's dp-1 sub-mesh and its tp shards (``mesh.Replica``). It is active
only when the whole mesh has more than one member.

Under an active mesh:

* :func:`replicate_over_tp` is the all-reduce at each row-parallel product
  (``pi3_slam_tpu/models/layers.py:284``, ``:297``, ``:330``): the tp shards'
  partial sums added in shard order, in fp32, on one device, so the result
  does not depend on which shard finished first;
* :func:`sharded_block_mlp` splits the block MLP's rows over dp (batch) and
  sp (tokens), the row-4 kernel on each piece;
* :func:`shard_attention` is the attention of one tp shard's heads (the
  JAX ``sharded_sdpa`` with its heads on tp; ``models/layers.py::
  sharded_attention`` splits them): when the mesh has sp > 1 and T >= 4096
  the tokens go on sp with ring attention (``ring.py``), T padded to a
  multiple of sp.

A piece goes to its device with ``Tensor.to``, which makes no copy where the
tensor already lies there: on a mesh whose devices repeat one card nothing
moves.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

from ..ops.attention import LONG_SEQUENCE_THRESHOLD, sdpa
from ..ops.block_mlp import block_mlp

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("pi3_tp_mesh", default=None)


@contextlib.contextmanager
def tp_mesh_context(mesh, shards: "TPShards | None" = None):
    """Activate ``mesh`` (and a replica's ``shards``) for the forwards run
    inside; a mesh of one member leaves the single-device path."""
    active = mesh is not None and mesh.whole_size > 1
    token = _ACTIVE.set((mesh, shards) if active else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def current_tp_mesh():
    active = _ACTIVE.get()
    return None if active is None else active[0]


def current_shards() -> "TPShards | None":
    active = _ACTIVE.get()
    return None if active is None else active[1]


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A weight on ``device``: through the active replica's cache (one copy a
    device), else ``Tensor.to``."""
    shards = current_shards()
    return t.to(device) if shards is None else shards.weight(t, device)


def replicate_over_tp(partials: list, bias: torch.Tensor | None, device: torch.device) -> torch.Tensor:
    """The all-reduce of a row-parallel product: the shards' partials summed
    in shard order in fp32 on ``device``, cast to their dtype, plus ``bias``."""
    total = partials[0].to(device).float()
    for p in partials[1:]:
        total = total + p.to(device).float()
    out = total.to(partials[0].dtype)
    return out if bias is None else out + bias.to(device=device, dtype=out.dtype)


class TPShards:
    """One replica's tensor-parallel shards: {id(Linear): (kind, [(weight,
    bias) on tp device j])} (``mesh.shard_pi3``), and a cache of the
    replicated weights moved to the replica's other devices."""

    def __init__(self, mesh, layers: dict):
        self.mesh = mesh
        self.layers = layers
        self._moved: dict = {}

    def weight(self, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        if t.device == device:
            return t
        key = (id(t), device)
        if key not in self._moved:
            self._moved[key] = (t, t.to(device))  # the source pins the id
        return self._moved[key][1]

    def parts(self, layer) -> list:
        return self.layers[id(layer)][1]

    def linear(self, x: torch.Tensor, layer) -> torch.Tensor | None:
        """``layer`` on replicated x (B, ..., in) -> replicated output on x's
        device, through its shards; None for a layer that is not split. A
        "col" layer's outputs are gathered, a "row" layer takes its slice of
        x and its partials are reduced (:func:`replicate_over_tp`)."""
        entry = self.layers.get(id(layer))
        if entry is None:
            return None
        kind, parts = entry
        if kind == "col":
            ys = [F.linear(x.to(w.device), w.to(x.dtype), b.to(x.dtype)) for w, b in parts]
            return torch.cat([y.to(x.device) for y in ys], dim=-1)
        s = x.shape[-1] // len(parts)
        partials = [F.linear(x[..., j * s : (j + 1) * s].to(w.device), w.to(x.dtype))
                    for j, (w, _) in enumerate(parts)]
        return replicate_over_tp(partials, layer.bias, x.device)

    def mlp(self, x: torch.Tensor, fc1, fc2) -> torch.Tensor:
        """The Megatron pair fc2(GELU_erf(fc1(x))) on replicated x: each tp
        shard's fc1 columns and fc2 rows on its device, one all-reduce."""
        partials = []
        for (w1, b1), (w2, _) in zip(self.parts(fc1), self.parts(fc2)):
            h = F.gelu(F.linear(x.to(w1.device), w1.to(x.dtype), b1.to(x.dtype)))
            partials.append(F.linear(h, w2.to(x.dtype)))
        return replicate_over_tp(partials, fc2.bias, x.device)


def _pieces(n: int, parts: int) -> list[slice]:
    """``parts`` equal slices of range(n), or one slice where they do not
    divide it (the JAX spec's replicated dimension)."""
    if parts <= 1 or n % parts:
        return [slice(0, n)]
    s = n // parts
    return [slice(i * s, (i + 1) * s) for i in range(parts)]


def sharded_block_mlp(x, norm_scale, norm_bias, w1, b1, w2, b2, ls=None, eps: float = 1e-6):
    """``ops.block_mlp`` under the active mesh: the rows of x (B, T, C) split
    over dp (the batch) and sp (the tokens), each piece through the kernel on
    its device with the replicated weights, and put back together on x's
    device. Without a mesh, ``block_mlp`` itself. tp > 1 callers take the
    Megatron pair (``TPShards.mlp``) instead, as the JAX layers do."""
    mesh = current_tp_mesh()
    weights = (norm_scale, norm_bias, w1, b1, w2, b2, ls)
    if mesh is None:
        return block_mlp(x, *weights[:-1], ls=ls, eps=eps)
    rows = []
    for i, bs in enumerate(_pieces(x.shape[0], mesh.axis_size("dp"))):
        pieces = []
        for s, ts in enumerate(_pieces(x.shape[1], mesh.axis_size("sp"))):
            dev = mesh.device(dp=i, sp=s)
            w = [None if t is None else to_device(t, dev) for t in weights]
            piece = x[bs, ts].to(dev).contiguous()
            pieces.append(block_mlp(piece, *w[:-1], ls=w[-1], eps=eps).to(x.device))
        rows.append(torch.cat(pieces, dim=1) if len(pieces) > 1 else pieces[0])
    return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def shard_attention(q, k, v, devices: list) -> torch.Tensor:
    """Attention of one (dp, tp) shard's q / k / v (B, T, H, D) over its sp
    ``devices``: the ring when there are several and T >= 4096 (T padded with
    zeros to a multiple of sp, the pads taken out by their count), else
    ``sdpa`` on the first. Returns the output on the first device."""
    sp = len(devices)
    T = q.shape[1]
    if sp == 1 or T < LONG_SEQUENCE_THRESHOLD:
        dev = devices[0]
        return sdpa(q.to(dev), k.to(dev), v.to(dev))
    from .ring import ring_attention

    Tp = -(-T // sp) * sp
    if Tp > T:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, Tp - T)) for t in (q, k, v))
    ts = Tp // sp

    def split(t):
        return [t[:, s * ts : (s + 1) * ts].to(dev) for s, dev in enumerate(devices)]

    outs = ring_attention(split(q), split(k), split(v), n_pad=Tp - T)
    return torch.cat([o.to(devices[0]) for o in outs], dim=1)[:, :T]

