"""Bound-shift partial attention over (B, T, H, D) q / k / v with Tq != Tk.

Replaces ``pi3_slam_tpu/ops/pallas_attention.py::flash_attention_partial_tpu``
(kernel ``_flash_fwd_partial_kernel``), which the kv-merge global blocks
(``models/layers.py::merged_kv_attention``) run. For query row r of head h:

    s_rj  = q_r . k_j * D**-0.5 * log2(e)
    mh_r  = min(|q_r| * D**-0.5 * log2(e) * kn_h + 1, 120)
    acc_r = sum_j 2**(s_rj - mh_r) * v_j        l_r = sum_j 2**(s_rj - mh_r)

with ``kn`` (B, H) the global max |k| per head. The shift is fixed before the
key loop (Cauchy-Schwarz: s_rj <= mh_r - 1), so partials over key shards that
share ``kn`` sum exactly and the caller divides once; ``acc`` and ``l``
themselves, not only their ratio, are the contract.

On a CUDA tensor :func:`flash_attention_partial` launches a hand-written
kernel that reads q, k and v through their strides (any view with a
unit-stride last dim and 16-byte aligned rows, such as the qkv projection's
q / k / v slices): in bf16 ``csrc/partial_attention.cu`` (see its header; the
TMA + ``wgmma`` loop of ``csrc/bthd_attention.cuh`` with its own epilogue),
in fp32 the partial entry of ``csrc/attention_f32.cu``; any other dtype
raises. On a CPU tensor it runs :func:`partial_attention_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import check_launch, count_launch, is_fp32, load_library
from .attention_f32 import partial_attention_f32

HEAD_DIM = 64
LOG2_E = math.log2(math.e)
MAX_SHIFT = 120.0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kn: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, T, H, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d) or k.shape[1] < 1:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if tuple(kn.shape) != (b, h):
        raise ValueError(f"kn must be (B, H) = ({b}, {h}), got {tuple(kn.shape)}")


def partial_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kn: torch.Tensor,
    q_block: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, in fp32, with queries processed in blocks of
    ``q_block`` rows (a dense logit tensor at Tq = 64,300, Tk = 32,150 and 16
    heads would need 132 GB). Returns (acc (B, Tq, H, D), l (B, Tq, H))."""
    _check(q, k, v, kn)
    b, tq, h, d = q.shape
    scale = d**-0.5 * LOG2_E
    q32 = q.float().transpose(1, 2) * scale  # (B, H, Tq, D)
    kt = k.float().permute(0, 2, 3, 1)  # (B, H, D, Tk)
    v32 = v.float().transpose(1, 2)
    mh = (q32.norm(dim=-1) * kn.float()[:, :, None] + 1.0).clamp_max(MAX_SHIFT)  # (B, H, Tq)
    acc = torch.empty((b, h, tq, d), device=q.device, dtype=torch.float32)
    l = torch.empty((b, h, tq), device=q.device, dtype=torch.float32)
    for i in range(0, tq, q_block):
        p = torch.matmul(q32[:, :, i : i + q_block], kt)
        p.sub_(mh[:, :, i : i + q_block, None]).exp2_()
        l[:, :, i : i + q_block] = p.sum(-1)
        acc[:, :, i : i + q_block] = torch.matmul(p, v32)
    return acc.transpose(1, 2).contiguous(), l.transpose(1, 2).contiguous()


@functools.cache
def _kernel():
    fn = load_library("partial_attention").pi3_partial_attention
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _strides(x: torch.Tensor, name: str, device: torch.device) -> tuple[int, int, int]:
    if x.device != device:
        raise ValueError(f"flash_attention_partial: {name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_partial kernel takes bfloat16 {name}, got {x.dtype}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"flash_attention_partial: {name} needs a unit-stride last dim and "
                         f"16-byte aligned rows, got strides {x.stride()}")
    return x.stride(0), x.stride(1), x.stride(2)


def flash_attention_partial(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kn: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Tq, H, D) unscaled, k / v (B, Tk, H, D), kn (B, H) the global
    per-head max |k| -> (acc (B, Tq, H, D), l (B, Tq, H)), both fp32.

    CUDA tensors must be bfloat16 or float32 with D = 64."""
    _check(q, k, v, kn)
    if not q.is_cuda:
        return partial_attention_plain(q, k, v, kn)
    b, tq, h, d = q.shape
    if is_fp32(q, "flash_attention_partial"):
        out = partial_attention_f32(q, k, v, kn, d**-0.5 * LOG2_E)
        count_launch(flash_attention_partial, True)
        return out
    if d != HEAD_DIM:
        raise ValueError(f"the partial attention kernel takes head dim {HEAD_DIM}, got {d}")
    dev = q.device
    strides = [s for x, name in ((q, "q"), (k, "k"), (v, "v")) for s in _strides(x, name, dev)]
    kn32 = kn.to(device=dev, dtype=torch.float32).contiguous()
    acc = torch.empty((b, tq, h, d), device=dev, dtype=torch.float32)
    l = torch.empty((b, tq, h), device=dev, dtype=torch.float32)
    code = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kn32.data_ptr(), acc.data_ptr(), l.data_ptr(),
        b, tq, k.shape[1], h, *strides, float(d**-0.5 * LOG2_E), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(code, "flash_attention_partial")
    count_launch(flash_attention_partial, False)
    return acc, l


flash_attention_partial.launches = 0
flash_attention_partial.launches_fp32 = 0
