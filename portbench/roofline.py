"""The card's peaks, the least time an operation could take on it, and the
work of a model's chunk counted from its shapes.

The peaks and the three work counts are a frozen copy of the port's
``pi3_slam_tpu_torch/ops/roofline.py`` (NVIDIA's H100 SXM data sheet, dense
rates): the benchmark's yardstick must not move when the program's copy does.
The model counts below follow the configuration's shapes, never the kernels
that ran: a roofline or an mfu share is the work the configuration needs over
the time the card took.
"""

from __future__ import annotations

import math

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time in ms the card could take to move nbytes (each input
    read once, each output written once) and do flops at peak."""
    return max(flops / peak, nbytes / PEAK_BYTES) * 1e3


def attention_flops(b: int, h: int, tq: int, tk: int, d: int) -> float:
    """The two matrix products of attention (q.k^T and P.v), 2 flops per
    multiply-add."""
    return 4.0 * b * h * tq * tk * d


def attention_work(b: int, tq: int, tk: int, h: int, d: int, element_size: int):
    """(flops, bytes) of attention of tq queries over tk keys: q and the
    output (b, tq, h, d), k and v (b, tk, h, d), each read or written once."""
    return attention_flops(b, h, tq, tk, d), (2 * tq + 2 * tk) * b * h * d * element_size


def mlp_work(m: int, c: int, hidden: int, element_size: int):
    """(flops, bytes) of the block MLP x + ls * fc2(GELU(fc1(LN x))) on m rows
    of width c: x read and the output written in the activations' dtype, both
    weights once, the fp32 vectors (LayerNorm, biases, LayerScale)."""
    flops = 4.0 * m * c * hidden
    nbytes = 2 * m * c * element_size + 2 * c * hidden * element_size + (hidden + 4 * c) * 4
    return flops, nbytes


def _linear(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def _block(b: int, t: int, c: int, hidden: int, tk: int | None = None) -> float:
    """A pre-norm transformer block on b sequences of t tokens: the qkv,
    output and MLP products and attention over tk keys (t by default)."""
    m = b * t
    heads_work = attention_flops(b, 1, t, t if tk is None else tk, c)
    return _linear(m, c, 3 * c) + _linear(m, c, c) + 2 * _linear(m, c, hidden) + heads_work


def pi3_grid(height: int, width: int, patch: int) -> tuple[int, int]:
    return height // patch, width // patch


def pi3_chunk_flops(model: dict, n_frames: int, height: int, width: int) -> float:
    """FLOPs of one Pi3 forward over a chunk of n_frames at height x width,
    from the configuration's fields (``Pi3Config`` keys): the patch embedding,
    the DINOv2 encoder, the alternating frame / global decoder (the global
    blocks' keys merged over ``global_kv_merge`` frames where it divides the
    chunk), the three head decoders and the point, confidence and camera
    heads."""
    enc = model["encoder"]
    p = model["patch_size"]
    gh, gw = pi3_grid(height, width, p)
    hw = gh * gw
    ce = enc["embed_dim"]
    t_enc = hw + 1 + enc["num_register_tokens"]
    flops = _linear(n_frames * hw, 3 * p * p, ce)
    flops += enc["depth"] * _block(n_frames, t_enc, ce, ce * enc["mlp_ratio"])
    c = model["dec_embed_dim"]
    t = hw + model["num_register_tokens"]
    hidden = c * model["mlp_ratio"]
    pairs = model["dec_depth"] // 2
    merge = model.get("global_kv_merge", 1)
    tk = n_frames * t // merge if merge > 1 and n_frames % merge == 0 else n_frames * t
    flops += pairs * (_block(n_frames, t, c, hidden) + _block(1, n_frames * t, c, hidden, tk))
    hd = model["head_dim"]
    m = n_frames * t
    for out_dim in (hd, hd, model["camera_dim"]):
        flops += _linear(m, 2 * c, hd)
        flops += model["head_depth"] * _block(n_frames, t, hd, hd * model["mlp_ratio"])
        flops += _linear(m, hd, out_dim)
    mp = n_frames * hw
    flops += _linear(mp, hd, 3 * p * p) + _linear(mp, hd, p * p)
    cd = model["camera_dim"]
    flops += 6 * _linear(mp, cd, cd)  # the two residual conv blocks, three layers each
    flops += 2 * _linear(n_frames, cd, cd) + _linear(n_frames, cd, 12)
    return flops


def moge_tokens(height: int, width: int, num_tokens: int) -> tuple[int, int]:
    """MoGe-2's patch grid (base_h, base_w) for an image at num_tokens."""
    ar = width / height
    return int(math.sqrt(num_tokens / ar)), int(math.sqrt(num_tokens * ar))


def _conv(hw: int, k: int, c_in: int, c_out: int) -> float:
    return 2.0 * hw * k * k * c_in * c_out


def _conv_stack_flops(stack: dict, base_hw: int) -> float:
    """A MoGe ConvStack: per level l (base_hw * 4**l pixels) the input 1x1
    conv, the residual blocks' two 3x3 convs, the output 1x1 conv and the
    pixel-shuffle upsampler's two 3x3 convs into the next level."""
    dims = stack["dim_res_blocks"]
    hidden_mult = stack.get("dim_times_res_block_hidden", 1)
    blocks = stack.get("num_res_blocks", 1)
    flops = 0.0
    for level, c in enumerate(dims):
        hw = base_hw * 4**level
        c_in = stack["dim_in"][level]
        if c_in is not None:
            flops += _conv(hw, 1, c_in, c)
        n = blocks[level] if isinstance(blocks, list) else blocks
        flops += n * 2 * _conv(hw, 3, c, hidden_mult * c)
        c_out = stack["dim_out"][level]
        if c_out is not None:
            flops += _conv(hw, 1, c, c_out)
        if level + 1 < len(dims):
            flops += _conv(hw, 3, c, 4 * dims[level + 1]) + _conv(4 * hw, 3, dims[level + 1],
                                                                  dims[level + 1])
    return flops


def moge_frame_flops(moge: dict, height: int, width: int) -> float:
    """FLOPs of one MoGe-2 forward on a height x width frame at the most
    tokens of its range: the ViT trunk up to its last block, the 1x1
    projections, the neck and the heads (the final resizes, the focal solve
    and the scale head are left out: each under a millionth of the total)."""
    bh, bw = moge_tokens(height, width, moge["num_tokens_range"][1])
    hw = bh * bw
    enc = moge["encoder"]
    ce = enc["embed_dim"]
    flops = _linear(hw, 3 * 14 * 14, ce)
    flops += enc["depth"] * _block(1, hw + 1, ce, ce * enc["mlp_ratio"])
    flops += moge["intermediate_layers"] * _conv(hw, 1, ce, moge["encoder_dim_out"])
    for stack in ("neck", "points_head", "mask_head"):
        if moge.get(stack) is not None:
            flops += _conv_stack_flops(moge[stack], hw)
    return flops
