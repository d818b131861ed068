"""Kernel and model probes on one NVIDIA GPU: the ports of the JAX package's
``tools/perf_lab.py`` probes, and the port's own (``tf32``, ``tiles``).

    python -m pi3_slam_tpu_torch.tools.perf_lab [all]    # global frame block packed stages mlp forward
    python -m pi3_slam_tpu_torch.tools.perf_lab global | frame | packed | block
    python -m pi3_slam_tpu_torch.tools.perf_lab stages | forward | refine | kv-accuracy
    python -m pi3_slam_tpu_torch.tools.perf_lab sol | mlp | mlp-sweep | tf32 | tiles | tsdf
    PI3_KV_MERGE=2 python -m pi3_slam_tpu_torch.tools.perf_lab forward
    PI3_WEIGHTS=pi3.npz PI3_KV_FRAMES=20 python -m pi3_slam_tpu_torch.tools.perf_lab kv-accuracy

The JAX probes' shapes and contracts; their TPU knobs (block sizes,
interleave counts, ``ln_stats``) and the JAX library kernel they were held to
do not come over: each row stands beside one SDPA or cuBLAS call that
computes the same function, where one does, and its bound (the operations at
the card's peak for their type, or the bytes over its memory rate, and for
attention the ``exp2`` count on the special-function units):

* ``global``: ``flash_attention`` (row 6) and ``flash_attention_packed`` (row
  1) at (1, 66000, 16, 64); ``frame``: ``attention_single_pass`` (row 7) at
  (100, 660) and (100, 643) x (16, 64), beside its plain version too;
  ``packed``: row 2 at (100, 660, 3072) and row 1 at (1, 66000, 3072);
* ``block``: one Pi3 decoder block at (1, 64300, 1024) and (100, 643, 1024)
  against its packed kernel alone, the difference being the rest of the
  block;
* ``stages``: the full-width bf16 forward's encoder, decoder, one head
  decoder and dense heads at 100 frames of 308x406, their sum as frames/s;
  ``forward``: the whole forward (``PI3_KV_MERGE``); ``refine``: the chunk
  step without and with ZNCC refinement at 400 keypoints; ``kv-accuracy``:
  the kv-merge outputs against exact ones (``PI3_WEIGHTS``,
  ``PI3_KV_FRAMES``, ``PI3_KV_MERGE``). These four share one full-width
  model a process (random weights from seed 0 unless ``PI3_WEIGHTS``);
* ``mlp-sweep``: each MLP entry at every shape and dtype the paths send it
  (MLP_SWEEP), beside its plain version and cuBLAS.

Every kernel these probes time is first held once against its plain version
at the same shape (``ops/compare``'s bounds; a disagreement raises); those
calls do not count as launches (``ops.uncounted``).

Every probe times with CUDA events (one warm-up call, then the mean of
``ITERS`` calls, more for short ones). ``sol`` prints ms and TFLOP/s of:

* a square 8192^3 bf16 ``torch.matmul``: the card's practical bf16 peak, a
  yardstick;
* ``dots_attention`` at (1, 65536, 3*16*64): the TMA + ``wgmma`` loop of
  ``csrc/bthd_attention.cuh`` with the softmax taken out (its products-only
  mode, ``csrc/dots_attention.cu``);
* ``flash_attention_packed`` at the same shape: the same design with its
  online softmax (``csrc/packed_attention.cu``);
* ``flash_attention`` over the same q / k / v views: that loop itself with
  its online softmax (``csrc/attention.cu``), so its time less the dots
  kernel's is the softmax's cost on the loop;
* ``block_mlp`` at (1, 65536, 1024) with hidden 4096 (``csrc/block_mlp.cu``).

Each against the matmul yardstick says how far its loop is from the tensor
cores' practical rate. The three attention kernels run one loop design (ring,
tiles, warpgroups, issue order).

``mlp`` times, at the main paths' MLP shapes (Pi3's (1, 64300, 1024) and
(100, 643, 1024) with hidden 4096, MoGe-2's (1, 3537, 384) with 1536), the
two GEMM entries of ``csrc/block_mlp.cu`` (``block_mlp``, ``mlp``; both held
against their plain versions at each of these shapes first), their
plain versions, and the two bare bf16 cuBLAS products (``F.linear`` without
bias) of the same shapes: the products yardstick, which computes less than
either entry.

``tf32`` runs the two measurements behind the fp32 GEMM's design
(``csrc/tf32_probe.cu``): which bits of an fp32 pattern the tensor cores read
as TF32 (one wgmma tf32 on raw fp32 tiles, one-hot rows on one side, its
output against the other side truncated to TF32 and rounded to TF32), and
the fp32 GEMM's relative L2 error against an fp64 product at K 4096 for each
accumulation depth (k8 steps in one wgmma accumulator), with its time at the
global fc2 shape. Then the fp32 attention at head dim 64 at its main-path
shapes: the time of ``flash_attention``'s fp32 entry
(``csrc/bthd_attention_f32.cuh``), of the same loop at group depth 4 and 8
(``pi3_attention_f32_depth``)
and of fp32 SDPA, and at the global shape (1, 64300, 16, 64) each one's
relative L2 error against an fp64 attention; the same for the entry and fp32
SDPA at the wide shape (1, 8192, 4, 256), the loop's sliced variant.

``tiles`` builds ``csrc/attention.cu`` once for each entry of TILE_TRIES
(the tile table's key tile, ring stages and K / V barriers at head dims 256
and 192, each build with its own copy of the sources under ``_build/``),
prints each build's ptxas lines for the loop, holds each to
``blockwise_attention`` and times it beside the shipped build and SDPA at
(1, 8192, 4, D) and (100, 643, 4, D).

``tsdf`` is the JAX probe's TSDF fusion at eval scale (``mapping/tsdf.py``):
100 stride-2 dense frames of 154x203 into a 189^3 grid, the state on the
card, one warm-up chunk and three chained ones: seconds a chunk, fusion
frames/s, Gvoxel-updates/s, and beside them the bytes bound of a
frame-at-a-time pass (the 20-byte state read and written per voxel and
frame, over 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import sys

import torch

SQUARE = 8192
SOL_T, SOL_H, SOL_D = 65536, 16, 64
MLP_C, MLP_HIDDEN = 1024, 4096
ITERS = 3  # timed calls of each probe, after one warm-up call
MLP_ITERS = 20
MLP_SHAPES = (((1, 64300), 1024, 4096), ((100, 643), 1024, 4096), ((1, 3537), 384, 1536))


def _time_ms(fn, iters: int = ITERS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bench_sol() -> dict:
    """Run the five probes on the current CUDA device; returns
    {name: {"ms", "tflops", "flops", "shape"}} and prints one line each.
    Inputs are N(0, 0.05^2) in bf16, drawn on the card from seed 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("the speed-of-light probe needs an NVIDIA GPU")
    from ..ops.block_mlp import block_mlp, block_mlp_plain
    from ..ops.compare import ATTENTION, DOTS, block_mlp_bounds
    from ..ops.dots_attention import dots_attention, dots_attention_plain
    from ..ops.flash_attention import blockwise_attention, flash_attention
    from ..ops.packed_attention import flash_attention_packed, packed_attention_plain

    g = torch.Generator(device="cuda").manual_seed(0)

    def mk(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * 0.05).to(torch.bfloat16)

    results = {}

    def run(name, shape, fn, flops):
        ms = _time_ms(fn)
        results[name] = {"ms": ms, "tflops": flops / ms / 1e9, "flops": flops, "shape": shape}
        print(f"{name:44s} {shape:24s} {ms:9.3f} ms {flops / ms / 1e9:8.1f} TFLOP/s", flush=True)

    a, w = mk(SQUARE, SQUARE), mk(SQUARE, SQUARE)
    run(f"square {SQUARE}^3 bf16 matmul (practical peak)", f"({SQUARE}, {SQUARE})",
        lambda: torch.matmul(a, w), 2.0 * SQUARE**3)
    del a, w

    qkv = mk(1, SOL_T, 3 * SOL_H * SOL_D)
    aflops = 4.0 * SOL_H * SOL_T * SOL_T * SOL_D
    shape = f"(1, {SOL_T}, {3 * SOL_H * SOL_D})"
    q, k, v = qkv.view(1, SOL_T, 3, SOL_H, SOL_D).unbind(2)
    _held("dots_attention", shape, lambda: dots_attention(qkv, SOL_H),
          lambda: dots_attention_plain(qkv, SOL_H), "bf16 logits, bf16 output", **DOTS)
    _held("flash_attention_packed", shape, lambda: flash_attention_packed(qkv, SOL_H),
          lambda: packed_attention_plain(qkv, SOL_H), ATTENTION_WHY, **ATTENTION)
    _held("flash_attention", shape, lambda: flash_attention(q, k, v),
          lambda: blockwise_attention(q, k, v), ATTENTION_WHY, **ATTENTION)
    run("dots_attention (the TMA + wgmma loop without softmax)", shape,
        lambda: dots_attention(qkv, SOL_H), aflops)
    run("flash_attention_packed (TMA + wgmma, online softmax)", shape,
        lambda: flash_attention_packed(qkv, SOL_H), aflops)
    run("flash_attention (the same loop as dots, softmax)", shape,
        lambda: flash_attention(q, k, v), aflops)
    del qkv, q, k, v

    x = mk(1, SOL_T, MLP_C)
    w1, w2 = mk(MLP_HIDDEN, MLP_C), mk(MLP_C, MLP_HIDDEN)
    zeros = lambda n: torch.zeros(n, device="cuda")
    ones = lambda n: torch.ones(n, device="cuda")
    params = (ones(MLP_C), zeros(MLP_C), w1, zeros(MLP_HIDDEN), w2, zeros(MLP_C))
    shape = f"(1, {SOL_T}, {MLP_C})/{MLP_HIDDEN}"
    _held("block_mlp", shape, lambda: block_mlp(x, *params), lambda: block_mlp_plain(x, *params),
          "bf16 fc outputs, bf16 out", **block_mlp_bounds(x, block_mlp_plain(x, *params)))
    run("block_mlp (LN + fc1 + GELU + fc2 + residual)", shape, lambda: block_mlp(x, *params),
        4.0 * SOL_T * MLP_C * MLP_HIDDEN)
    return results


def bench_mlp() -> dict:
    """Time the MLP entries, their plain versions and the bare products at
    MLP_SHAPES (one warm-up, then the mean of MLP_ITERS calls); returns
    {shape: {name: ms}} and prints one line each with TFLOP/s of the two
    products. Inputs are N(0, 1) activations and N(0, 0.02^2) weights in
    bf16, drawn on the card from seed 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("the MLP probe needs an NVIDIA GPU")
    import torch.nn.functional as F

    from ..ops.block_mlp import block_mlp, block_mlp_plain
    from ..ops.compare import MLP, block_mlp_bounds
    from ..ops.mlp import mlp, mlp_plain

    g = torch.Generator(device="cuda").manual_seed(0)

    def mk(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    results = {}
    for lead, c, hidden in MLP_SHAPES:
        x = mk(*lead, c)
        w1, b1 = mk(hidden, c, scale=0.02), mk(hidden, scale=0.1)
        w2, b2 = mk(c, hidden, scale=0.02), mk(c, scale=0.1)
        norm = (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))
        ls = torch.full((c,), 0.9, device="cuda")
        h = mk(*lead, hidden)
        runs = {
            "block_mlp": lambda: block_mlp(x, *norm, w1, b1, w2, b2, ls=ls),
            "block_mlp_plain": lambda: block_mlp_plain(x, *norm, w1, b1, w2, b2, ls=ls),
            "mlp": lambda: mlp(x, w1, b1, w2, b2),
            "mlp_plain": lambda: mlp_plain(x, w1, b1, w2, b2),
            "products (2 x F.linear, no bias)": lambda: (F.linear(x, w1), F.linear(h, w2)),
        }
        shape = f"({lead[0]}, {lead[1]}, {c})/{hidden}"
        _held("block_mlp", shape, runs["block_mlp"], runs["block_mlp_plain"],
              "bf16 fc outputs, bf16 out", **block_mlp_bounds(x, runs["block_mlp_plain"]()))
        _held("mlp", shape, runs["mlp"], runs["mlp_plain"], "bf16 fc outputs, bf16 out", **MLP)
        flops = 4.0 * lead[0] * lead[1] * c * hidden
        results[shape] = {}
        for name, fn in runs.items():
            ms = _time_ms(fn, MLP_ITERS)
            results[shape][name] = ms
            print(f"{name:34s} {shape:24s} {ms:9.3f} ms {flops / ms / 1e9:8.1f} TFLOP/s",
                  flush=True)
        del x, h, w1, w2
    return results


TF32_DEPTHS = (4, 8, 16, 32, 0)  # k8 steps a group; 0: all of K in one accumulator
TF32_SHAPE = (64300, 1024, 4096)  # fc2 at the global shape: M, N, K


def _tf32_bits(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """x as TF32: its low 13 bits dropped ("truncate"), or rounded to
    nearest with ties away ("rna") or to even ("rne")."""
    i = x.view(torch.int32)
    if rounding == "rna":
        i = i + 0x1000
    elif rounding == "rne":
        i = i + 0xFFF + ((i >> 13) & 1)
    return (i & -0x2000).view(torch.float32)


def tf32_read() -> dict:
    """One wgmma tf32 on raw fp32 tiles (``pi3_tf32_probe``), one-hot rows on
    one side, values uniform in [1, 2) with every mantissa bit drawn on the
    other: {side: {rounding: share of elements the output equals}} for the
    values dropped to TF32 ("truncate"), rounded to nearest ties away
    ("rna") or to even ("rne"), and left as they are ("raw fp32")."""
    import ctypes

    from ..ops._build import check_launch, load_library

    fn = load_library("tf32_probe").pi3_tf32_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}

    def one_hot(rows):  # row r picks k = r % 8
        x = torch.zeros(rows, 32, device="cuda")
        x[torch.arange(rows), torch.arange(rows) % 8] = 1.0
        return x

    for side in ("A", "W"):
        vals = 1 + torch.rand(64 if side == "A" else 128, 32, generator=g, device="cuda")
        a, w = (vals, one_hot(128)) if side == "A" else (one_hot(64), vals)
        out = torch.empty(64, 128, device="cuda")
        check_launch(fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), torch.cuda.current_device(),
                        torch.cuda.current_stream().cuda_stream), "tf32 probe")
        torch.cuda.synchronize()
        # out[i, n] = a[i, n % 8] (side A) or w[n, i % 8] (side W)
        rows, cols = torch.meshgrid(torch.arange(64), torch.arange(128), indexing="ij")
        want = a[rows, cols % 8] if side == "A" else w[cols, rows % 8]
        results[side] = {r: (out == _tf32_bits(want, r)).float().mean().item()
                         for r in ("truncate", "rna", "rne")}
        results[side]["raw fp32"] = (out == want).float().mean().item()
    return results


def bench_tf32() -> dict:
    """The TF32 read probe (:func:`tf32_read`), the fp32 GEMM's
    accumulation depth and the fp32 attention's accuracy
    (:func:`attention_f32_accuracy`); returns {"read": ..., "depth": {g8:
    {"rel_l2", "ms"}}, "cublas_rel_l2", "attention": ...} and prints one
    line each. GEMM inputs N(0, 1)
    activations and N(0, 1/K) weights, from seed 0 on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the TF32 probe needs an NVIDIA GPU")
    import ctypes

    import torch.nn.functional as F

    from ..ops._build import check_launch, load_library

    results = {"read": tf32_read(), "depth": {}}
    for side, shares in results["read"].items():
        print(f"tf32 read of {side}'s fp32 patterns: share of elements equal to "
              + ", ".join(f"{r} {v:.4f}" for r, v in shares.items()), flush=True)
    fn = load_library("tf32_probe").pi3_gemm_f32_depth
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    m, n, k = TF32_SHAPE
    x = torch.randn(m, k, generator=g, device="cuda")
    w = torch.randn(n, k, generator=g, device="cuda") * k**-0.5
    bias = torch.zeros(n, device="cuda")
    ref = F.linear(x.double(), w.double())
    ref_norm = ref.norm().item()

    def rel(y):
        return ((y.double() - ref).norm() / ref_norm).item()

    results["cublas_rel_l2"] = rel(F.linear(x, w))
    print(f"cuBLAS fp32 F.linear ({m}, {k}) x ({n}, {k})^T: rel L2 vs fp64 "
          f"{results['cublas_rel_l2']:.3e}", flush=True)
    out = torch.empty(m, n, device="cuda")
    for g8 in TF32_DEPTHS:
        run = lambda: check_launch(fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                      m, n, k, g8, torch.cuda.current_device(), stream),
                                   "fp32 GEMM")
        ms = _time_ms(run, MLP_ITERS)
        err = rel(out)
        results["depth"][g8] = {"rel_l2": err, "ms": ms}
        label = f"{g8} k8 steps" if g8 else "all of K"
        print(f"fp32 GEMM, groups of {label:12s} ({m}, {k}) x ({n}, {k})^T: rel L2 vs fp64 "
              f"{err:.3e}, {ms:.3f} ms, {2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s", flush=True)
    del x, w, ref, out
    results["attention"] = attention_f32_accuracy()
    return results


# the fp32 attention's main-path shapes at head dim 64 (B, T, H): the global
# blocks at 100 frames, the frame blocks, MoGe-2's encoder; accuracy against
# fp64 at the first
ATTN_SHAPES = ((1, 64300, 16), (100, 643, 16), (1, 3537, 6))
# the loop's group depths (pi3_attention_f32_depth's k8 steps a group)
ATTN_DEPTHS = {"groups of 4 (the kernel's)": 4, "groups of 8": 8}


def _attention_f64(q, k, v, block: int = 4096) -> torch.Tensor:
    """softmax(q.k^T / sqrt(D)) . v in fp64 over (B, T, H, D) q / k / v, a
    head and a block of query rows at a time."""
    b, t, h, d = q.shape
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, :, hi].double(), v[bi, :, hi].double()
            for r0 in range(0, t, block):
                s = q[bi, r0:r0 + block, hi].double() @ kh.T * d**-0.5
                out[bi, r0:r0 + block, hi] = torch.softmax(s, -1) @ vh
                del s
    return out


def attention_f32_accuracy(depths=ATTN_DEPTHS) -> dict:
    """The fp32 attention at head dim 64 at each of ATTN_SHAPES (inputs
    N(0, 1) from seed 0 on the card): {shape: {name: {"ms"[, "rel_l2"]}}}
    for ``flash_attention``'s fp32 entry, the loop at ``depths`` (through
    ``pi3_attention_f32_depth``) and fp32 SDPA (TF32 off), with the relative
    L2 error against an fp64 attention at the first shape; prints a line
    each."""
    import ctypes

    import torch.nn.functional as F

    from ..ops._build import check_launch, load_library
    from ..ops.flash_attention import flash_attention

    if depths:
        fn = load_library("tf32_probe").pi3_attention_f32_depth
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for b, t, h in ATTN_SHAPES:
        shape = (b, t, h, 64)
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        ref = _attention_f64(q, k, v) if not results else None
        flops = 4.0 * b * h * t * t * 64
        runs = {"flash_attention fp32 entry": lambda: flash_attention(q, k, v)}
        out = torch.empty_like(q)
        scale = 64**-0.5 * 1.4426950408889634  # log2(e): the kernel's base-2 softmax

        def loop(g8):
            check_launch(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, t, h,
                            scale, g8, torch.cuda.current_device(),
                            torch.cuda.current_stream().cuda_stream), "fp32 attention")
            return out

        for name, g8 in depths.items():
            runs[f"loop, {name}"] = lambda g8=g8: loop(g8)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        runs["fp32 SDPA"] = lambda: F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
        res = results[shape] = {}
        for name, run in runs.items():
            line = f"fp32 attention {str(shape):18s} {name:45s}:"
            if ref is not None:
                err = ((run().double() - ref).norm() / ref.norm()).item()
                res[name] = {"rel_l2": err}
                line += f" rel L2 vs fp64 {err:.3e},"
            ms = _time_ms(run, ITERS if t > 10000 else MLP_ITERS)
            res.setdefault(name, {})["ms"] = ms
            print(f"{line} {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s", flush=True)
        del q, k, v, qt, kt, vt, ref, out
    results[ATTN_WIDE_SHAPE] = attention_f32_wide_accuracy()
    return results


# the sliced variant's accuracy shape (row 6 fp32 at D 256)
ATTN_WIDE_SHAPE = (1, 8192, 4, 256)


def attention_f32_wide_accuracy(shape=ATTN_WIDE_SHAPE) -> dict:
    """``flash_attention``'s fp32 entry and fp32 SDPA at a head dim above 64
    (inputs N(0, 1) from seed 0 on the card): {name: {"rel_l2", "ms"}}, the
    relative L2 error against an fp64 attention; prints a line each. It
    imports only ``flash_attention``, so it also measures another tree's
    package loaded under it."""
    import torch.nn.functional as F

    from ..ops.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    ref = _attention_f64(q, k, v)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    runs = {"flash_attention fp32 entry": lambda: flash_attention(q, k, v),
            "fp32 SDPA": lambda: F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)}
    b, t, h, d = shape
    flops = 4.0 * b * h * t * t * d
    res = {}
    for name, run in runs.items():
        err = ((run().double() - ref).norm() / ref.norm()).item()
        ms = _time_ms(run, MLP_ITERS)
        res[name] = {"rel_l2": err, "ms": ms}
        print(f"fp32 attention {str(shape):18s} {name:45s}: rel L2 vs fp64 {err:.3e}, {ms:.3f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return res


# the (B, T, H, D) loop's tile table (csrc/bthd_attention.cuh, BthdTiles<D>):
# the entries tried at each head dim, and the shapes they are timed at
TILE_TRIES = {
    256: ("TileShape<64, 2>", "TileShape<64, 2, true>", "TileShape<80, 2>",
          "TileShape<80, 2, true>"),
    192: ("TileShape<64, 3>", "TileShape<64, 3, true>", "TileShape<80, 2, true>"),
}
TILE_SHAPES = ((1, 8192, 4), (100, 643, 4))
TILE_ITERS = 20


def _tile_build(d: int, entry: str):
    """``csrc/attention.cu`` built with the tile table's entry for head dim d
    replaced by ``entry`` (its own copy of the sources under ``_build/``);
    returns (the loaded library, the ptxas lines of its softmax kernel at d)."""
    import ctypes
    import hashlib
    import re
    import subprocess

    from ..ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc

    sources = {p.name: p.read_text() for p in [CSRC / "attention.cu", *sorted(CSRC.glob("*.cuh"))]}
    sources["bthd_attention.cuh"], n = re.subn(
        rf"struct BthdTiles<{d}> : TileShape<[^>]*> {{}};", f"struct BthdTiles<{d}> : {entry} {{}};",
        sources["bthd_attention.cuh"])
    if n != 1:
        raise RuntimeError(f"no tile table entry for head dim {d} in bthd_attention.cuh")
    key = hashlib.sha256(" ".join([*NVCC_FLAGS, *sources.values()]).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"tiles-{key}"
    so = out / "attention.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        for name, text in sources.items():
            (out / name).write_text(text)
        tmp = out / "attention.so.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(out / "attention.cu")],
                              capture_output=True, text=True)
        (out / "ptxas.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {entry} at head dim {d}:\n{proc.stderr[-4000:]}")
        tmp.replace(so)  # a cut build leaves no library behind
    log = (out / "ptxas.log").read_text().splitlines()
    kernel = f"bthd_attention_kernelILi{d}ELi0E"
    at = [i for i, line in enumerate(log) if "entry function" in line and kernel in line]
    ptxas = [line.strip() for i in at for line in log[i + 1:i + 4]
             if "registers" in line or "spill" in line]
    fn = ctypes.CDLL(str(so)).pi3_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn, ptxas


def bench_tiles() -> dict:
    """Each tile table entry of TILE_TRIES against the shipped build, at
    TILE_SHAPES (inputs N(0, 1) in bf16 from seed 0 on the card): each held
    to ``blockwise_attention`` under ``ops/compare.ATTENTION``, then timed in
    turns (the shipped ``flash_attention``, each try, SDPA, and again in the
    reverse order); returns {d: {shape: {name: [ms, ms]}}} and prints a line
    each with its TFLOP/s."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tile probe needs an NVIDIA GPU")
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F

    from ..ops._build import check_launch
    from ..ops.compare import ATTENTION, compare
    from ..ops.flash_attention import blockwise_attention, flash_attention

    tries = [(d, entry) for d, entries in TILE_TRIES.items() for entry in entries]
    with ThreadPoolExecutor(len(tries)) as pool:
        built = dict(zip(tries, pool.map(lambda t: _tile_build(*t), tries)))
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for d, entries in TILE_TRIES.items():
        for entry in entries:
            print(f"D {d} {entry:24s} ptxas: {' | '.join(built[d, entry][1])}", flush=True)
        for b, t, h in TILE_SHAPES:
            q, k, v = (torch.randn(b, t, h, d, generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(3))
            ref = blockwise_attention(q, k, v)
            out = torch.empty_like(q)
            strides = [s for x in (q, k, v) for s in x.stride()[:3]]

            def launch(fn):
                check_launch(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, t,
                                h, d, *strides, float(d**-0.5 * 1.4426950408889634),
                                torch.cuda.current_device(), stream), "tile probe")
                return out

            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            runs = {"shipped flash_attention": lambda: flash_attention(q, k, v)}
            runs.update({entry: lambda fn=built[d, entry][0]: launch(fn) for entry in entries})
            runs["SDPA"] = lambda: F.scaled_dot_product_attention(qt, kt, vt)
            for name, run in runs.items():
                if name != "SDPA":
                    c = compare(run(), ref, **ATTENTION)
                    if not c.ok:
                        raise RuntimeError(f"D {d} {name} at {(b, t, h)}: {c}")
            times = {name: [] for name in runs}
            for order in (list(runs), list(runs)[::-1]):
                for name in order:
                    times[name].append(_time_ms(runs[name], TILE_ITERS))
            flops = 4.0 * b * h * t * t * d
            shape = str((b, t, h, d))
            for name, ms in times.items():
                print(f"D {d} {shape:20s} {name:24s} " + ", ".join(f"{x:.3f}" for x in ms)
                      + f" ms, {flops / min(ms) / 1e9:.1f} TFLOP/s", flush=True)
            results.setdefault(d, {})[shape] = times
            del q, k, v, ref, out, qt, kt, vt
    return results


TSDF_FRAMES, TSDF_H, TSDF_W, TSDF_VOXELS = 100, 154, 203, 189


def bench_tsdf() -> dict:
    """TSDF fusion at eval scale on the current CUDA device (the JAX
    package's ``bench_tsdf``, the same inputs from numpy seed 0); returns
    {"s_per_chunk", "fps", "gvoxel_updates_per_s", "bound_s", "voxels",
    "frames"} and prints one line."""
    if not torch.cuda.is_available():
        raise RuntimeError("the tsdf probe needs an NVIDIA GPU")
    import time

    import numpy as np

    from ..mapping.tsdf import _fuse_frames
    from ..ops.roofline import PEAK_BYTES

    rng = np.random.default_rng(0)
    F, H, W, n = TSDF_FRAMES, TSDF_H, TSDF_W, TSDF_VOXELS
    V = n**3
    dev = torch.device("cuda", torch.cuda.current_device())

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    state = (torch.ones(V, device=dev), torch.zeros(V, device=dev), torch.zeros((V, 3), device=dev))
    frames = (
        up(rng.uniform(1, 4, (F, H, W))),
        up(rng.uniform(0.2, 1, (F, H, W))),
        up(rng.uniform(0, 1, (F, H, W, 3))),
        up(np.tile(np.array([200.0, 200.0, W / 2, H / 2]), (F, 1))),
        up(np.tile(np.eye(3), (F, 1, 1))),
        up(rng.uniform(-0.2, 0.2, (F, 3))),
    )
    args = (up([-3, -3, -3]), torch.tensor(np.float32(0.032), device=dev),
            float(np.float32(0.128)), float(np.float32(0.25)), float(np.float32(1e-3)),
            float(np.float32(1e4)), (n, n, n), H, W)
    state = _fuse_frames(state, frames, *args)
    torch.cuda.synchronize()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        state = _fuse_frames(state, frames, *args)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / iters
    bound = 40.0 * V * F / PEAK_BYTES
    print(f"tsdf fuse {n}^3 x {F} frames: {per:.3f}s/chunk -> {F / per:.1f} fusion-FPS, "
          f"{V * F / per / 1e9:.2f} Gvoxel-updates/s (bytes bound of a frame-at-a-time pass "
          f"{bound * 1e3:.2f} ms/chunk: 40 B/voxel/frame over 3.35 TB/s)", flush=True)
    return {"s_per_chunk": per, "fps": F / per, "gvoxel_updates_per_s": V * F / per / 1e9,
            "bound_s": bound, "voxels": V, "frames": F}


# --- the JAX package's model-shape probes (global, frame, packed, block,
# stages, mlp-sweep, forward, refine, kv-accuracy): the port's kernels at the
# JAX probes' shapes, each beside one SDPA or cuBLAS call where one computes
# the same function; the TPU knobs (block sizes, interleave, ln_stats) do not
# apply.

LOG2_E = 1.4426950408889634
GLOBAL_T, FRAME_SHAPES, HEADS, HEAD_DIM = 66000, ((100, 660), (100, 643)), 16, 64
CHUNK_FRAMES, CHUNK_H, CHUNK_W = 100, 308, 406
# every MLP shape the paths send, (lead, C, hidden, entry, dtypes): Pi3's
# global and frame blocks (the encoder, frame, head and global blocks all at C
# 1024; bf16, and fp32 under --compute-dtype float32), MoGe-2's ViT-S encoder
# at 3,537 tokens and MoGe v1's ViT-L encoder at 2,452 (fp32 trunks), the
# cross-attention block's bare MLP at one and four frames' tokens
MLP_SWEEP = (((1, 64300), 1024, 4096, "block_mlp", ("bfloat16", "float32")),
             ((100, 643), 1024, 4096, "block_mlp", ("bfloat16", "float32")),
             ((1, 3537), 384, 1536, "block_mlp", ("float32",)),
             ((1, 2452), 1024, 4096, "block_mlp", ("float32",)),
             ((4, 643), 1024, 4096, "mlp", ("bfloat16", "float32")),
             ((1, 2572), 1024, 4096, "mlp", ("bfloat16", "float32")))


def _line(name: str, shape: str, ms: float, flops: float, bound=None, exp2=None) -> None:
    """One timed row; ``bound`` = (ms, by) from ``ops/roofline.bound``,
    ``exp2`` = the call's exp2 count, its own bound beside."""
    extra = "" if bound is None else f"   bound {bound[0]:8.3f} ms ({bound[1]})"
    if exp2 is not None:
        from ..ops.roofline import exp2_ms

        extra += f"   exp2 bound {exp2_ms(exp2):8.3f} ms"
    print(f"{name:48s} {shape:26s} {ms:9.3f} ms {flops / ms / 1e9:8.1f} TFLOP/s{extra}",
          flush=True)


def _randn(*shape, scale=0.1, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)


def _sdpa(q, k, v, scale=None):
    """One SDPA call on (B, T, H, D) q / k / v as (B, H, T, D) views."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)


def _held(name: str, shape: str, run, plain, why: str, **bounds) -> None:
    """The kernel's output at this shape against its plain version's before
    it is timed (``ops/compare.hold``: raises if it disagrees); these
    launches do not count."""
    from ..ops import uncounted
    from ..ops.compare import hold

    with uncounted(), torch.no_grad():
        hold(name, shape, run(), plain(), why, **bounds)


def _attention_row(name, shape, run, b, t, h, d, iters=ITERS):
    """Time a bf16 attention call at (b, t, h, d); its bound counts q, k, v
    and the output once and the products at the bf16 peak, and beside it
    the exp2s (ops/roofline)."""
    from ..ops.roofline import attention_work, bound

    flops, nbytes = attention_work(b, t, h, d, 2)
    lim = bound(flops, nbytes)
    ms = _time_ms(run, iters)
    _line(name, shape, ms, flops, lim, exp2=b * h * t * t)
    return {"ms": ms, "tflops": flops / ms / 1e9, "bound_ms": lim[0], "bound_by": lim[1]}


ATTENTION_WHY = "bf16 P, bf16 output"


def bench_global() -> dict:
    """The global attention at (1, 66000, 16, 64) bf16: ``flash_attention``
    (row 6, (B, T, H, D) operands) and ``flash_attention_packed`` (row 1, the
    packed qkv with q pre-scaled), each held against its plain version
    first, beside one SDPA call."""
    if not torch.cuda.is_available():
        raise RuntimeError("the global attention probe needs an NVIDIA GPU")
    from ..ops.compare import ATTENTION
    from ..ops.flash_attention import blockwise_attention, flash_attention
    from ..ops.packed_attention import flash_attention_packed, packed_attention_plain

    b, t, h, d = 1, GLOBAL_T, HEADS, HEAD_DIM
    shape = f"({b}, {t}, {h}, {d})"
    qkv = _randn(b, t, 3, h, d)
    q, k, v = qkv.unbind(2)
    packed = qkv.clone()
    packed[:, :, 0] *= d**-0.5 * LOG2_E  # the producer's scale, as the main path hands it
    packed = packed.reshape(b, t, 3 * h * d)
    _held("flash_attention", shape, lambda: flash_attention(q, k, v),
          lambda: blockwise_attention(q, k, v), ATTENTION_WHY, **ATTENTION)
    _held("flash_attention_packed", shape, lambda: flash_attention_packed(packed, h),
          lambda: packed_attention_plain(packed, h), ATTENTION_WHY, **ATTENTION)
    res = {"flash_attention": _attention_row("flash_attention (row 6)", shape,
                                             lambda: flash_attention(q, k, v), b, t, h, d),
           "flash_attention_packed": _attention_row("flash_attention_packed (row 1)", shape,
                                                    lambda: flash_attention_packed(packed, h),
                                                    b, t, h, d),
           "sdpa": _attention_row("SDPA", shape, _sdpa(q, k, v), b, t, h, d)}
    return res


def bench_frame() -> dict:
    """The frame attention at (100, 660) and (100, 643) x (16, 64) bf16:
    ``attention_single_pass`` (row 7), held against its plain version
    (``blockwise_attention``, fp32) first, beside one SDPA call and that
    plain version."""
    if not torch.cuda.is_available():
        raise RuntimeError("the frame attention probe needs an NVIDIA GPU")
    from ..ops.compare import ATTENTION
    from ..ops.flash_attention import attention_single_pass, blockwise_attention

    res = {}
    for b, t in FRAME_SHAPES:
        h, d = HEADS, HEAD_DIM
        shape = f"({b}, {t}, {h}, {d})"
        q, k, v = _randn(b, t, 3, h, d).unbind(2)
        _held("attention_single_pass", shape, lambda: attention_single_pass(q, k, v),
              lambda: blockwise_attention(q, k, v), ATTENTION_WHY, **ATTENTION)
        res[shape] = {
            "attention_single_pass": _attention_row("attention_single_pass (row 7)", shape,
                                                    lambda: attention_single_pass(q, k, v),
                                                    b, t, h, d, iters=10),
            "sdpa": _attention_row("SDPA", shape, _sdpa(q, k, v), b, t, h, d, iters=10),
            "plain": _attention_row("plain (blockwise_attention)", shape,
                                    lambda: blockwise_attention(q, k, v), b, t, h, d)}
    return res


def bench_packed() -> dict:
    """The packed-qkv kernels at the JAX probe's shapes, bf16, q pre-scaled:
    ``attention_single_pass_packed`` (row 2) at (100, 660, 3072) and
    ``flash_attention_packed`` (row 1) at (1, 66000, 3072), each held against
    its plain version first, beside one SDPA call on the same views."""
    if not torch.cuda.is_available():
        raise RuntimeError("the packed attention probe needs an NVIDIA GPU")
    from ..ops.compare import ATTENTION
    from ..ops.packed_attention import (
        attention_single_pass_packed, flash_attention_packed, packed_attention_plain)

    res = {}
    h, d = HEADS, HEAD_DIM
    for (b, t), name, fn, iters in (((100, 660), "attention_single_pass_packed",
                                     attention_single_pass_packed, 10),
                                    ((1, GLOBAL_T), "flash_attention_packed",
                                     flash_attention_packed, ITERS)):
        qkv = _randn(b, t, 3 * h * d)
        shape = f"({b}, {t}, {3 * h * d})"
        q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
        _held(name, shape, lambda: fn(qkv, h), lambda: packed_attention_plain(qkv, h),
              ATTENTION_WHY, **ATTENTION)
        row = "row 2" if b > 1 else "row 1"
        res[shape] = {
            "kernel": _attention_row(f"{name} ({row})", shape, lambda: fn(qkv, h), b, t, h, d,
                                     iters=iters),
            # the kernel's q is pre-scaled to base 2: softmax_2(x) = softmax(x ln 2)
            "sdpa": _attention_row("SDPA", shape, _sdpa(q, k, v, scale=0.6931471805599453), b, t,
                                   h, d, iters=iters)}
    return res


def _decoder_block(c: int = 1024, heads: int = HEADS, dtype=torch.bfloat16):
    """A Pi3 decoder block (qk-norm, LayerScale 0.01) with the port's random
    block init of seed 0, on the card."""
    from ..models.convert import _blocks, _contiguous, _init_block_stack
    from ..models.layers import Block

    sd = {}
    _blocks(sd, "b", _init_block_stack(0, 1, c, 4, True, 0.01, heads), [0])
    blk = Block(c, heads, 4, qk_norm=True, layerscale=True, device="meta")
    blk.load_state_dict({k[len("b.0."):]: v for k, v in sd.items()}, strict=True, assign=True)
    return _contiguous(blk.to(device="cuda", dtype=dtype)).eval()


def bench_block() -> dict:
    """One Pi3 decoder block (LayerNorm, qkv, the producer's qk-norm and RoPE,
    the packed kernel, the projection, the block MLP) at the global shape (1,
    64300, 1024) and the frame shape (100, 643, 1024), bf16, against its packed
    kernel alone on the same shape: the difference is the rest of the block
    (the producer, the projections and the MLP kernel among it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the block probe needs an NVIDIA GPU")
    from ..ops.packed_attention import attention_single_pass_packed, flash_attention_packed
    from ..ops.rope import make_patch_positions, rope_tables

    n, hw, c, h, d = CHUNK_FRAMES, 643, 1024, HEADS, HEAD_DIM
    blk = _decoder_block(c, h)
    cos, sin = rope_tables(make_patch_positions(n, 22, 29, num_special=5, offset=1, device="cuda"),
                           d)
    res = {}
    for name, (b, t), rope, kernel in (
            ("global", (1, n * hw), (cos.reshape(1, n * hw, d), sin.reshape(1, n * hw, d)),
             flash_attention_packed),
            ("frame", (n, hw), (cos, sin), attention_single_pass_packed)):
        x = _randn(b, t, c)
        qkv = _randn(b, t, 3 * c)
        shape = f"({b}, {t}, {c})"
        with torch.no_grad():
            ms = _time_ms(lambda: blk(x, rope=rope))
        kms = _time_ms(lambda: kernel(qkv, h))
        flops = 4.0 * b * h * t * t * d
        print(f"{name} block() full {shape:22s} {ms:9.3f} ms; packed kernel alone {kms:9.3f} ms "
              f"({flops / kms / 1e9:.1f} TFLOP/s); non-kernel overhead per {name} block "
              f"{ms - kms:.3f} ms", flush=True)
        res[name] = {"block_ms": ms, "kernel_ms": kms, "overhead_ms": ms - kms}
    return res


_PI3 = {}  # the random full-width Pi3 of a process, built once (bf16 on the card)


def _pi3(merge: int = 1):
    """The full-width Pi3 with random weights from seed 0 (or the
    ``PI3_WEIGHTS`` checkpoint) in bf16 on the card, built once a process;
    ``merge`` sets its global kv-merge for the calls that follow."""
    import dataclasses
    import os

    from ..models.convert import build_pi3, init_pi3_params, load_pi3_checkpoint, pi3_state_from_jax
    from ..models.pi3 import Pi3Config

    if "model" not in _PI3:
        path = os.environ.get("PI3_WEIGHTS")
        if path:
            tree, cfg = load_pi3_checkpoint(path)
            cfg = cfg or Pi3Config()
        else:
            cfg = Pi3Config()
            tree = init_pi3_params(0, cfg)
        _PI3["model"] = build_pi3(cfg, pi3_state_from_jax(tree), torch.device("cuda"),
                                  torch.bfloat16)
        _PI3["weights"] = "real" if path else "RANDOM"
    model = _PI3["model"]
    model.cfg = dataclasses.replace(model.cfg, global_kv_merge=merge)
    return model


def _chunk_images(n=CHUNK_FRAMES, h=CHUNK_H, w=CHUNK_W):
    import numpy as np

    return torch.from_numpy(np.random.default_rng(0).uniform(size=(1, n, 3, h, w))
                            .astype(np.float32)).cuda()


def bench_stages() -> dict:
    """The full-width bf16 forward at 100 frames of 308x406, stage by stage on
    the card-resident inputs of each: the encoder (24 blocks), the decoder (36
    blocks, frame and global), one head decoder (5 blocks) and the dense heads
    (fp32 linears, the camera head's SVD, the world points); their sum as
    frames/s."""
    if not torch.cuda.is_available():
        raise RuntimeError("the stages probe needs an NVIDIA GPU")
    from ..ops.rope import make_patch_positions

    model = _pi3()
    cfg = model.cfg
    n, h, w = CHUNK_FRAMES, CHUNK_H, CHUNK_W
    ph, pw = h // 14, w // 14
    reg = cfg.num_register_tokens
    imgs = _chunk_images()[0]
    hidden = _randn(n, ph * pw, cfg.dec_embed_dim)
    hidden_cat = _randn(n, ph * pw + reg, 2 * cfg.dec_embed_dim)
    pos = make_patch_positions(n, ph, pw, num_special=reg, offset=1, device="cuda")
    cam = _randn(n, ph * pw + reg, cfg.camera_dim)
    stages = {
        "encoder (24 blocks, 100 x 643 tokens)": lambda: model.encoder(imgs)["patch_tokens"],
        "decoder (36 blocks, frame / global)": lambda: model._decode(hidden, 1, n, (ph, pw)),
        "one head decoder (5 blocks)": lambda: model._head_decoder_forward(
            model.point_decoder, hidden_cat, pos),
        "dense heads (fp32 linears, SVD, points)": lambda: model._dense_heads(
            hidden_cat[..., :cfg.head_dim], hidden_cat[..., :cfg.head_dim], cam, 1, n, h, w),
    }
    res = {}
    with torch.no_grad():
        for name, run in stages.items():
            res[name] = _time_ms(run)
            print(f"{name:48s} {res[name]:9.3f} ms", flush=True)
    heads = list(res)
    total = res[heads[0]] + res[heads[1]] + 3 * res[heads[2]] + res[heads[3]]
    print(f"sum of stages: {total:.1f} ms -> {n / total * 1e3:.2f} frames/s (encoder, decoder, "
          f"3 x head decoder, dense heads)", flush=True)
    res["sum_ms"] = total
    return res


def bench_mlp_sweep() -> dict:
    """Each MLP entry (``block_mlp``, ``mlp``) at every shape and dtype the
    paths send it (MLP_SWEEP; the GEMMs take no tile settings at run time, so
    the sweep runs over M), held against its plain version first, then timed
    beside that plain version and the two bare cuBLAS products of its dtype
    (TF32 off), with its bound (ops/roofline)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the MLP sweep needs an NVIDIA GPU")
    import torch.nn.functional as F

    from ..ops.block_mlp import block_mlp, block_mlp_plain
    from ..ops.compare import FP32, MLP, block_mlp_bounds
    from ..ops.mlp import mlp, mlp_plain
    from ..ops.roofline import PEAK_3XTF32, PEAK_BF16, bound, mlp_work

    res = {}
    for lead, c, hidden, entry, dtypes in MLP_SWEEP:
        for dtype in (getattr(torch, name) for name in dtypes):
            x = _randn(*lead, c, scale=1.0, dtype=dtype)
            w1, b1 = _randn(hidden, c, scale=0.02, dtype=dtype, seed=1), _randn(hidden, dtype=dtype)
            w2, b2 = _randn(c, hidden, scale=0.02, dtype=dtype, seed=2), _randn(c, dtype=dtype)
            hmid = _randn(*lead, hidden, dtype=dtype)
            norm = (torch.ones(c, device="cuda"), torch.zeros(c, device="cuda"))
            ls = torch.full((c,), 0.9, device="cuda")
            flops, nbytes = mlp_work(x, w1)
            lim = bound(flops, nbytes, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_3XTF32)
            shape = f"({lead[0]}, {lead[1]}, {c})/{hidden} {str(dtype)[6:]}"
            if entry == "block_mlp":
                run = lambda: block_mlp(x, *norm, w1, b1, w2, b2, ls=ls)  # noqa: E731
                plain = lambda: block_mlp_plain(x, *norm, w1, b1, w2, b2, ls=ls)  # noqa: E731
                with torch.no_grad():
                    bounds = block_mlp_bounds(x, plain())
            else:
                run = lambda: mlp(x, w1, b1, w2, b2)  # noqa: E731
                plain = lambda: mlp_plain(x, w1, b1, w2, b2)  # noqa: E731
                bounds = FP32 if dtype == torch.float32 else MLP
            why = "3xTF32 products" if dtype == torch.float32 else "bf16 fc outputs, bf16 out"
            _held(entry, shape, run, plain, why, **bounds)
            runs = {entry: run, f"{entry} plain": plain,
                    "2 x F.linear (cuBLAS, no bias)": lambda: (F.linear(x, w1), F.linear(hmid, w2))}
            res[shape] = {}
            m = x.numel() // c
            for name, fn in runs.items():
                ms = _time_ms(fn, MLP_ITERS if m < 10000 else ITERS)
                res[shape][name] = ms
                _line(name, shape, ms, flops, lim if name == entry else None)
            del x, hmid, w1, w2
    return res


def _forward_ms(model, imgs, iters: int = ITERS) -> float:
    with torch.no_grad():
        return _time_ms(lambda: model(imgs), iters)


def bench_forward() -> dict:
    """The full-width bf16 forward at (1, 100, 3, 308, 406); ``PI3_KV_MERGE=m``
    times the kv-merge global attention at the same shape (speed only; the
    ``kv-accuracy`` probe measures what it changes)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the forward probe needs an NVIDIA GPU")
    import os

    merge = int(os.environ.get("PI3_KV_MERGE", "1"))
    ms = _forward_ms(_pi3(merge), _chunk_images())
    _pi3(1)
    tag = f" (kv_merge={merge})" if merge > 1 else ""
    print(f"pi3 forward full{tag}: {ms:.1f} ms = {CHUNK_FRAMES / ms * 1e3:.2f} frames/s",
          flush=True)
    return {"ms": ms, "fps": CHUNK_FRAMES / ms * 1e3, "merge": merge}


def bench_refine() -> dict:
    """The chunk step (forward, masks, intrinsics, keypoint sampling) at 100
    frames of 308x406 and 400 keypoints, without and with the ZNCC
    observation refinement (fan 10, patch radius 3, search radius 4, min
    ZNCC 0.5): ms a chunk and frames/s."""
    if not torch.cuda.is_available():
        raise RuntimeError("the refine probe needs an NVIDIA GPU")
    import numpy as np

    from ..slam.chunk_creator import _fan_table, make_chunk_step

    model = _pi3()
    rng = np.random.default_rng(0)
    n = CHUNK_FRAMES
    imgs = (_chunk_images()[0] * 255).to(torch.uint8)
    kps = torch.from_numpy(np.stack([rng.uniform(8, 398, (n, 400)), rng.uniform(8, 300, (n, 400))],
                                    axis=-1).astype(np.float32)).cuda()
    res = {}
    for refine, label in ((None, "chunk step (no refinement)"),
                          ((10, 3, 4, 0.5), "chunk step + ZNCC observation refinement")):
        step = make_chunk_step(model, 0.1, 0.03, True, refine_obs=refine)
        cand = None if refine is None else torch.from_numpy(_fan_table(n, n, refine[0])).cuda()
        with torch.no_grad():
            ms = _time_ms(lambda: step(imgs, kps, cand))
        res[label] = ms
        print(f"{label:48s} {ms:9.1f} ms = {n / ms * 1e3:.2f} frames/s", flush=True)
    return res


def bench_kv_accuracy() -> dict:
    """The kv-merge global attention against exact attention on the same
    weights (``PI3_WEIGHTS=<converted npz>`` for a real checkpoint; random
    weights check the plumbing only) over ``PI3_KV_FRAMES`` (20) frames of
    154x210 at merge ``PI3_KV_MERGE`` (2): the largest pose angle difference,
    the camera-centre RMSE (and its share of the trajectory span) and the
    point RMSE."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kv-accuracy probe needs an NVIDIA GPU")
    import os

    import numpy as np

    n = int(os.environ.get("PI3_KV_FRAMES", "20"))
    merge = int(os.environ.get("PI3_KV_MERGE", "2"))
    imgs = _chunk_images(n, 154, 210)
    outs = {}
    for m in (1, merge):
        with torch.no_grad():
            outs[m] = {k: v.float().cpu().numpy() for k, v in _pi3(m)(imgs).items()}
    _pi3(1)
    a, b = outs[1], outs[merge]
    ra, rb = a["camera_poses"][0, :, :3, :3], b["camera_poses"][0, :, :3, :3]
    tr = np.clip((np.einsum("nij,nij->n", ra, rb) - 1) / 2, -1, 1)
    ang = float(np.degrees(np.arccos(tr)).max())
    ca, cb = a["camera_poses"][0, :, :3, 3], b["camera_poses"][0, :, :3, 3]
    span = float(np.linalg.norm(ca.max(0) - ca.min(0)))
    c_rmse = float(np.sqrt(((ca - cb) ** 2).mean()))
    p_rmse = float(np.sqrt(((a["points"] - b["points"]) ** 2).mean()))
    print(f"kv-merge accuracy vs exact ({_PI3['weights']} weights, {n} frames, merge {merge}): "
          f"max pose angle diff {ang:.3f} deg, center RMSE {c_rmse:.4g} "
          f"({c_rmse / max(span, 1e-9):.2%} of trajectory span), point RMSE {p_rmse:.4g}",
          flush=True)
    return {"max_angle_deg": ang, "center_rmse": c_rmse, "span": span, "point_rmse": p_rmse}


# the JAX tool's default set, in its order
ALL = ("global", "frame", "block", "packed", "stages", "mlp", "forward")


def bench_all() -> dict:
    return {name: PROBES[name]() for name in ALL}


PROBES = {"all": bench_all, "global": bench_global, "frame": bench_frame, "block": bench_block,
          "packed": bench_packed, "stages": bench_stages, "mlp": bench_mlp,
          "mlp-sweep": bench_mlp_sweep, "sol": bench_sol, "forward": bench_forward,
          "refine": bench_refine, "kv-accuracy": bench_kv_accuracy, "tf32": bench_tf32,
          "tiles": bench_tiles, "tsdf": bench_tsdf}


def probe(argv=None) -> dict:
    """Parse ``argv`` and run the named probe (``all`` by default: the JAX
    tool's default set, ALL) on the GPU; returns its results. Exits with
    code 2 on a name that is not a probe."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("probe", nargs="?", default="all")
    args = parser.parse_args(argv)
    if args.probe not in PROBES:
        parser.error(f"unknown probe {args.probe!r}; the probes are "
                     f"{', '.join(map(repr, PROBES))}")
    from ..device import select_device

    select_device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    return PROBES[args.probe]()


def main(argv=None) -> int:
    probe(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
