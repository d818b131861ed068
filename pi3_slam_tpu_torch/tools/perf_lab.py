"""Speed-of-light probe on one NVIDIA GPU: the port of ``bench_sol`` from the
JAX package's ``tools/perf_lab.py``.

    python -m pi3_slam_tpu_torch.tools.perf_lab sol

Times, with CUDA events (one warm-up call, then the mean of ``ITERS`` calls),
and prints ms and TFLOP/s of:

* a square 8192^3 bf16 ``torch.matmul``: the card's practical bf16 peak, a
  yardstick;
* ``dots_attention`` at (1, 65536, 3*16*64): the ``mma.sync`` tile loop of
  ``csrc/flash_tile.cuh`` with the softmax taken out
  (``csrc/dots_attention.cu``);
* ``flash_attention_packed`` at the same shape: the TMA + ``wgmma`` kernel
  with its online softmax (``csrc/packed_attention.cu``);
* ``block_mlp`` at (1, 65536, 1024) with hidden 4096 (``csrc/block_mlp.cu``).

Each against the matmul yardstick says how far its loop is from the tensor
cores' practical rate. The two attention kernels run different loops, so
their difference is not the cost of a softmax. The JAX package's other probes
(global, frame, block, packed, stages, mlp, mlp-sweep, forward, refine,
kv-accuracy, tsdf) are not ported (ROADMAP.md Queue 2, item 9).
"""

from __future__ import annotations

import argparse
import sys

import torch

SQUARE = 8192
SOL_T, SOL_H, SOL_D = 65536, 16, 64
MLP_C, MLP_HIDDEN = 1024, 4096
ITERS = 3  # timed calls of each probe, after one warm-up call


def _time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def bench_sol() -> dict:
    """Run the four probes on the current CUDA device; returns
    {name: {"ms", "tflops", "flops", "shape"}} and prints one line each.
    Inputs are N(0, 0.05^2) in bf16, drawn on the card from seed 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("the speed-of-light probe needs an NVIDIA GPU")
    from ..ops.block_mlp import block_mlp
    from ..ops.dots_attention import dots_attention
    from ..ops.packed_attention import flash_attention_packed

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
    run("dots_attention (the mma.sync loop without softmax)", shape,
        lambda: dots_attention(qkv, SOL_H), aflops)
    run("flash_attention_packed (TMA + wgmma, online softmax)", shape,
        lambda: flash_attention_packed(qkv, SOL_H), aflops)
    del qkv

    x = mk(1, SOL_T, MLP_C)
    w1, w2 = mk(MLP_HIDDEN, MLP_C), mk(MLP_C, MLP_HIDDEN)
    zeros = lambda n: torch.zeros(n, device="cuda")
    ones = lambda n: torch.ones(n, device="cuda")
    run("block_mlp (LN + fc1 + GELU + fc2 + residual)", f"(1, {SOL_T}, {MLP_C})/{MLP_HIDDEN}",
        lambda: block_mlp(x, ones(MLP_C), zeros(MLP_C), w1, zeros(MLP_HIDDEN), w2, zeros(MLP_C)),
        4.0 * SOL_T * MLP_C * MLP_HIDDEN)
    return results


def probe(argv=None) -> dict:
    """Parse ``argv`` and run the named probe on the GPU; returns its
    results (:func:`bench_sol`'s). Exits with code 2 on a probe that is not
    ported."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("probe", nargs="?", default="sol")
    args = parser.parse_args(argv)
    if args.probe != "sol":
        parser.error(f"probe {args.probe!r} is not ported (ROADMAP.md Queue 2, item 9); "
                     "only 'sol' is")
    from ..device import select_device

    select_device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    return bench_sol()


def main(argv=None) -> int:
    probe(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
