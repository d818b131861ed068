"""The dots-only packed attention of the speed-of-light probe on the CPU: the
port's plain version against the TPU kernel body of ``tools/perf_lab.py``
(``bench_sol.dots_kernel``, copied below as that file's function is local to
``bench_sol``) run through ``pallas_call(interpret=True)`` at a small shape
(T 512 and 1280, 256-row blocks, H 4 and 2), and against a jnp statement of
the contract; the chip bounds of ``ops/compare.py`` against the kernel's
arithmetic; the wrapper and the probe's CLI on a machine without a GPU.

Tolerances: the plain version and the jnp contract do the same bf16
products with fp32 accumulation and round at the same two places, but
torch's CPU bf16 matmul and XLA's sum in orders that depend on the CPU (its
avx512_bf16 path, where it has one): at most CONTRACT_ULP_SHARE of the
elements differ from the contract, each by one bf16 ulp or, where a logit
rounded the other way, by at most one bf16 ulp of max |out|. The Pallas kernel adds its key blocks in fp32 in
another order and rounds the output to bf16: at most one bf16 ulp
(2^-8 relative) apart, held to 2^-7 of max |out| and 1e-4 relative L2.
"""

import functools
import subprocess
import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops.compare import DOTS, compare
from pi3_slam_tpu_torch.ops.dots_attention import dots_attention, dots_attention_plain
from pi3_slam_tpu_torch.tools import perf_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 64


def dots_kernel(q_ref, k_ref, v_ref, o_ref, acc_ref, *, nk):
    """tools/perf_lab.py:107-133, as it stands there."""
    ik = pl.program_id(2)

    @pl.when(ik == 0)
    def _():
        acc_ref[...] = jnp.zeros_like(acc_ref)

    kb, vb = k_ref[0], v_ref[0]
    ones = jnp.ones((vb.shape[0], 1), vb.dtype)
    for s in range(2):
        lg = jax.lax.dot_general(
            q_ref[0][:, s * 64 : (s + 1) * 64],
            kb[:, s * 64 : (s + 1) * 64],
            (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        p = lg.astype(vb.dtype)
        vv = jnp.concatenate([vb[:, s * 64 : (s + 1) * 64], ones], axis=1)
        acc_ref[:, s * 65 : (s + 1) * 65] += jax.lax.dot_general(
            p, vv, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
        )

    @pl.when(ik == nk - 1)
    def _():
        o_ref[0] = jnp.concatenate(
            [acc_ref[:, :64], acc_ref[:, 65:129]], axis=1
        ).astype(o_ref.dtype)


def dots_only(x, B, H, T, blk_q=256, blk_k=256):
    """tools/perf_lab.py:135-153 (interpret=True; the TPU compiler params
    are not read in interpret mode)."""
    grid = (B * H // 2, T // blk_q, T // blk_k)
    oq, ok, ov = 0, H // 2, H
    return pl.pallas_call(
        functools.partial(dots_kernel, nk=T // blk_k),
        grid=grid,
        in_specs=[
            pl.BlockSpec((1, blk_q, 128), lambda g, iq, ik: (g // (H // 2), iq, oq + g % (H // 2))),
            pl.BlockSpec((1, blk_k, 128), lambda g, iq, ik: (g // (H // 2), ik, ok + g % (H // 2))),
            pl.BlockSpec((1, blk_k, 128), lambda g, iq, ik: (g // (H // 2), ik, ov + g % (H // 2))),
        ],
        out_specs=pl.BlockSpec((1, blk_q, 128), lambda g, iq, ik: (g // (H // 2), iq, g % (H // 2))),
        out_shape=jax.ShapeDtypeStruct((B, T, H * D), x.dtype),
        scratch_shapes=[pltpu.VMEM((blk_q, 2 * (D + 1)), jnp.float32)],
        interpret=True,
    )(x, x, x)


def contract(x, B, H, T):
    """The contract in jnp: per head, bf16(sum_k bf16(q . k) v), fp32
    accumulation."""
    q, k, v = (x.reshape(B, T, 3, H, D)[:, :, i] for i in range(3))
    lg = jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32)
    out = jnp.einsum("bhqk,bkhd->bqhd", lg.astype(x.dtype), v, preferred_element_type=jnp.float32)
    return out.astype(x.dtype).reshape(B, T, H * D)


def _bf16_inputs(rng, b, t, h, scale):
    x = (rng.standard_normal((b, t, 3 * h * D)) * scale).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return xb, torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()


# Share of elements allowed off the contract (a machine with avx512_bf16 puts
# 10 of 163,840 there, 6e-5: 8 one ulp off, 2 by two and three ulps of a
# small element, where a logit's bf16 rounding went the other way and moved
# one term of the sum by a bf16 ulp of that term).
CONTRACT_ULP_SHARE = 1e-3


def _bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps between bf16-valued fp32 arrays:
    their patterns' top halves as ordered integers."""
    def ordered(x):
        hi = (np.ascontiguousarray(x, np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(hi < 0, -32768 - hi, hi)  # sign-magnitude to two's order
    return np.abs(ordered(a) - ordered(b))


def _near_contract(got, want):
    """At most CONTRACT_ULP_SHARE of the elements off the contract, each by
    one bf16 ulp or by at most one bf16 ulp of max |want| (2^-8 of it)."""
    ulps = _bf16_ulps(got, want)
    near = (ulps <= 1) | (np.abs(got - want) <= 2.0**-8 * np.abs(want).max())
    return bool(near.all() and np.count_nonzero(ulps) <= CONTRACT_ULP_SHARE * ulps.size)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not torch.is_tensor(a) else (
        a.float().numpy())


@pytest.mark.parametrize("scale,T,H", [(0.05, 512, 4), (0.5, 512, 4), (0.5, 1280, 2)])
def test_plain_matches_the_pallas_dots_kernel_and_the_contract(rng, scale, T, H):
    """T 1280 spans two of the plain version's 1024-query blocks, the second
    one partial."""
    B = 1
    xb, xt = _bf16_inputs(rng, B, T, H, scale)
    before = launch_counts()
    got = _f32(dots_attention(xt, H))  # a CPU tensor: the plain version
    assert launch_counts() == before
    exact = _f32(contract(xb, B, H, T))
    assert _near_contract(got, exact), np.bincount(_bf16_ulps(got, exact).ravel())
    assert not _near_contract(np.zeros_like(got), exact)
    assert not _near_contract(_f32(torch.from_numpy(1.1 * got).bfloat16()), exact)
    want = _f32(dots_only(xb, B, H, T))
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_chip_bounds_pass_kernel_arithmetic_and_reject_wrong_outputs(rng):
    """The card's kernel rounds the fp32 logits and the output where the plain
    version does, but sums in another order: simulated here by the fp32
    logits rounded after an fp64 product."""
    _, xt = _bf16_inputs(rng, 1, 700, 2, 0.5)
    ref = dots_attention_plain(xt, 2)
    x = xt.double().view(1, 700, 3, 2, D)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    lg = (q @ k.transpose(-1, -2)).float().bfloat16().double()
    got = (lg @ v).transpose(1, 2).reshape(1, 700, 2 * D).bfloat16()
    c = compare(got, ref, **DOTS)
    assert c.ok and c.rejects_wrong, c
    assert not compare(torch.zeros_like(ref), ref, **DOTS).ok
    assert not compare(1.1 * ref.float(), ref, **DOTS).ok


def test_wrapper_checks_shapes():
    with pytest.raises(ValueError):
        dots_attention(torch.zeros(1, 8, 3 * 2 * 32), 2)  # head dim 32
    with pytest.raises(ValueError):
        dots_attention(torch.zeros(8, 3 * 64), 1)


def test_probe_needs_a_gpu_and_names_its_unported_siblings():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probe runs")
    with pytest.raises(RuntimeError, match="GPU"):
        perf_lab.bench_sol()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "pi3_slam_tpu_torch.tools.perf_lab", "global"],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 2 and "ROADMAP.md Queue 2" in proc.stderr
    proc = subprocess.run([sys.executable, "-m", "pi3_slam_tpu_torch.tools.perf_lab", "sol"],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
