"""The port's (B, T, H, D) attention (pi3_slam_tpu_torch/ops/attention.py and
ops/flash_attention.py) against the JAX package, on the CPU.

* ``blockwise_attention`` (the plain version of the hand-written
  ``flash_attention`` / ``attention_single_pass`` kernel, and what a CPU
  tensor runs) against the Pallas ``flash_attention_tpu`` and
  ``attention_single_pass_tpu`` in interpret mode, both variants ("bound"
  and "max"), at the sizes of tests/test_pallas_attention.py.
* ``sdpa`` against the JAX ``sdpa`` on the CPU, below and above
  ``LONG_SEQUENCE_THRESHOLD`` and with Tk != Tq; ``sdpa_route`` against the
  JAX dispatch itself (its kernels stubbed, "on TPU" for "on CUDA");
  ``attention_score_matrix``.

fp32 on both sides, different summation order: atol 2e-5 on outputs of order
1 (the Pallas tests' own tolerance), 3e-5 where the Pallas test allowed it.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pi3_slam_tpu.ops.attention as jax_attention
import pi3_slam_tpu.ops.flash_attention as jax_flash
import pi3_slam_tpu.ops.pallas_attention as jax_pallas

from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops.attention import (
    LONG_SEQUENCE_THRESHOLD,
    attention_score_matrix,
    sdpa,
    sdpa_reference,
    sdpa_route,
)
from pi3_slam_tpu_torch.ops.compare import ATTENTION, compare
from pi3_slam_tpu_torch.ops.flash_attention import (
    attention_single_pass,
    blockwise_attention,
    flash_attention,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the port's CPU runs are chains of
    small operations, which the oversubscribed thread pools of parallel test
    workers slow down many times over; no result here depends on the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 2e-5


def _qkv(rng, b, tq, h, d, tk=None):
    tk = tq if tk is None else tk
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("variant", ["bound", "max"])
@pytest.mark.parametrize("t", [300, 256, 700])
def test_blockwise_matches_pallas_flash(rng, t, variant):
    q, k, v = _qkv(rng, 1, t, 2, 64)
    want = jax_pallas.flash_attention_tpu(*map(jnp.asarray, (q, k, v)), blk_q=128, blk_k=128,
                                          variant=variant, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v))  # a CPU tensor: blockwise_attention
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)
    # key blocks smaller than T cross the online-softmax rescale
    np.testing.assert_allclose(blockwise_attention(_t(q), _t(k), _t(v), block_size=128).numpy(),
                               np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("variant", ["bound", "max"])
@pytest.mark.parametrize("t", [300, 256])
def test_blockwise_matches_pallas_single_pass(rng, t, variant):
    q, k, v = _qkv(rng, 2, t, 2, 64)
    want = jax_pallas.attention_single_pass_tpu(*map(jnp.asarray, (q, k, v)), variant=variant,
                                                interpret=True)
    got = attention_single_pass(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("tq,tk", [(300, 170), (190, 333), (643, 129), (129, 643), (4100, 2050)])
def test_blockwise_masks_keys_by_length(rng, tq, tk):
    """Tk < Tq and Tk > Tq, neither a multiple of the key block: the JAX
    kernels cannot take these (they pad k to q's lattice); the XLA route
    can, and blockwise_attention matches it."""
    q, k, v = _qkv(rng, 2, tq, 2, 64, tk)
    want = jax_attention.sdpa_reference(*map(jnp.asarray, (q, k, v)))
    for block in (64, 1024):
        got = blockwise_attention(_t(q), _t(k), _t(v), block_size=block)
        assert got.shape == (2, tq, 2, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("tq,tk,d", [(100, 100, 64), (700, 700, 64), (4100, 4100, 64),
                                     (300, 170, 64), (120, 250, 32)])
def test_sdpa_matches_jax(rng, tq, tk, d):
    """T = 4100 crosses LONG_SEQUENCE_THRESHOLD into blockwise attention on
    both sides; the rest take the plain route (XLA on the JAX side)."""
    q, k, v = _qkv(rng, 1, tq, 2, d, tk)
    want = jax_attention.sdpa(*map(jnp.asarray, (q, k, v)))
    before = launch_counts()
    got = sdpa(_t(q), _t(k), _t(v))
    assert launch_counts() == before  # CPU tensors never count a launch
    assert got.shape == (1, tq, 2, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (tq >= LONG_SEQUENCE_THRESHOLD) == (sdpa_route(tq, d, False) == "blockwise")


@pytest.mark.parametrize("tq,d", [(300, 192), (700, 256), (4100, 192), (4100, 256), (300, 320),
                                  (4100, 320), (300, 384), (300, 512)])
def test_wide_head_dims_match_jax(rng, tq, d):
    """Head dims 192 and 256 (the card's TMA + wgmma loop at its widest
    tiles) and 320, 384, 512 (its wide variant: one slice of O, then two):
    sdpa and the kernels' plain version (what flash_attention and
    attention_single_pass run on a CPU tensor) against the JAX sdpa (its XLA
    route, or blockwise attention at T >= 4096)."""
    q, k, v = _qkv(rng, 1, tq, 2, d)
    want = np.asarray(jax_attention.sdpa(*map(jnp.asarray, (q, k, v))))
    assert sdpa_route(tq, d, True) == ("flash" if tq > 1280 else "single_pass")
    for fn in (sdpa, flash_attention, attention_single_pass):
        got = fn(_t(q), _t(k), _t(v))
        assert got.shape == (1, tq, 2, d)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_sdpa_takes_no_implementation():
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError):
        sdpa(q, q, q, implementation="cudnn")


@pytest.mark.parametrize("t", [100, 255, 256, 700, 1280, 1281, 2572, 4095, 4096, 64300])
@pytest.mark.parametrize("d", [32, 64, 96, 128, 192, 256])
@pytest.mark.parametrize("on_device", [True, False])
def test_sdpa_route_follows_the_jax_dispatch(monkeypatch, t, d, on_device):
    """The JAX sdpa with its kernels and XLA call stubbed to name themselves,
    and "on TPU" set as the port's "on CUDA"."""
    monkeypatch.setattr(jax_attention, "on_tpu_platform", lambda: on_device)
    monkeypatch.setattr(jax_pallas, "flash_attention_tpu", lambda *a, **kw: "flash")
    monkeypatch.setattr(jax_pallas, "attention_single_pass_tpu", lambda *a, **kw: "single_pass")
    monkeypatch.setattr(jax_flash, "blockwise_attention", lambda *a, **kw: "blockwise")
    monkeypatch.setattr(jax.nn, "dot_product_attention", lambda *a, **kw: "plain")
    x = jax.ShapeDtypeStruct((1, t, 1, d), jnp.float32)  # never read by the stubs
    assert sdpa_route(t, d, on_device) == jax_attention.sdpa(x, x, x)


@pytest.mark.parametrize("t", [300, 2572, 4096])
@pytest.mark.parametrize("d", [1152, 4096])
def test_sdpa_route_sends_every_wide_head_dim_to_the_kernels(monkeypatch, t, d):
    """Head dims far above the main path's (the card's wide variant streams
    Q and K through its ring, so no head dim is too wide): the kernels on
    CUDA, as in the JAX dispatch (stubbed as above)."""
    monkeypatch.setattr(jax_attention, "on_tpu_platform", lambda: True)
    monkeypatch.setattr(jax_pallas, "flash_attention_tpu", lambda *a, **kw: "flash")
    monkeypatch.setattr(jax_pallas, "attention_single_pass_tpu", lambda *a, **kw: "single_pass")
    x = jax.ShapeDtypeStruct((1, t, 1, d), jnp.float32)
    assert sdpa_route(t, d, True) == jax_attention.sdpa(x, x, x)
    assert sdpa_route(t, d, True) in ("flash", "single_pass")


def test_score_matrix_matches_jax(rng):
    frames, tokens = 3, 40
    q, k, _ = _qkv(rng, 2, frames * tokens, 2, 32)
    want = jax_attention.attention_score_matrix(jnp.asarray(q), jnp.asarray(k), frames, tokens)
    got = attention_score_matrix(_t(q), _t(k), frames, tokens)
    assert got.shape == (2, frames, frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


def test_sdpa_reference_matches_jax(rng):
    q, k, v = _qkv(rng, 2, 50, 3, 16, 70)
    want = jax_attention.sdpa_reference(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(sdpa_reference(_t(q), _t(k), _t(v)).numpy(), np.asarray(want),
                               atol=ATOL)


def _kernel_bf16_p(q, k, v):
    """The hand-written kernel's arithmetic on the CPU: fp32 logits scaled
    by D^-1/2 log2(e), exact max, P rounded to bf16 for PV, bf16 output."""
    d = q.shape[-1]
    q32, k32, v32 = (a.float().transpose(1, 2) for a in (q, k, v))
    s = (q32 @ k32.transpose(-1, -2)) * (d**-0.5 * np.log2(np.e))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = (p.to(torch.bfloat16).float() @ v32) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 512])
def test_chip_bounds_pass_kernel_arithmetic_and_reject_wrong_outputs(rng, d):
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(rng, 2, 300, 2, d, 170))
    got = _kernel_bf16_p(q, k, v)
    ref = blockwise_attention(q, k, v)
    c = compare(got, ref, **ATTENTION)
    assert c.ok and c.rejects_wrong, c
    assert not compare(torch.zeros_like(ref), ref, **ATTENTION).ok
    assert not compare(1.1 * ref.float(), ref, **ATTENTION).ok


def _key_tile(d):
    """The key tile of the (B, T, H, D) loop at head dim d: the N of
    ``BthdTiles<d>`` in csrc/bthd_attention.cuh's tile table."""
    header = Path(__file__).resolve().parent.parent / "pi3_slam_tpu_torch/csrc/bthd_attention.cuh"
    found = re.search(rf"struct BthdTiles<{d}> : TileShape<(\d+),", header.read_text())
    return int(found.group(1))


def _loop_bf16(q, k, v, n):
    """The loop's arithmetic on the CPU, one n-key tile at a time: fp32
    logits (the last tile partial: keys past Tk take no part), a base-2
    online softmax against the exact running max, P rounded to bf16 per tile
    for P V while the row sums take it in fp32, O and the sums rescaled by
    2^(scale (m_old - m_new)) in fp32, normalised at the end, bf16 out."""
    d = q.shape[-1]
    scale = d**-0.5 * np.log2(np.e)
    q32, k32, v32 = (a.float().transpose(1, 2) for a in (q, k, v))
    m = torch.full(q32.shape[:-1], -torch.inf)
    l = torch.zeros(q32.shape[:-1])
    o = torch.zeros(q32.shape)
    for k0 in range(0, k32.shape[2], n):
        s = q32 @ k32[:, :, k0:k0 + n].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        a = torch.exp2((m - m_new) * scale)
        p = torch.exp2(s * scale - (m_new * scale)[..., None])
        l = l * a + p.sum(-1)
        o = o * a[..., None] + p.to(torch.bfloat16).float() @ v32[:, :, k0:k0 + n]
        m = m_new
    return (o / l[..., None]).transpose(1, 2).to(torch.bfloat16)


# key counts against the key tile n, each ending in a partial tile
KEY_COUNTS = {"1": lambda n: 1, "tile - 1": lambda n: n - 1, "tile + 1": lambda n: n + 1,
              "643": lambda n: 643, "4100": lambda n: 4100}


@pytest.mark.parametrize("tk", KEY_COUNTS)
def test_chip_bounds_pass_the_d256_key_tiles_and_reject_wrong_outputs(rng, tk):
    """The D 256 loop's tiling (80-key tiles: 643 and 4100 end in a partial
    tile of 3 and 20 keys) simulated in bf16 against ``blockwise_attention``
    and the JAX ``sdpa`` (its XLA route on the CPU) on the same inputs, within
    ``ops/compare.ATTENTION``; the bounds reject an all-zero and a 10%-off
    output."""
    n = _key_tile(256)
    tk = KEY_COUNTS[tk](n)
    assert tk % n
    qkv = [a.astype(np.float32) for a in _qkv(rng, 1, 70, 2, 256, tk)]
    q, k, v = (_t(a).to(torch.bfloat16) for a in qkv)
    got = _loop_bf16(q, k, v, n)
    ref = blockwise_attention(q, k, v)
    want = torch.from_numpy(np.array(jax_attention.sdpa(
        *(jnp.asarray(a.float().numpy()) for a in (q, k, v)))))
    for r in (ref, want):
        c = compare(got, r, **ATTENTION)
        assert c.ok and c.rejects_wrong, c
        assert not compare(torch.zeros_like(r), r, **ATTENTION).ok
        assert not compare(1.1 * r.float(), r, **ATTENTION).ok
