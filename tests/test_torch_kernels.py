"""The port's four on-path kernels (pi3_slam_tpu_torch/ops) against the JAX
package's Pallas TPU kernels run in interpret mode on the CPU.

On the CPU every wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions (what the hand-written Hopper kernels are
compared with on the card) to the TPU kernels' contracts: same inputs, made
with numpy from a seed, through both. Shapes are small but keep D = 64 and
an even H, the TPU kernels' contract. Tolerances are fp32 ones: both sides
compute in fp32 and differ only in summation order.

The hand-written kernels themselves are compared with these plain versions
on the GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pi3_slam_tpu.ops.pallas_attention import (
    attention_single_pass_packed_tpu,
    flash_attention_packed_tpu,
    flash_packed_lattice,
)
from pi3_slam_tpu.ops.pallas_mlp import block_mlp_fused_tpu
from pi3_slam_tpu.ops.pallas_producer import qkv_rope_producer_tpu
from pi3_slam_tpu.ops.rope import make_patch_positions as jax_positions
from pi3_slam_tpu.ops.rope import rope_tables as jax_rope_tables

from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops.block_mlp import block_mlp, block_mlp_plain
from pi3_slam_tpu_torch.ops.compare import ATTENTION, PRODUCER, block_mlp_bounds, compare
from pi3_slam_tpu_torch.ops.packed_attention import (
    attention_single_pass_packed,
    flash_attention_packed,
    packed_attention_plain,
    positive_scale,
)
from pi3_slam_tpu_torch.ops.qkv_producer import qkv_rope_producer, qkv_rope_producer_plain

D = 64
# fp32 on both sides, different summation order (LayerNorm / softmax sums)
ATOL = 3e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _norm_params(rng):
    return {
        "q_norm_scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        "q_norm_bias": (0.1 * rng.standard_normal(D)).astype(np.float32),
        "k_norm_scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        "k_norm_bias": (0.1 * rng.standard_normal(D)).astype(np.float32),
    }


def _tables(b, t, with_rope):
    if with_rope:
        pos = jax_positions(b, t // 10, 10, num_special=t % 10, offset=1)
        cos, sin = jax_rope_tables(pos, D, base=100.0)
        return np.asarray(cos), np.asarray(sin)
    return np.ones((b, t, D), np.float32), np.zeros((b, t, D), np.float32)


@pytest.mark.parametrize(
    "b,t,h,out_t,with_norm,with_rope",
    [
        (2, 300, 4, 384, True, True),  # decoder block: norm + rope, zero rows to out_t
        (3, 260, 2, 260, False, True),  # head block: rope only, unpadded
        (1, 384, 4, 512, True, False),  # norm only
        (2, 190, 6, 256, True, True),  # H 6 (C 384): the kernel masks its last pass
    ],
)
def test_producer_plain_matches_pallas(rng, b, t, h, out_t, with_norm, with_rope):
    qkv = rng.standard_normal((b, t, 3 * h * D)).astype(np.float32)
    cos, sin = _tables(b, t, with_rope)
    norm = _norm_params(rng) if with_norm else {}
    want, want_kn = qkv_rope_producer_tpu(
        jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin), h, out_t, eps=1e-5,
        return_k_norms=True, interpret=True, **{k: jnp.asarray(v) for k, v in norm.items()},
    )
    got, got_kn = qkv_rope_producer(
        _t(qkv), _t(cos), _t(sin), h, out_t, eps=1e-5, return_k_norms=True,
        **{k: _t(v) for k, v in norm.items()},
    )
    assert got.shape == (b, out_t, 3 * h * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    assert not got[:, t:].any()  # rows >= T are exact zeros
    np.testing.assert_allclose(got_kn.numpy(), np.asarray(want_kn), rtol=1e-5)


def _packed_input(rng, b, t, h, out_t):
    """A producer-made packed tensor (q pre-scaled, zero rows to out_t)."""
    qkv = rng.standard_normal((b, t, 3 * h * D)).astype(np.float32)
    cos, sin = _tables(b, t, True)
    norm = {k: _t(v) for k, v in _norm_params(rng).items()}
    return qkv_rope_producer_plain(_t(qkv), _t(cos), _t(sin), h, out_t, **norm)


@pytest.mark.parametrize("b,t,h,out_t", [(2, 300, 4, 300), (3, 190, 2, 256)])
def test_single_pass_plain_matches_pallas(rng, b, t, h, out_t):
    packed = _packed_input(rng, b, t, h, out_t)
    true_t = None if out_t == t else t
    want = attention_single_pass_packed_tpu(
        jnp.asarray(packed.numpy()), h, true_t=true_t, interpret=True
    )
    got = attention_single_pass_packed(packed, h, true_t=true_t)
    assert got.shape == (b, t, h * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("s", [D**-0.5 * np.log2(np.e), 0.0, -0.3])
def test_single_pass_q_scale_plain_matches_pallas(rng, s):
    """Encoder blocks: raw qkv, softmax scale on the fp32 logits; the JAX
    function takes any scale, 0 (uniform weights) and negative ones too."""
    b, t, h = 2, 270, 2
    qkv = rng.standard_normal((b, t, 3 * h * D)).astype(np.float32)
    want = attention_single_pass_packed_tpu(jnp.asarray(qkv), h, q_scale=s, interpret=True)
    got = attention_single_pass_packed(_t(qkv), h, q_scale=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("s", [0.0, -0.3, 0.5])
def test_positive_scale_keeps_the_logits(rng, s):
    """The rewrite the card path applies before its kernel (which needs a
    scale > 0): the plain version gives the same output on it, k and v are
    untouched, and the input is not modified."""
    b, t, h = 2, 150, 2
    qkv = _t(rng.standard_normal((b, t, 3 * h * D)).astype(np.float32))
    before = qkv.clone()
    rewritten, scale = positive_scale(qkv, s)
    assert scale > 0
    assert torch.equal(qkv, before)
    assert torch.equal(rewritten[..., h * D:], qkv[..., h * D:])
    if s > 0:
        assert rewritten is qkv and scale == s
    np.testing.assert_allclose(packed_attention_plain(rewritten, h, q_scale=scale).numpy(),
                               packed_attention_plain(qkv, h, q_scale=s).numpy(),
                               atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("with_kn", [True, False])
def test_flash_plain_matches_pallas(rng, with_kn):
    """Global blocks: true_t with the producer's zero-pad rows on the TPU
    kernel's lattice, and the producer's per-head kn."""
    b, t, h = 1, 300, 2
    lattice = flash_packed_lattice(t, 128, 128)
    qkv = rng.standard_normal((b, t, 3 * h * D)).astype(np.float32)
    cos, sin = _tables(b, t, True)
    norm = {k: _t(v) for k, v in _norm_params(rng).items()}
    packed, kn = qkv_rope_producer_plain(
        _t(qkv), _t(cos), _t(sin), h, lattice, return_k_norms=True, **norm
    )
    kw = {"kn": jnp.asarray(kn.numpy())} if with_kn else {}
    want = flash_attention_packed_tpu(
        jnp.asarray(packed.numpy()), h, blk_q=128, blk_k=128, true_t=t, interpret=True, **kw
    )
    got = flash_attention_packed(packed, h, true_t=t, kn=kn if with_kn else None)
    assert got.shape == (b, t, h * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)
    # the unpadded input gives the same attention (keys >= true_t are masked)
    np.testing.assert_allclose(
        flash_attention_packed(packed[:, :t].contiguous(), h).numpy(), got.numpy(), atol=1e-6
    )


def test_plain_attention_query_blocks_agree(rng):
    """Query blocking (needed at T = 64,300) does not change the result."""
    packed = _packed_input(rng, 1, 300, 2, 300)
    whole = packed_attention_plain(packed, 2, q_block=1024)
    blocked = packed_attention_plain(packed, 2, q_block=64)
    np.testing.assert_allclose(blocked.numpy(), whole.numpy(), atol=1e-6)


@pytest.mark.parametrize("with_ls", [True, False])
def test_block_mlp_plain_matches_pallas(rng, with_ls):
    c, hidden, t = 256, 1024, 317
    x = rng.standard_normal((3, t, c)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w1 = (0.05 * rng.standard_normal((c, hidden))).astype(np.float32)  # JAX (in, out)
    b1 = (0.1 * rng.standard_normal(hidden)).astype(np.float32)
    w2 = (0.05 * rng.standard_normal((hidden, c))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ls = (0.9 + 0.1 * rng.standard_normal(c)).astype(np.float32) if with_ls else None
    want = block_mlp_fused_tpu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(w2), jnp.asarray(b2), ls=None if ls is None else jnp.asarray(ls), eps=1e-6,
        blk_rows=128, interpret=True,
    )
    got = block_mlp(
        _t(x), _t(scale), _t(bias), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()), _t(b2),
        ls=None if ls is None else _t(ls), eps=1e-6,
    )
    # the TPU kernel evaluates erf with XLA's fp32 polynomial, torch exactly
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_path_without_counting(rng):
    """Dispatch is by device only: CPU tensors never count a launch."""
    before = launch_counts()
    packed = _packed_input(rng, 1, 64, 2, 64)
    attention_single_pass_packed(packed, 2)
    flash_attention_packed(packed, 2)
    x = torch.from_numpy(rng.standard_normal((1, 8, 128)).astype(np.float32))
    w = torch.zeros(512, 128)
    block_mlp(x, torch.ones(128), torch.zeros(128), w, torch.zeros(512), w.T, torch.zeros(128))
    assert launch_counts() == before


def _attention_bf16_p(qkv, h, q_scale=1.0):
    """The hand-written attention kernel's arithmetic on the CPU: fp32 logits
    and softmax sums, P rounded to bf16 for the PV product, bf16 output."""
    b, t, _ = qkv.shape
    x = qkv.float().view(b, t, 3, h, D)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    s = (q @ k.transpose(-1, -2)) * q_scale
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = (p.to(torch.bfloat16).float() @ v) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).reshape(b, t, h * D).to(torch.bfloat16)


def _block_mlp_fp32_hidden(x, nw, nb, w1, b1, w2, b2, ls):
    """The hand-written block MLP's arithmetic on the CPU: fp32 products of
    bf16 operands, GELU output rounded to bf16 (the stored hidden), fp32
    bias, LayerScale and residual, bf16 output."""
    xn = torch.nn.functional.layer_norm(x.float(), x.shape[-1:], nw, nb, 1e-6).to(torch.bfloat16)
    h = torch.nn.functional.gelu(xn.float() @ w1.float().T + b1.float()).to(torch.bfloat16)
    return (x.float() + (h.float() @ w2.float().T + b2.float()) * ls).to(torch.bfloat16)


@pytest.mark.parametrize("case", ["producer", "attention", "attention_q_scale", "block_mlp"])
def test_chip_bounds_pass_kernel_arithmetic_and_reject_wrong_outputs(rng, case):
    """The bounds chip_smoke.py and the GPU tests hold the kernels to accept
    the kernels' bf16 arithmetic (simulated here) and fail an all-zero
    output and one 10% off."""
    bf16 = torch.bfloat16
    base = None
    if case == "producer":
        packed = _packed_input(rng, 2, 300, 4, 300)
        got, ref, bounds = packed.to(bf16)[..., 256:512], packed[..., 256:512], PRODUCER  # k
    elif case.startswith("attention"):
        if case == "attention":
            qkv, q_scale = _packed_input(rng, 2, 300, 4, 300).to(bf16), 1.0
        else:
            qkv = torch.from_numpy(rng.standard_normal((2, 300, 3 * 4 * D)).astype(np.float32))
            qkv, q_scale = qkv.to(bf16), D**-0.5 * np.log2(np.e)
        got = _attention_bf16_p(qkv, 4, q_scale)
        ref, bounds = packed_attention_plain(qkv, 4, q_scale=q_scale), ATTENTION
    else:
        c, hidden = 256, 1024

        def randn(*shape, scale=1.0):
            return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

        base = randn(1, 500, c).to(bf16)
        args = (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(hidden, c, scale=0.05).to(bf16),
                randn(hidden, scale=0.1).to(bf16), randn(c, hidden, scale=0.05).to(bf16),
                randn(c, scale=0.1).to(bf16))
        ls = 1 + randn(c, scale=0.1)
        got = _block_mlp_fp32_hidden(base, *args, ls)
        ref = block_mlp_plain(base, *args, ls=ls)
        bounds = block_mlp_bounds(base, ref)
    c = compare(got, ref, **bounds)
    assert c.ok and c.rejects_wrong, c
    zero = torch.zeros_like(ref) if base is None else base
    off = 1.1 * ref.float() if base is None else base.float() + 1.1 * (ref.float() - base.float())
    assert not compare(zero, ref, **bounds).ok
    assert not compare(off, ref, **bounds).ok


def test_input_scaled_bound_is_flagged():
    """A bound that exceeds the output's own size passes zeros: compare says
    so rather than passing quietly."""
    ref = torch.full((4, 64), 0.01)
    c = compare(torch.zeros_like(ref), ref, max_rel=0.0, atol=0.09, l2_rel=1.0)
    assert c.ok and not c.rejects_wrong
    assert not compare(torch.full_like(ref, float("nan")), ref, max_rel=1.0, l2_rel=1.0).ok

