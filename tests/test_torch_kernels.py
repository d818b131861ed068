"""The port's four on-path kernels (pi3_slam_tpu_torch/ops) against the JAX
package's Pallas TPU kernels run in interpret mode on the CPU.

On the CPU every wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions (what the hand-written Hopper kernels are
compared with on the card) to the TPU kernels' contracts: same inputs, made
with numpy from a seed, through both. Shapes are small but keep D = 64 and
an even H, the TPU kernels' contract. Tolerances are fp32 ones: both sides
compute in fp32 and differ only in summation order.

The fp32 entries (an fp32 model's activations: ``--compute-dtype float32``,
MoGe-2's encoder) are held to the same plain versions on the card with the
bounds of ``ops.compare.FP32`` (relative L2 1e-5, max |err| 1e-4 of the
output's size). Here the plain versions meet those bounds against the Pallas
functions with fp32 inputs (rows 1-5 and 8), and the bounds pass the fp32
kernels' 3xTF32 arithmetic (simulated) and reject the bf16 entries'.

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
    flash_attention_partial_tpu,
    flash_packed_lattice,
)
from pi3_slam_tpu.ops.pallas_mlp import block_mlp_fused_tpu, mlp_fused_tpu
from pi3_slam_tpu.ops.pallas_producer import qkv_rope_producer_tpu
from pi3_slam_tpu.ops.rope import make_patch_positions as jax_positions
from pi3_slam_tpu.ops.rope import rope_tables as jax_rope_tables

from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops._build import is_fp32
from pi3_slam_tpu_torch.ops.attention_f32 import DV, _operands, kernel_for, slices
from pi3_slam_tpu_torch.ops.block_mlp import block_mlp, block_mlp_plain
from pi3_slam_tpu_torch.ops.flash_attention import blockwise_attention
from pi3_slam_tpu_torch.ops.compare import ATTENTION, FP32, PRODUCER, block_mlp_bounds, compare
from pi3_slam_tpu_torch.ops.mlp import mlp, mlp_plain
from pi3_slam_tpu_torch.ops.partial_attention import flash_attention_partial
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


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
    cvt.rna.tf32.f32)."""
    return ((x.float().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x's fp32 pattern as the tensor cores read it as TF32: the low 13 bits
    dropped (the GEMM's big part: the raw tile)."""
    return (x.float().view(torch.int32) & -0x2000).view(torch.float32)


# k8 steps the fp32 GEMM sums in one wgmma accumulator (csrc/gemm_f32.cuh
# kF32GroupK8); the same for the fp32 attention loop
# (csrc/bthd_attention_f32.cuh kF32AttnGroupK8), and that loop's key tile at
# head dim 64 and in its sliced variant above (kF32WideNK)
GEMM_GROUP_K8 = 4
ATTN_GROUP_K8, ATTN_KEY_TILE, WIDE_KEY_TILE = 4, 64, 96


def _grouped_3xtf32(a, bt, group_k8, init=None):
    """a @ bt^T (contracting the last dim of both) as the TMA + wgmma tf32
    loops compute it: big = the raw fp32 pattern read as TF32 (truncated),
    small = the rest rounded to TF32 (to nearest, ties away); per group of
    group_k8 k8 steps the three products small.big' + big.small' + big.big'
    exact (here in fp64) and rounded to fp32, the groups added in order to
    an fp32 sum that starts at init (zero if None)."""
    ab, bb = _tf32_truncated(a), _tf32_truncated(bt)
    asm, bsm = _tf32(a.float() - ab), _tf32(bt.float() - bb)
    d = torch.float64
    depth = 8 * group_k8
    out = init
    for k0 in range(0, a.shape[-1], depth):
        ks = slice(k0, k0 + depth)
        part = (asm[..., ks].to(d) @ bb[..., ks].to(d).transpose(-1, -2)
                + ab[..., ks].to(d) @ bsm[..., ks].to(d).transpose(-1, -2)
                + ab[..., ks].to(d) @ bb[..., ks].to(d).transpose(-1, -2)).float()
        out = part if out is None else out + part
    return out


def _gemm_3xtf32(a, w):
    """a @ w^T as the fp32 GEMM computes it (:func:`_grouped_3xtf32` in
    groups of GEMM_GROUP_K8 k8 steps)."""
    return _grouped_3xtf32(a, w, GEMM_GROUP_K8)


def _loop_attention_3xtf32(q, k, v, scale, key_tile=ATTN_KEY_TILE):
    """The fp32 attention loop (csrc/bthd_attention_f32.cuh) on (B, H, T, D)
    q / k / v: per tile of key_tile keys (ATTN_KEY_TILE at head dim 64,
    WIDE_KEY_TILE in the sliced variant), S = q.k^T over all of D in the
    loop's grouped 3xTF32 (:func:`_grouped_3xtf32`: groups of ATTN_GROUP_K8
    k8 steps, one 32-column box of D, added in fp32), scaled; the base-2
    online softmax in fp32 with an exact running max; O_tile = P V the same
    way (P's big part its raw fp32 pattern; a group is 32 keys), each group
    added in fp32 to O rescaled; O / l at the end. A column slice of O
    computes its columns exactly so, so the slices are not modelled."""
    m = torch.full((*q.shape[:-1], 1), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros((*q.shape[:-1], v.shape[-1]))
    for k0 in range(0, k.shape[-2], key_tile):
        keys = slice(k0, k0 + key_tile)
        s = _grouped_3xtf32(q, k[..., keys, :], ATTN_GROUP_K8) * np.float32(scale)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        a, p = torch.exp2(m - mx), torch.exp2(s - mx)
        l = l * a + p.sum(-1, keepdim=True)
        o = _grouped_3xtf32(p, v[..., keys, :].transpose(-1, -2), ATTN_GROUP_K8, init=o * a)
        m = mx
    return o / l


def _attention_3xtf32(qkv, h, q_scale=1.0):
    """The fp32 packed attention's arithmetic on the CPU (head dim 64: the
    TMA + wgmma loop, :func:`_loop_attention_3xtf32`) at logit scale
    q_scale (base 2)."""
    b, t, _ = qkv.shape
    x = qkv.view(b, t, 3, h, D)
    q, k, v = (x[:, :, i].transpose(1, 2) for i in range(3))
    o = _loop_attention_3xtf32(q, k, v, q_scale)
    return o.transpose(1, 2).reshape(b, t, h * D)


def _bthd_attention_3xtf32(q, k, v):
    """The fp32 (B, T, H, D) attention's arithmetic, softmax(q.k^T /
    sqrt(D)) v: the TMA + wgmma loop's (:func:`_loop_attention_3xtf32`),
    in 64-key tiles at head dim 64 and the sliced variant's 96-key tiles
    above."""
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    scale = q.shape[-1]**-0.5 * np.log2(np.e)
    tile = ATTN_KEY_TILE if q.shape[-1] == D else WIDE_KEY_TILE
    return _loop_attention_3xtf32(q, k, v, scale, tile).transpose(1, 2)


def _block_mlp_3xtf32(x, nw, nb, w1, b1, w2, b2, ls):
    """The fp32 block MLP's arithmetic: fp32 LayerNorm, the GEMM's 3xTF32
    products, fp32 GELU (the hidden kept in fp32), bias, LayerScale and
    residual."""
    xn = torch.nn.functional.layer_norm(x, x.shape[-1:], nw, nb, 1e-6)
    h = torch.nn.functional.gelu(_gemm_3xtf32(xn, w1) + b1)
    return x + (_gemm_3xtf32(h, w2) + b2) * ls


def _mlp_3xtf32(x, w1, b1, w2, b2):
    """The fp32 MLP's arithmetic: the GEMM's 3xTF32 products, fp32 GELU and
    bias."""
    return _gemm_3xtf32(torch.nn.functional.gelu(_gemm_3xtf32(x, w1) + b1), w2) + b2


@pytest.mark.parametrize("case", ["producer", "attention", "attention_q_scale", "block_mlp",
                                  "producer_fp32", "attention_fp32", "attention_q_scale_fp32",
                                  "block_mlp_fp32", "block_mlp_k4096_fp32", "mlp_k4096_fp32",
                                  "attention_d320_fp32", "attention_d512_fp32",
                                  "attention_d64_fp32", "attention_d128_fp32",
                                  "attention_d256_fp32"])
def test_chip_bounds_pass_kernel_arithmetic_and_reject_wrong_outputs(rng, case):
    """The bounds chip_smoke.py and the GPU tests hold the kernels to accept
    the kernels' bf16 arithmetic (simulated here) and fail an all-zero
    output and one 10% off. The fp32 entries' bounds accept their 3xTF32
    arithmetic (simulated) and also reject the bf16 entry's output on the
    same inputs."""
    if case.endswith("_fp32"):
        return _check_fp32_bounds(rng, case[:-5])
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


def _mlp_args(rng, c, hidden):
    def randn(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    return (1 + randn(c, scale=0.1), randn(c, scale=0.1), randn(hidden, c, scale=0.05),
            randn(hidden, scale=0.1), randn(c, hidden, scale=0.05), randn(c, scale=0.1),
            1 + randn(c, scale=0.1))


def _check_fp32_bounds(rng, case):
    bf16 = torch.bfloat16
    base = None
    if case == "producer":
        qkv = torch.from_numpy(rng.standard_normal((2, 300, 3 * 4 * D)).astype(np.float32))
        cos, sin = (_t(a) for a in _tables(2, 300, True))
        norm = {k: _t(v) for k, v in _norm_params(rng).items()}
        ref = qkv_rope_producer_plain(qkv, cos, sin, 4, 300, **norm)[..., :256]  # q
        # the same fp32 operations in another order: within an fp32 rounding
        got = qkv_rope_producer_plain(qkv.double(), cos.double(), sin.double(), 4, 300,
                                      **{k: v.double() for k, v in norm.items()})[..., :256].float()
        bf = qkv_rope_producer_plain(qkv.to(bf16), cos, sin, 4, 300, **norm)[..., :256]
        bounds = FP32
    elif case in ("attention_d64", "attention_d128", "attention_d256", "attention_d320",
                  "attention_d512"):
        # the TMA + wgmma loop (D 64, keys past a 64-key tile), its sliced
        # variant (keys past a 96-key tile; one slice of O at 128, two at
        # 256, three at 320, the last half past D, four at 512)
        d = int(case.split("_d")[1])
        q, k, v = (torch.from_numpy(rng.standard_normal((1, 150, 2, d)).astype(np.float32))
                   for _ in range(3))
        got, bounds = _bthd_attention_3xtf32(q, k, v), FP32
        ref = blockwise_attention(q, k, v)
        bf = blockwise_attention(q.to(bf16), k.to(bf16), v.to(bf16))
    elif case.startswith("attention"):
        if case == "attention":
            qkv, q_scale = _packed_input(rng, 2, 300, 4, 300), 1.0
        else:
            qkv = torch.from_numpy(rng.standard_normal((2, 300, 3 * 4 * D)).astype(np.float32))
            q_scale = D**-0.5 * np.log2(np.e)
        got, bounds = _attention_3xtf32(qkv, 4, q_scale), FP32
        ref = packed_attention_plain(qkv, 4, q_scale=q_scale)
        bf = _attention_bf16_p(qkv.to(bf16), 4, q_scale)
    elif case == "mlp_k4096":  # fc2 at the global shape's depth
        x = torch.from_numpy(rng.standard_normal((1, 64, 128)).astype(np.float32))
        _, _, w1, b1, w2, b2, _ = _mlp_args(rng, 128, 4096)
        got, ref, bounds = _mlp_3xtf32(x, w1, b1, w2, b2), mlp_plain(x, w1, b1, w2, b2), FP32
        bf = mlp_plain(x.to(bf16), w1.to(bf16), b1.to(bf16), w2.to(bf16), b2.to(bf16))
    else:
        c, hidden = (128, 4096) if case == "block_mlp_k4096" else (256, 1024)
        base = torch.from_numpy(rng.standard_normal((1, 500 if hidden == 1024 else 64, c))
                                .astype(np.float32))
        nw, nb, w1, b1, w2, b2, ls = _mlp_args(rng, c, hidden)
        got = _block_mlp_3xtf32(base, nw, nb, w1, b1, w2, b2, ls)
        ref = block_mlp_plain(base, nw, nb, w1, b1, w2, b2, ls=ls)
        bf = _block_mlp_fp32_hidden(base.to(bf16), nw, nb, w1.to(bf16), b1.to(bf16),
                                    w2.to(bf16), b2.to(bf16), ls)
        bounds = block_mlp_bounds(base, ref)
    assert got.dtype == ref.dtype == torch.float32
    c = compare(got, ref, **bounds)
    assert c.ok and c.rejects_wrong, c
    assert not compare(bf.float(), ref, **bounds).ok  # the bf16 entry's output is rejected
    zero = torch.zeros_like(ref) if base is None else base
    off = 1.1 * ref if base is None else base + 1.1 * (ref - base)
    assert not compare(zero, ref, **bounds).ok
    assert not compare(off, ref, **bounds).ok


@pytest.mark.parametrize("row", ["producer", "single_pass", "single_pass_q_scale", "flash",
                                 "partial", "block_mlp", "mlp"])
def test_fp32_plain_matches_pallas(rng, row):
    """Rows 1-5 and 8 with fp32 inputs: the Pallas function in interpret mode
    against the port's wrapper on the CPU (the plain version the fp32 entry
    is held to on the card), fp32 out, within ops.compare.FP32 (relative L2
    1e-5, max |err| 1e-4 of the output's size): fp32 on both sides in
    another summation order."""
    j = jnp.asarray
    h, t = 2, 300
    if row == "producer":
        qkv = rng.standard_normal((2, t, 3 * h * D)).astype(np.float32)
        cos, sin = _tables(2, t, True)
        norm = _norm_params(rng)
        want = qkv_rope_producer_tpu(j(qkv), j(cos), j(sin), h, t, eps=1e-5, interpret=True,
                                     **{k: j(v) for k, v in norm.items()})
        got = qkv_rope_producer(_t(qkv), _t(cos), _t(sin), h, t, eps=1e-5,
                                **{k: _t(v) for k, v in norm.items()})
        pairs = [(got[..., i * h * D:(i + 1) * h * D], np.asarray(want)[..., i * h * D:(i + 1) * h * D])
                 for i in range(3)]
    elif row in ("single_pass", "flash"):
        packed = _packed_input(rng, 1, t, h, t)
        fn = attention_single_pass_packed_tpu if row == "single_pass" else flash_attention_packed_tpu
        kw = {} if row == "single_pass" else dict(blk_q=128, blk_k=128)
        want = fn(j(packed.numpy()), h, interpret=True, **kw)
        entry = attention_single_pass_packed if row == "single_pass" else flash_attention_packed
        pairs = [(entry(packed, h), np.asarray(want))]
    elif row == "single_pass_q_scale":
        qkv = rng.standard_normal((2, 270, 3 * h * D)).astype(np.float32)
        s = D**-0.5 * np.log2(np.e)
        want = attention_single_pass_packed_tpu(j(qkv), h, q_scale=s, interpret=True)
        pairs = [(attention_single_pass_packed(_t(qkv), h, q_scale=s), np.asarray(want))]
    elif row == "partial":
        q, k, v = (rng.standard_normal((1, t, h, D)).astype(np.float32) for _ in range(3))
        kn = np.sqrt((k**2).sum(-1).max(axis=1)).astype(np.float32)
        want = flash_attention_partial_tpu(j(q), j(k), j(v), j(kn), blk_q=128, blk_k=128,
                                           n_interleave=1, interpret=True)
        got = flash_attention_partial(_t(q), _t(k), _t(v), _t(kn))
        pairs = list(zip(got, (np.asarray(w) for w in want)))
        pairs[1] = (pairs[1][0], pairs[1][1].reshape(pairs[1][0].shape))
    else:
        c, hidden = 256, 1024
        x = rng.standard_normal((2, 150, c)).astype(np.float32)
        nw, nb, w1, b1, w2, b2, ls = (a.numpy() for a in _mlp_args(rng, c, hidden))
        if row == "mlp":
            want = mlp_fused_tpu(j(x), j(w1.T), j(b1), j(w2.T), j(b2), blk_rows=128,
                                 interpret=True)
            got = mlp(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
            pairs = [(got, np.asarray(want))]
        else:
            want = block_mlp_fused_tpu(j(x), j(nw), j(nb), j(w1.T), j(b1), j(w2.T), j(b2),
                                       ls=j(ls), eps=1e-6, blk_rows=128, interpret=True)
            got = block_mlp(_t(x), _t(nw), _t(nb), _t(w1), _t(b1), _t(w2), _t(b2), ls=_t(ls),
                            eps=1e-6)
            pairs = [(got - _t(x), np.asarray(want) - x)]  # the branch, as block_mlp_bounds
    for got, want in pairs:
        assert got.dtype == torch.float32
        c = compare(got, torch.from_numpy(np.array(want)), **FP32)
        assert c.ok and c.rejects_wrong, (row, c)


def test_fp32_operands_take_the_fp32_entries_and_fp16_is_refused():
    """The checks the wrappers run on CUDA operands before a launch, here on
    CPU tensors: bf16 takes the bf16 entry, fp32 the fp32 one, fp16 (no
    entry) is refused; the fp32 attention kernel takes strided q / k / v
    views of the packed projection, head dims above 256 too (its sliced
    variant), and refuses rows that are not 16-byte aligned."""
    assert is_fp32(torch.zeros(4), "x") and not is_fp32(torch.zeros(4, dtype=torch.bfloat16), "x")
    with pytest.raises(TypeError):
        is_fp32(torch.zeros(4, dtype=torch.float16), "x")
    qkv = torch.zeros(2, 70, 3 * 2 * D)
    q, k, v = qkv.view(2, 70, 3, 2, D).unbind(2)
    assert _operands(q, k, v, "attention") == [70 * 3 * 2 * D, 3 * 2 * D, D] * 3
    with pytest.raises(TypeError):
        _operands(q, k.to(torch.bfloat16), v, "attention")
    wide = torch.zeros(1, 9, 1, 320)
    assert _operands(wide, wide, wide, "attention") == [9 * 320, 320, 320] * 3
    odd = torch.zeros(1, 9, 2, 66)[..., :64]  # row stride 66 floats: 8-byte aligned rows
    with pytest.raises(ValueError):
        _operands(odd, odd, odd, "attention")


# the kernel each fp32 head dim runs (csrc/attention_f32.cu's pi3_attention_f32):
# D 64 the TMA + wgmma loop of csrc/bthd_attention_f32.cuh, every wider one
# its sliced variant
FP32_KERNEL_BY_D = {64: "attention_f32_tma_kernel"}


@pytest.mark.parametrize("d,width", [(64, 64), (128, 128), (192, 128), (256, 128), (320, 128),
                                     (384, 128), (448, 128), (512, 128), (1152, 128),
                                     (0, None), (96, None), (-64, None)])
def test_fp32_attention_takes_every_multiple_of_64(d, width):
    """The fp32 attention's head-dim check and routing: every positive
    multiple of 64 is taken, D 64 by the TMA + wgmma loop (O of the whole
    head a block), wider ones by its sliced variant in slices of width DV
    (csrc/bthd_attention_f32.cuh kF32WideDV), the last one's columns past D
    unused; others are refused before any launch."""
    if width is None:
        with pytest.raises(ValueError, match="multiples of 64"):
            slices(d)
        with pytest.raises(ValueError, match="multiples of 64"):
            kernel_for(d)
        t = torch.zeros(1, 9, 1, max(d, 1))
        with pytest.raises(ValueError):
            _operands(t, t, t, "attention")
        return
    assert kernel_for(d) == FP32_KERNEL_BY_D.get(d, "attention_f32_wide_tma_kernel")
    n = slices(d)
    assert (n - 1) * width < d <= n * width
    assert width == (d if d == D else DV)


def _vt_column(key):
    """csrc/bthd_attention_f32.cuh's vt_column: V^T's column of a key."""
    return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2)


def test_transposed_v_takes_p_in_the_a_register_order(rng):
    """The fp32 loop's V^T (csrc/bthd_attention_f32.cuh, written by the split
    warps): column 8j + t holds key 8j + 2t and column 8j + t + 4 key 8j +
    2t + 1, so P fed to wgmma straight from the S accumulators (thread (g,
    t) holds keys 8j + 2t and 8j + 2t + 1 of rows g and g + 8, given as the
    tf32 A registers a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g +
    8, t + 4) of k8 step j) times that V^T is P V; each 64-row box of V^T is
    written once per element, 16-byte chunk c of row d at chunk c ^ (d % 8)
    (the 128-byte swizzle the descriptor reads), as is the sliced variant's
    V^T of 128 D-rows a stage."""
    n, d = 64, 64
    v = rng.standard_normal((n, d))
    p = rng.standard_normal((16, n))  # a warp's 16 rows of P
    vt = np.empty((d, n))
    for key in range(n):
        vt[:, _vt_column(key)] = v[key]
    for j in range(n // 8):
        for t in range(4):
            assert np.array_equal(vt[:, 8 * j + t], v[8 * j + 2 * t])
            assert np.array_equal(vt[:, 8 * j + t + 4], v[8 * j + 2 * t + 1])
    a = np.zeros((16, n))  # the A operand as the tensor cores read it: a[row, 8j + k]
    for j in range(n // 8):
        for g in range(8):
            for t in range(4):
                acc = (p[g, 8 * j + 2 * t], p[g, 8 * j + 2 * t + 1],
                       p[g + 8, 8 * j + 2 * t], p[g + 8, 8 * j + 2 * t + 1])  # entries 4j ..
                a0, a1, a2, a3 = acc[0], acc[2], acc[1], acc[3]  # the kernel's register order
                a[g, 8 * j + t], a[g + 8, 8 * j + t] = a0, a1
                a[g, 8 * j + t + 4], a[g + 8, 8 * j + t + 4] = a2, a3
    np.testing.assert_allclose(a @ vt.T, p @ v, rtol=1e-12, atol=1e-12)
    # the split warps' offsets (float index in a box of 32 columns: 64 rows
    # at head dim 64, the sliced variant's 128 D-rows of a 32-key V stage)
    for rows in (d, 2 * d):
        offsets = {(dd * 32 + ((((col >> 2) ^ (dd & 7)) << 2) | (col & 3)))
                   for dd in range(rows) for col in (_vt_column(key) & 31 for key in range(32))}
        assert offsets == set(range(rows * 32))


def test_input_scaled_bound_is_flagged():
    """A bound that exceeds the output's own size passes zeros: compare says
    so rather than passing quietly."""
    ref = torch.full((4, 64), 0.01)
    c = compare(torch.zeros_like(ref), ref, max_rel=0.0, atol=0.09, l2_rel=1.0)
    assert c.ok and not c.rejects_wrong
    assert not compare(torch.full_like(ref, float("nan")), ref, max_rel=1.0, l2_rel=1.0).ok

