"""The port's hand-written kernels against their plain PyTorch versions on an
NVIDIA GPU, in bf16, at small ragged shapes (chip_smoke.py covers the main
path's shapes). Every test here carries the ``cuda`` marker and skips where
there is no GPU. The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: the bounds of ``pi3_slam_tpu_torch.ops.compare`` (max |err| and
relative L2 error, both scaled by the reference, each of which rejects an
all-zero and a 10%-off output; the reasons are given there), the same ones
chip_smoke.py holds the kernels to at the main path's shapes.
"""

import pytest
import torch

from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops.block_mlp import block_mlp, block_mlp_plain
from pi3_slam_tpu_torch.ops.compare import ATTENTION, PRODUCER, block_mlp_bounds, compare
from pi3_slam_tpu_torch.ops.packed_attention import (
    attention_single_pass_packed,
    flash_attention_packed,
    packed_attention_plain,
)
from pi3_slam_tpu_torch.ops.qkv_producer import qkv_rope_producer, qkv_rope_producer_plain
from pi3_slam_tpu_torch.ops.rope import make_patch_positions, rope_tables

D = 64


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the hand-written kernels run only there)")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _assert_close(got, ref, **bounds):
    c = compare(got, ref, **bounds)
    assert c.rejects_wrong, c
    assert c.ok, c


def _packed(gen, b, t, h):
    """Producer output at ragged T: qk-norm + RoPE at real patch positions."""
    qkv = _randn(gen, b, t, 3 * h * D)
    pos = make_patch_positions(b, 1, t - 5, num_special=5, offset=1, device="cuda")
    cos, sin = rope_tables(pos, D)
    norm = dict(
        q_norm_scale=1 + 0.1 * torch.randn(D, generator=gen, device="cuda"),
        q_norm_bias=0.1 * torch.randn(D, generator=gen, device="cuda"),
        k_norm_scale=1 + 0.1 * torch.randn(D, generator=gen, device="cuda"),
        k_norm_bias=0.1 * torch.randn(D, generator=gen, device="cuda"),
    )
    return qkv, cos, sin, norm


@pytest.mark.cuda
@pytest.mark.parametrize("with_norm", [True, False])
@pytest.mark.parametrize("out_t", [None, 384])
def test_producer_matches_plain(gen, with_norm, out_t):
    b, t, h = 3, 301, 4
    qkv, cos, sin, norm = _packed(gen, b, t, h)
    kw = norm if with_norm else {}
    out_t = out_t or t
    got, kn = qkv_rope_producer(qkv, cos, sin, h, out_t, return_k_norms=True, **kw)
    ref, kn_ref = qkv_rope_producer_plain(qkv, cos, sin, h, out_t, return_k_norms=True, **kw)
    assert got.shape == (b, out_t, 3 * h * D)
    c = h * D
    for i in range(3):  # q, k, v
        _assert_close(got[:, :t, i * c:(i + 1) * c], ref[:, :t, i * c:(i + 1) * c],
                      **PRODUCER)
    assert not got[:, t:].any()
    _assert_close(kn, kn_ref, max_rel=1e-5, l2_rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("t,true_t", [(301, None), (384, 301), (70, 1)])
def test_attention_matches_plain(gen, t, true_t):
    b, h = 2, 4
    qkv, cos, sin, norm = _packed(gen, b, t, h)
    packed = qkv_rope_producer_plain(qkv, cos, sin, h, t, **norm)
    ref = packed_attention_plain(packed, h, true_t=true_t)
    _assert_close(flash_attention_packed(packed, h, true_t=true_t), ref, **ATTENTION)
    _assert_close(attention_single_pass_packed(packed, h, true_t=true_t), ref, **ATTENTION)
    s = D**-0.5 * 1.4426950408889634  # encoder blocks: raw q, scale on the logits
    ref = packed_attention_plain(qkv, h, true_t=true_t, q_scale=s)
    got = attention_single_pass_packed(qkv, h, true_t=true_t, q_scale=s)
    _assert_close(got, ref, **ATTENTION)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ls", [True, False])
def test_block_mlp_matches_plain(gen, with_ls):
    c, hidden, rows = 256, 1024, 333  # rows not a multiple of the 128-row tile
    x = _randn(gen, 1, rows, c)
    args = (
        x,
        1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
        0.1 * torch.randn(c, generator=gen, device="cuda"),
        _randn(gen, hidden, c, scale=0.05),
        _randn(gen, hidden, scale=0.1),
        _randn(gen, c, hidden, scale=0.05),
        _randn(gen, c, scale=0.1),
    )
    ls = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda") if with_ls else None
    ref = block_mlp_plain(*args, ls=ls)
    _assert_close(block_mlp(*args, ls=ls), ref, **block_mlp_bounds(x, ref))


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_fp32(gen):
    qkv, cos, sin, norm = _packed(gen, 1, 70, 2)
    before = launch_counts()
    packed = qkv_rope_producer(qkv, cos, sin, 2, 70, **norm)
    flash_attention_packed(packed, 2)
    attention_single_pass_packed(packed, 2)
    after = launch_counts()
    assert after["qkv_rope_producer"] == before["qkv_rope_producer"] + 1
    assert after["flash_attention_packed"] == before["flash_attention_packed"] + 1
    assert after["attention_single_pass_packed"] == before["attention_single_pass_packed"] + 1
    with pytest.raises(TypeError):
        attention_single_pass_packed(packed.float(), 2)
    with pytest.raises(TypeError):
        qkv_rope_producer(qkv.float(), cos, sin, 2, 70)
