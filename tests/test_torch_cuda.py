"""The port's hand-written kernels against their plain PyTorch versions on an
NVIDIA GPU, in bf16 and (their fp32 entries) in fp32, at small ragged shapes
(chip_smoke.py covers the main path's shapes). Every test here carries the ``cuda`` marker and skips where
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
from pi3_slam_tpu_torch.ops.compare import (
    ATTENTION,
    DOTS,
    FP32,
    MLP,
    PARTIAL_L,
    PRODUCER,
    block_mlp_bounds,
    compare,
)
from pi3_slam_tpu_torch.ops.dots_attention import dots_attention, dots_attention_plain
from pi3_slam_tpu_torch.ops.attention import sdpa
from pi3_slam_tpu_torch.ops.flash_attention import (
    attention_single_pass,
    blockwise_attention,
    flash_attention,
)
from pi3_slam_tpu_torch.ops.mlp import mlp, mlp_plain
from pi3_slam_tpu_torch.ops.packed_attention import (
    attention_single_pass_packed,
    flash_attention_packed,
    packed_attention_plain,
)
from pi3_slam_tpu_torch.ops.partial_attention import (
    flash_attention_partial,
    partial_attention_plain,
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


def _producer_input(gen, b, t, h):
    """Raw qkv at head dim 64 and the RoPE tables of a (1, t) patch grid."""
    qkv = _randn(gen, b, t, 3 * h * D)
    cos, sin = rope_tables(make_patch_positions(b, 1, t, offset=1, device="cuda"), D)
    return qkv, cos, sin


def _producer_norm(gen):
    return dict(
        q_norm_scale=1 + 0.1 * torch.randn(D, generator=gen, device="cuda"),
        q_norm_bias=0.1 * torch.randn(D, generator=gen, device="cuda"),
        k_norm_scale=1 + 0.1 * torch.randn(D, generator=gen, device="cuda"),
        k_norm_bias=0.1 * torch.randn(D, generator=gen, device="cuda"),
    )


# (head dim, entry): the partial entry runs at head dim 64 only
FP32_LOOP_ENTRIES = [(64, "flash_attention_partial")] + [
    (d, entry) for d in (64, 128, 192, 256, 320, 512)
    for entry in ("flash_attention", "attention_single_pass")]


@pytest.mark.cuda
@pytest.mark.parametrize("d,entry", FP32_LOOP_ENTRIES)
@pytest.mark.parametrize("tq,tk", [(301, 1), (301, 150), (130, 333)])
def test_fp32_d64_loop_reads_no_row_past_the_lengths_and_repeats(gen, d, entry, tq, tk):
    """The fp32 loop (csrc/bthd_attention_f32.cuh) at head dim 64 and its
    sliced variant above, through the (B, T, H, D) and partial entries: q, k
    and v cut from buffers with NaN rows behind Tq and Tk (Tk 1, below and
    above Tq) give the bits of the same call on finite copies, and a second
    call repeats them (no split-K, no atomics)."""
    b, h, t = 2, 3, 400
    q, k, v = (_randn32(gen, b, t, h, d) for _ in range(3))
    if entry == "flash_attention_partial":
        kn = k[:, :tk].square().sum(-1).amax(1).sqrt()
        run = lambda *qkv: flash_attention_partial(*qkv, kn)
    else:
        run = flash_attention if entry == "flash_attention" else attention_single_pass
    before = launch_counts()[f"{entry}_fp32"]
    clean = run(q[:, :tq].clone(), k[:, :tk].clone(), v[:, :tk].clone())
    tails = (_nan_tail(q, tq), _nan_tail(k, tk), _nan_tail(v, tk))
    got, again = run(*tails), run(*tails)
    assert launch_counts()[f"{entry}_fp32"] == before + 3
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    for a, c, r in zip(as_tuple(got), as_tuple(clean), as_tuple(again)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert torch.equal(a, c), "a row past Tq or Tk was read"
        assert torch.equal(a, r), "a second call differs"


@pytest.mark.cuda
@pytest.mark.parametrize("q_scale", [1.0, 0.0, -0.3])
def test_fp32_packed_attention_repeats_bit_for_bit(gen, q_scale):
    """The packed single-pass entry on fp32 at MoGe-2's 6 heads, any logit
    scale (0 and negative too): NaN rows past true_t give the bits of the
    finite rows, a second call repeats them, and both are within FP32 of
    the plain version."""
    qkv = _randn32(gen, 2, 704, 3 * 6 * D)
    qkv[:, 643:] = float("nan")
    got = attention_single_pass_packed(qkv, 6, true_t=643, q_scale=q_scale)
    assert torch.equal(got, attention_single_pass_packed(qkv[:, :643].contiguous(), 6,
                                                         q_scale=q_scale))
    assert torch.equal(got, attention_single_pass_packed(qkv, 6, true_t=643, q_scale=q_scale))
    _assert_close(got, packed_attention_plain(qkv, 6, true_t=643, q_scale=q_scale), **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("with_norm", [True, False])
@pytest.mark.parametrize("pad", [0, 37])
@pytest.mark.parametrize("t", [1, 63, 643, 4100])
@pytest.mark.parametrize("h", [2, 5, 6, 16, 20])
def test_producer_heads_and_lengths_match_plain(gen, h, t, pad, with_norm):
    """H 5 and 6 mask the last 512-byte pass of a row, H 16 fills four, H 20
    adds a second grid row of heads, partly masked; T 1 is one row, 63 and
    643 ragged, 4100 many rows a warp; out_t = T + pad, rows past T zero."""
    b = 1 if t == 4100 else 2
    qkv, cos, sin = _producer_input(gen, b, t, h)
    kw = _producer_norm(gen) if with_norm else {}
    got, kn = qkv_rope_producer(qkv, cos, sin, h, t + pad, return_k_norms=True, **kw)
    ref, kn_ref = qkv_rope_producer_plain(qkv, cos, sin, h, t + pad, return_k_norms=True, **kw)
    c = h * D
    for i in range(3):  # q, k, v
        _assert_close(got[:, :t, i * c:(i + 1) * c], ref[:, :t, i * c:(i + 1) * c],
                      **PRODUCER)
    assert torch.equal(got[:, :t, 2 * c:], qkv[..., 2 * c:])  # v copied bit for bit
    assert not got[:, t:].any()
    _assert_close(kn, kn_ref, max_rel=1e-5, l2_rel=1e-5)


@pytest.mark.cuda
def test_producer_repeats_bit_for_bit(gen):
    """kn's atomic maxima do not depend on the order the warps reach them."""
    qkv, cos, sin = _producer_input(gen, 3, 643, 16)
    norm = _producer_norm(gen)
    first = qkv_rope_producer(qkv, cos, sin, 16, 643, return_k_norms=True, **norm)
    second = qkv_rope_producer(qkv, cos, sin, 16, 643, return_k_norms=True, **norm)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 21])
def test_producer_reads_no_row_past_t(gen, pad):
    """qkv cut from a longer buffer whose rows past T hold NaN: the output and
    kn equal those of a clean copy bit for bit, rows past T zero."""
    h, t = 6, 301
    buf = _randn(gen, 1, t + 64, 3 * h * D)
    clean = buf[:, :t].clone()
    buf[:, t:] = float("nan")
    qkv = buf[:, :t]
    assert qkv.is_contiguous()
    cos, sin = rope_tables(make_patch_positions(1, 1, t, offset=1, device="cuda"), D)
    norm = _producer_norm(gen)
    got = qkv_rope_producer(qkv, cos, sin, h, t + pad, return_k_norms=True, **norm)
    want = qkv_rope_producer(clean, cos, sin, h, t + pad, return_k_norms=True, **norm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[0][:, t:].any()


@pytest.mark.cuda
def test_producer_refuses_what_the_kernel_does_not_take(gen):
    qkv, cos, sin = _producer_input(gen, 1, 70, 2)
    before = launch_counts()
    with pytest.raises(TypeError):  # fp16 has no entry
        qkv_rope_producer(qkv.half(), cos, sin, 2, 70)
    wide = _randn(gen, 1, 70, 3 * 2 * 128)  # head dim 128
    cos128, sin128 = rope_tables(make_patch_positions(1, 1, 70, offset=1, device="cuda"), 128)
    with pytest.raises(ValueError):
        qkv_rope_producer(wide, cos128, sin128, 2, 70)
    strided = _randn(gen, 1, 70, 2 * 3 * 2 * D)[..., ::2]  # not contiguous
    with pytest.raises(ValueError):
        qkv_rope_producer(strided, cos, sin, 2, 70)
    assert launch_counts() == before
    qkv_rope_producer(qkv, cos, sin, 2, 70)
    assert launch_counts()["qkv_rope_producer"] == before["qkv_rope_producer"] + 1


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
@pytest.mark.parametrize(
    "b,t,true_t,h",
    [
        (2, 301, None, 4),
        (2, 384, 301, 4),
        (2, 70, 1, 4),
        (2, 643, None, 6),  # MoGe-2's C 384: 3C = 1152 columns; 643 = 5 x 128 + 3
        (1, 4100, None, 2),  # 33 key tiles: the ring of K / V stages wraps many times
        (2, 128, None, 4),  # exactly one 128-row tile
        (2, 129, None, 4),  # one key and one query over it
    ],
)
def test_attention_matches_plain(gen, b, t, true_t, h):
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
@pytest.mark.parametrize("entry", [flash_attention_packed, attention_single_pass_packed])
def test_attention_ignores_what_the_padding_rows_hold(gen, entry):
    """Rows >= true_t full of NaN: the kernel reads none of them (not even as
    keys whose weight is 0, where 0 x NaN would reach the output), so the
    output equals the unpadded input's exactly."""
    b, t, h, true_t = 2, 704, 6, 643
    qkv, cos, sin, norm = _packed(gen, b, true_t, h)
    packed = qkv_rope_producer_plain(qkv, cos, sin, h, true_t, **norm)
    padded = torch.full((b, t, 3 * h * D), float("nan"), device="cuda", dtype=torch.bfloat16)
    padded[:, :true_t] = packed
    got = entry(padded, h, true_t=true_t)
    assert torch.equal(got, entry(packed, h))
    _assert_close(got, packed_attention_plain(packed, h), **ATTENTION)


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
    """bf16 launches count on the bf16 entries; fp16, which has no entry, is
    refused (fp32 takes the fp32 entries since they exist:
    test_fp32_entries_count_launches_and_refuse_fp16)."""
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
        attention_single_pass_packed(packed.half(), 2)
    with pytest.raises(TypeError):
        qkv_rope_producer(qkv.half(), cos, sin, 2, 70)


@pytest.mark.cuda
@pytest.mark.parametrize("q_scale", [0.0, -0.3])
def test_single_pass_takes_any_logit_scale(gen, q_scale):
    """The JAX function takes any q_scale: 0 gives uniform weights, a
    negative one the softmax of negated logits. The kernel needs a scale > 0,
    so the wrapper hands it q zeroed or negated (one launch all the same)."""
    qkv = _randn(gen, 2, 301, 3 * 4 * D)
    before = launch_counts()["attention_single_pass_packed"]
    got = attention_single_pass_packed(qkv, 4, true_t=290, q_scale=q_scale)
    assert launch_counts()["attention_single_pass_packed"] == before + 1
    _assert_close(got, packed_attention_plain(qkv, 4, true_t=290, q_scale=q_scale), **ATTENTION)


def _qkv_views(gen, b, tq, tk, h):
    """q as a strided view of a packed projection (row stride 3*H*D), k and v
    contiguous (B, Tk, H, D) like the merged keys, kn their global max |k|."""
    q = _randn(gen, b, tq, 3, h, D)[:, :, 0]
    k = _randn(gen, b, tk, h, D)
    v = _randn(gen, b, tk, h, D)
    return q, k, v, k.float().square().sum(-1).amax(1).sqrt()


def _check_partial(got, ref):
    (acc, l), (acc_ref, l_ref) = got, ref
    _assert_close(acc, acc_ref, **ATTENTION)
    _assert_close(l, l_ref, **PARTIAL_L)
    _assert_close(acc / l[..., None], acc_ref / l_ref[..., None], **ATTENTION)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(301, 150), (64, 64), (130, 1)])
def test_partial_attention_matches_plain(gen, tq, tk):
    q, k, v, kn = _qkv_views(gen, 2, tq, tk, 4)
    assert not q.is_contiguous()
    _check_partial(flash_attention_partial(q, k, v, kn), partial_attention_plain(q, k, v, kn))


@pytest.mark.cuda
def test_partial_attention_shards_sum_to_one_shard(gen):
    """Partials over two key shards with the shared global kn sum to the
    one-shard result (the fixed shift's contract)."""
    q, k, v, kn = _qkv_views(gen, 1, 200, 300, 2)
    parts = [flash_attention_partial(q, k[:, s], v[:, s], kn)
             for s in (slice(0, 170), slice(170, 300))]
    summed = (parts[0][0] + parts[1][0], parts[0][1] + parts[1][1])
    _check_partial(summed, partial_attention_plain(q, k, v, kn))


@pytest.mark.cuda
def test_partial_attention_loose_bound_keeps_l_positive(gen):
    """A kn far above the keys' own max pushes the shift to its clamp at 120:
    every term is below 2^-100, and l stays > 0 where the plain version's is."""
    q, k, v, kn = _qkv_views(gen, 1, 100, 80, 2)
    acc, l = flash_attention_partial(q, k, v, kn * 50)
    acc_ref, l_ref = partial_attention_plain(q, k, v, kn * 50)
    assert (l_ref > 0).all() and (l_ref < 2.0**-100).all()
    assert (l > 0).all()
    up = 2.0**100  # exact; keeps the squares in compare's L2 norms from underflowing
    _check_partial((acc * up, l * up), (acc_ref * up, l_ref * up))


@pytest.mark.cuda
def test_partial_wrapper_counts_launches_and_refuses_fp32(gen):
    q, k, v, kn = _qkv_views(gen, 1, 70, 40, 2)
    before = launch_counts()["flash_attention_partial"]
    flash_attention_partial(q, k, v, kn)
    assert launch_counts()["flash_attention_partial"] == before + 1
    with pytest.raises(TypeError):  # fp16 has no entry; q fp32 with bf16 k / v mixes two
        flash_attention_partial(q.half(), k.half(), v.half(), kn)
    with pytest.raises(TypeError):
        flash_attention_partial(q.float(), k, v, kn)


def _bthd_views(gen, b, tq, tk, h, d):
    """q, k, v as the strided (B, T, H, D) views of two projections (row
    strides 3*H*D and 2*H*D), the way the unpacked and cross routes pass them."""
    q = _randn(gen, b, tq, 3, h, d)[:, :, 0]
    kv = _randn(gen, b, tk, 2, h, d)
    return q, kv[:, :, 0], kv[:, :, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 512])
@pytest.mark.parametrize("tq,tk", [(301, 301), (301, 150), (130, 333), (70, 1)])
def test_bthd_attention_matches_plain(gen, d, tq, tk):
    """Tk < Tq and Tk > Tq, neither a multiple of a key tile (128 keys at D
    64 / 128, 80 at D 192 / 256, 64 in the wide variant) nor of the query
    block; strided q / k / v
    read in place through their tensor maps. Head dims 320, 384 and 512 take
    the wide variant: one slice of O at 320, two at 384 (192 wide) and 512
    (256 wide)."""
    q, k, v = _bthd_views(gen, 2, tq, tk, 3, d)
    assert not q.is_contiguous() and not k.is_contiguous()
    ref = blockwise_attention(q, k, v)
    _assert_close(flash_attention(q, k, v), ref, **ATTENTION)
    _assert_close(attention_single_pass(q, k, v), ref, **ATTENTION)


@pytest.mark.cuda
def test_bthd_attention_at_d256_one_key_past_a_tile(gen):
    """Tk 81, one key past the 80-key tile of BthdTiles<256>: the second tile
    holds one key, its other 79 come in zero-filled and are masked."""
    q, k, v = _bthd_views(gen, 2, 301, 81, 3, 256)
    ref = blockwise_attention(q, k, v)
    _assert_close(flash_attention(q, k, v), ref, **ATTENTION)
    _assert_close(attention_single_pass(q, k, v), ref, **ATTENTION)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [448, 576, 640, 1088, 1152, 2048])
def test_wide_head_dims_cover_every_tile(gen, d):
    """The wide variant's other plans: a last slice partly past D (448: two
    of 256; 640: three of 256), three slices of 192 (576), and Q too wide to
    stay in shared memory (1088: four boxes resident, thirteen streamed
    beside K; 1152 and 2048 likewise), with Tk > Tq."""
    q, k, v = _bthd_views(gen, 2, 130, 333, 2, d)
    ref = blockwise_attention(q, k, v)
    _assert_close(flash_attention(q, k, v), ref, **ATTENTION)
    _assert_close(attention_single_pass(q, k, v), ref, **ATTENTION)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 512])
@pytest.mark.parametrize("t", [129, 643, 4100])
def test_bthd_attention_ragged_batches(gen, d, t):
    """B 2 and H 6 at ragged T: one query row and key past a 128 tile, the
    frame length, and 33 (D 64 / 128), 52 (D 192 / 256) or 65 (the wide
    variant) key tiles, so the ring of K / V stages (of K's boxes, in the
    wide variant) wraps many times; contiguous q / k / v."""
    q, k, v = (_randn(gen, 2, t, 6, d) for _ in range(3))
    ref = blockwise_attention(q, k, v)
    _assert_close(flash_attention(q, k, v), ref, **ATTENTION)
    _assert_close(attention_single_pass(q, k, v), ref, **ATTENTION)


def _nan_tail(x, t):
    """x (B, T', ...) with its rows t.. replaced by NaN, cut back to t rows:
    a view whose memory holds NaN right behind its last row."""
    buf = x.clone()
    buf[:, t:] = float("nan")
    return buf[:, :t]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256, 320, 384, 512])
@pytest.mark.parametrize("entry", [flash_attention, attention_single_pass])
def test_bthd_attention_reads_no_row_past_the_length(gen, entry, d):
    """q (Tq 301) and k / v (Tk 150) cut from longer buffers whose rows past
    the length hold NaN: the tensor maps' row extents are Tq and Tk, so no
    NaN is loaded (a zero-weight key times NaN would reach the output), and
    the output equals, bit for bit, the one from buffers whose tails hold
    finite values."""
    b, h, tq, tk, t = 2, 3, 301, 150, 400
    q, k, v = (_randn(gen, b, t, h, d) for _ in range(3))
    clean = entry(q[:, :tq], k[:, :tk], v[:, :tk])
    got = entry(_nan_tail(q, tq), _nan_tail(k, tk), _nan_tail(v, tk))
    assert torch.equal(got, clean)
    _assert_close(got, blockwise_attention(q[:, :tq], k[:, :tk], v[:, :tk]), **ATTENTION)


@pytest.mark.cuda
def test_partial_attention_reads_no_row_past_the_length(gen):
    """The partial kernel on q and k / v cut from NaN-tailed buffers: acc and
    l bit-identical to those of finite tails."""
    q, k, v, _ = _qkv_views(gen, 2, 400, 400, 3)
    tq, tk = 301, 150
    kn = k[:, :tk].float().square().sum(-1).amax(1).sqrt()
    clean = flash_attention_partial(q[:, :tq], k[:, :tk], v[:, :tk], kn)
    got = flash_attention_partial(_nan_tail(q, tq), _nan_tail(k, tk), _nan_tail(v, tk), kn)
    assert torch.equal(got[0], clean[0]) and torch.equal(got[1], clean[1])
    _check_partial(got, partial_attention_plain(q[:, :tq], k[:, :tk], v[:, :tk], kn))


@pytest.mark.cuda
def test_bthd_wrappers_count_launches_and_refuse_what_the_kernel_does_not_take(gen):
    q, k, v = _bthd_views(gen, 1, 70, 40, 2, 64)
    before = launch_counts()
    flash_attention(q, k, v)
    attention_single_pass(q, k, v)
    after = launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["attention_single_pass"] == before["attention_single_pass"] + 1
    with pytest.raises(TypeError):
        flash_attention(q.float(), k, v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    odd = _randn(gen, 1, 70, 2, 68)[..., :64]  # row stride 68: not 16-byte aligned
    with pytest.raises(ValueError):
        attention_single_pass(odd, odd, odd)
    odd_d = _randn(gen, 1, 70, 2, 96)  # head dim 96: not a multiple of 64
    with pytest.raises(ValueError):
        flash_attention(odd_d, odd_d, odd_d)
    assert launch_counts() == after
    # a head dim far past the main path's still takes the kernel, through sdpa too
    q, k, v = (_randn(gen, 1, 300, 1, 1152) for _ in range(3))
    _assert_close(sdpa(q, k, v), blockwise_attention(q, k, v), **ATTENTION)
    assert launch_counts()["attention_single_pass"] == after["attention_single_pass"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c,hidden", [(333, 256, 1024), (64, 128, 512)])
def test_mlp_matches_plain(gen, rows, c, hidden):
    x = _randn(gen, 1, rows, c)
    args = (_randn(gen, hidden, c, scale=0.05), _randn(gen, hidden, scale=0.1),
            _randn(gen, c, hidden, scale=0.05), _randn(gen, c, scale=0.1))
    before = launch_counts()["mlp"]
    got = mlp(x, *args)
    assert launch_counts()["mlp"] == before + 1
    _assert_close(got, mlp_plain(x, *args), **MLP)


def _gemm_case(gen, entry, rows, c, hidden, x=None):
    """(run, plain) of one MLP entry on x (1, rows, c) with random weights:
    block_mlp with LayerScale, or the bare mlp."""
    x = _randn(gen, 1, rows, c) if x is None else x
    w = (_randn(gen, hidden, c, scale=0.05), _randn(gen, hidden, scale=0.1),
         _randn(gen, c, hidden, scale=0.05), _randn(gen, c, scale=0.1))
    if entry == "mlp":
        return x, (lambda a: mlp(a, *w)), (lambda a: mlp_plain(a, *w))
    norm = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
            0.1 * torch.randn(c, generator=gen, device="cuda"))
    ls = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    return (x, (lambda a: block_mlp(a, *norm, *w, ls=ls)),
            (lambda a: block_mlp_plain(a, *norm, *w, ls=ls)))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["block_mlp", "mlp"])
@pytest.mark.parametrize("c,hidden", [(128, 512), (384, 1536), (1024, 4096)])
@pytest.mark.parametrize("rows", [1, 44, 333, 643 * 2])
def test_gemm_entries_match_plain(gen, entry, c, hidden, rows):
    """Both entries of csrc/block_mlp.cu at ragged row counts (one row, less
    than one 128-row tile, a few tiles and a tail, two frames' tokens) and at
    the widths of the tests, MoGe-2 and Pi3; one launch each."""
    x, run, plain = _gemm_case(gen, entry, rows, c, hidden)
    before = launch_counts()[entry]
    got = run(x)
    assert launch_counts()[entry] == before + 1
    ref = plain(x)
    _assert_close(got, ref, **(MLP if entry == "mlp" else block_mlp_bounds(x, ref)))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["block_mlp", "mlp"])
@pytest.mark.parametrize("rows,c,hidden", [(333, 128, 512), (1286, 1024, 4096)])
def test_gemm_entries_read_no_row_past_m_and_repeat_bit_for_bit(gen, entry, rows, c, hidden):
    """x as the first rows of a longer buffer with NaN behind them: the
    output equals that of a clean buffer bit for bit (the tensor map's row
    extent is M, so no row behind it loads), and a second call gives the same
    bits (no split-K, no atomics)."""
    buf = _randn(gen, 1, rows + 200, c)
    clean = buf[:, :rows].clone()
    buf[:, rows:] = float("nan")
    x, run, _ = _gemm_case(gen, entry, rows, c, hidden, x=buf[:, :rows])
    got = run(x)
    assert torch.equal(got, run(clean))
    assert torch.equal(got, run(x))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["block_mlp", "mlp"])
def test_gemm_entries_refuse_a_misaligned_x(gen, entry):
    """x one element into its buffer is contiguous but 2 bytes off a 16-byte
    boundary, which a tensor map cannot take: refused before any launch."""
    c = 128
    x = _randn(gen, 70 * c + 1)[1:].view(1, 70, c)
    _, run, _ = _gemm_case(gen, entry, 70, c, 512)
    before = launch_counts()[entry]
    with pytest.raises(ValueError):
        run(x)
    assert launch_counts()[entry] == before


@pytest.mark.cuda
def test_mlp_outside_kernel_widths_runs_plain_on_the_card(gen):
    x = _randn(gen, 2, 50, 320)
    args = (_randn(gen, 1280, 320, scale=0.05), _randn(gen, 1280, scale=0.1),
            _randn(gen, 320, 1280, scale=0.05), _randn(gen, 320, scale=0.1))
    before = launch_counts()["mlp"]
    got = mlp(x, *args)
    assert launch_counts()["mlp"] == before
    assert got.is_cuda and torch.equal(got, mlp_plain(x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [(1, 1000, 3), (2, 301, 2), (1, 64, 1), (1, 4100, 2),
                                   (2, 129, 4)])
def test_dots_attention_matches_plain(gen, b, t, h):
    """The products-only mode of the TMA + wgmma loop (128-key tiles, 128-row
    blocks): T not a multiple of the tile, less than one tile, 33 key tiles
    (the ring of 3 stages wraps), one key and one query past a tile; entries
    at the probe's N(0, 0.05^2) and at unit variance (logits far from 1)."""
    for scale in (0.05, 1.0):
        qkv = _randn(gen, b, t, 3 * h * D, scale=scale)
        before = launch_counts()["dots_attention"]
        got = dots_attention(qkv, h)
        assert launch_counts()["dots_attention"] == before + 1
        _assert_close(got, dots_attention_plain(qkv, h), **DOTS)


@pytest.mark.cuda
def test_dots_attention_refuses_what_the_kernel_does_not_take(gen):
    qkv = _randn(gen, 1, 70, 3 * 2 * D)
    before = launch_counts()
    with pytest.raises(TypeError):
        dots_attention(qkv.float(), 2)
    with pytest.raises(ValueError):
        dots_attention(qkv[:, ::2], 2)  # not contiguous
    with pytest.raises(ValueError):
        dots_attention(qkv, 3)  # 3 * 3 * 64 columns expected
    assert launch_counts() == before


@pytest.mark.cuda
def test_bundle_adjust_on_the_card_matches_the_host(gen):
    """The BA's segment sums (fixed order, in another one than the host's),
    batched inverses and dense solve against the same fp32 code on the host,
    on a well-posed scene: cameras on an arc, 200 points at depth
    4-8 seen by 5 of 8 frames, two cameras fixed (the gauge). One damped
    Gauss-Newton step (0.29 on the centers, 1.16 on the points) is held to
    5e-4: the same step in fp64 differs from the fp32 one by 7e-5 on the
    host, the rounding that another summation order moves. The whole
    20-iteration solve, whose accept / reject of a step near convergence
    compares two fp32 costs and may go the other way on the card, is held to
    1e-3 and to the noise floor; a second run on the card to the bit."""
    from pi3_slam_tpu_torch.device import select_device
    from pi3_slam_tpu_torch.sfm.ba import _gn_step, bundle_adjust, make_problem, reprojection_errors

    select_device("cuda")  # TF32 off, as every entry point sets it
    g = torch.Generator().manual_seed(0)
    n, t, m = 8, 200, 5
    pts = torch.rand(t, 3, generator=g) * torch.tensor([4.0, 4.0, 4.0]) + torch.tensor(
        [-2.0, -2.0, 4.0])
    centers = torch.stack([torch.linspace(-1.5, 1.5, n), torch.zeros(n), torch.zeros(n)], 1)
    rot = torch.eye(3).expand(n, 3, 3).clone()
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0]).expand(n, 4)
    obs_frame = torch.stack([torch.randperm(n, generator=g)[:m] for _ in range(t)])
    xc = pts[:, None] - centers[obs_frame]
    uv = intr[obs_frame][..., :2] * xc[..., :2] / xc[..., 2:] + intr[obs_frame][..., 2:]
    uv = uv + 0.5 * torch.randn(uv.shape, generator=g)
    start = dict(rotations=rot, centers=centers + 0.03 * torch.randn(n, 3, generator=g),
                 points=pts + 0.03 * torch.randn(t, 3, generator=g), intrinsics=intr,
                 obs_frame=obs_frame, obs_uv=uv, obs_valid=torch.ones(t, m))
    fixed = torch.tensor([1.0, 1.0] + [0.0] * (n - 2))
    step, out = {}, {}
    for device in ("cpu", "cuda"):
        prob = make_problem(**start, device=device)
        step[device] = _gn_step(prob, 2.0, torch.tensor(1e-4, device=device), fixed.to(device))
        out[device] = bundle_adjust(prob, iterations=20, fixed_cameras=fixed)
    for a, b in zip(step["cuda"], step["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=5e-4)
    card, host = out["cuda"], out["cpu"]
    again = bundle_adjust(make_problem(**start, device="cuda"), iterations=20, fixed_cameras=fixed)
    for name in ("rotations", "centers", "points"):  # fixed-order sums: the same bits
        assert torch.equal(getattr(again, name), getattr(card, name)), name
    assert card.points.is_cuda
    err = reprojection_errors(card).cpu()
    assert err[torch.isfinite(err)].median() < 1.0
    for name in ("rotations", "centers", "points"):
        torch.testing.assert_close(getattr(card, name).cpu(), getattr(host, name), rtol=0,
                                   atol=1e-3)


@pytest.mark.cuda
def test_chunk_bundle_adjust_is_bit_reproducible_on_the_card(gen):
    """A chunk's BA as the reconstructor runs it (owner-grouped tracks, no
    camera fixed, 10 LM steps): past the fourth step only the damping holds
    the gauge, so sums whose order changed from run to run parted two runs
    by millimetres. With fixed-order sums two runs give the same bits."""
    from pi3_slam_tpu_torch.device import select_device
    from pi3_slam_tpu_torch.sfm.ba import make_problem, run_bundle_adjust

    select_device("cuda")
    g = torch.Generator().manual_seed(1)
    n, k, m = 20, 40, 6  # frames, tracks per owner frame, observations per track
    centers = torch.stack([torch.linspace(0.0, 1.6, n), 0.05 * torch.sin(torch.arange(n) * 0.4),
                           torch.zeros(n)], 1)
    owner = torch.arange(n).repeat_interleave(k)
    obs_frame = (owner[:, None] + torch.arange(m)) % n  # the same row within an owner group
    pts = centers[owner] + torch.rand(n * k, 3, generator=g) * torch.tensor([3.0, 3.0, 4.0]) \
        + torch.tensor([-1.5, -1.5, 4.0])
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0]).expand(n, 4)
    xc = pts[:, None] - centers[obs_frame]
    uv = intr[obs_frame][..., :2] * xc[..., :2] / xc[..., 2:] + intr[obs_frame][..., 2:]
    prob = dict(rotations=torch.eye(3).expand(n, 3, 3).clone(),
                centers=centers + 0.02 * torch.randn(n, 3, generator=g),
                points=pts + 0.02 * torch.randn(n * k, 3, generator=g), intrinsics=intr,
                obs_frame=obs_frame, obs_uv=uv + 0.5 * torch.randn(uv.shape, generator=g),
                obs_valid=torch.ones(n * k, m))
    runs = [run_bundle_adjust(make_problem(**prob, device="cuda"), 10, 2.0, tracks_per_frame=k,
                              ftol=0.0) for _ in range(2)]
    for name in ("rotations", "centers", "points"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name)), name


# --- the fp32 entries (csrc/attention_f32.cu, the fp32 producer, the fp32
# GEMMs): each against its plain version in fp32 with ops/compare.FP32, a
# bound that must also reject the bf16 entry's output on the same inputs


def _randn32(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _assert_fp32(got, ref, bf16_got, **bounds):
    """got (an fp32 entry's output) within bounds of ref; the bounds reject
    the bf16 entry's output (upcast), so the path is really fp32."""
    assert got.dtype == torch.float32
    _assert_close(got, ref, **bounds)
    c = compare(bf16_got.float(), ref, **bounds)
    assert not c.ok, f"the fp32 bounds pass the bf16 entry's output: {c}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,true_t,h", [(2, 301, None, 4), (2, 384, 301, 4), (2, 70, 1, 4),
                                          (2, 643, None, 6), (1, 4100, None, 2)])
@pytest.mark.parametrize("q_scale", [1.0, 0.18033688011112042, 0.0, -0.3])
def test_fp32_packed_attention_matches_plain(gen, b, t, true_t, h, q_scale):
    """Both packed entries on fp32 qkv: ragged T, rows past true_t, MoGe-2's 6
    heads, 65 key tiles; any logit scale (the fp32 kernel scales before its
    max), the producer's 1, the encoder's D^-1/2 log2(e), 0 and negative."""
    qkv = _randn32(gen, b, t, 3 * h * D)
    ref = packed_attention_plain(qkv, h, true_t=true_t, q_scale=q_scale)
    bf16 = attention_single_pass_packed(qkv.bfloat16(), h, true_t=true_t, q_scale=q_scale)
    before = launch_counts()
    got = attention_single_pass_packed(qkv, h, true_t=true_t, q_scale=q_scale)
    _assert_fp32(got, ref, bf16, **FP32)
    if q_scale == 1.0:
        _assert_fp32(flash_attention_packed(qkv, h, true_t=true_t), ref, bf16, **FP32)
    after = launch_counts()
    assert after["attention_single_pass_packed_fp32"] == before["attention_single_pass_packed_fp32"] + 1
    assert after["attention_single_pass_packed"] == before["attention_single_pass_packed"]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", [flash_attention_packed, attention_single_pass_packed])
def test_fp32_packed_attention_reads_no_row_past_true_t(gen, entry):
    b, t, h, true_t = 2, 704, 6, 643
    qkv = _randn32(gen, b, t, 3 * h * D)
    qkv[:, true_t:] = float("nan")
    got = entry(qkv, h, true_t=true_t)
    assert torch.equal(got, entry(qkv[:, :true_t].contiguous(), h))
    _assert_close(got, packed_attention_plain(qkv, h, true_t=true_t), **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 512])
@pytest.mark.parametrize("tq,tk", [(301, 301), (301, 150), (130, 333), (70, 1)])
def test_fp32_bthd_attention_matches_plain(gen, d, tq, tk):
    """Strided (B, T, H, D) views at fp32 head dims of both kernels (D 64
    the TMA + wgmma loop, wider ones its sliced variant: one slice of O at
    128, a last slice partly past D at 192 and 320, 96-key tiles, Q's boxes
    streamed beside K's), Tk below and above Tq, neither a multiple of a
    tile."""
    q = _randn32(gen, 2, tq, 3, 3, d)[:, :, 0]
    kv = _randn32(gen, 2, tk, 2, 3, d)
    k, v = kv[:, :, 0], kv[:, :, 1]
    ref = blockwise_attention(q, k, v)
    bf16 = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    _assert_fp32(flash_attention(q, k, v), ref, bf16, **FP32)
    _assert_fp32(attention_single_pass(q, k, v), ref, bf16, **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [448, 576, 1152, 2048])
def test_fp32_wide_head_dims_match_plain(gen, d):
    """The sliced variant at wider head dims: a last slice of O partly past
    D (448, 576), 9 and 16 slices (1152, 2048), up to 64 boxes of Q and K
    through the ring every key tile; strided views, Tk > Tq, Tq past a
    128-row block."""
    q = _randn32(gen, 2, 130, 3, 2, d)[:, :, 0]
    kv = _randn32(gen, 2, 333, 2, 2, d)
    k, v = kv[:, :, 0], kv[:, :, 1]
    ref = blockwise_attention(q, k, v)
    bf16 = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    _assert_fp32(flash_attention(q, k, v), ref, bf16, **FP32)
    _assert_fp32(attention_single_pass(q, k, v), ref, bf16, **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256, 320, 384, 512])
def test_fp32_bthd_attention_reads_no_row_past_the_length(gen, d):
    b, h, tq, tk, t = 2, 3, 301, 150, 400
    q, k, v = (_randn32(gen, b, t, h, d) for _ in range(3))
    clean = flash_attention(q[:, :tq], k[:, :tk], v[:, :tk])
    got = flash_attention(_nan_tail(q, tq), _nan_tail(k, tk), _nan_tail(v, tk))
    assert torch.equal(got, clean)
    _assert_close(got, blockwise_attention(q[:, :tq], k[:, :tk], v[:, :tk]), **FP32)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk", [(301, 150), (64, 64), (130, 1)])
def test_fp32_partial_attention_matches_plain(gen, tq, tk):
    q = _randn32(gen, 2, tq, 3, 4, D)[:, :, 0]
    k, v = _randn32(gen, 2, tk, 4, D), _randn32(gen, 2, tk, 4, D)
    kn = k.square().sum(-1).amax(1).sqrt()
    (acc, l), (acc_ref, l_ref) = flash_attention_partial(q, k, v, kn), partial_attention_plain(q, k, v, kn)
    acc_bf16, l_bf16 = flash_attention_partial(q.bfloat16(), k.bfloat16(), v.bfloat16(), kn)
    _assert_fp32(acc, acc_ref, acc_bf16, **FP32)
    _assert_close(l, l_ref, **FP32)
    _assert_fp32(acc / l[..., None], acc_ref / l_ref[..., None], acc_bf16 / l_bf16[..., None], **FP32)
    # NaN behind Tq / Tk: the same bits as finite tails
    big = _randn32(gen, 2, 400, 4, D)
    big[:, :tk] = k
    got = flash_attention_partial(q, _nan_tail(big, tk), _nan_tail(big, tk), kn)
    assert torch.equal(got[0], flash_attention_partial(q, k, k.clone(), kn)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("with_norm", [True, False])
@pytest.mark.parametrize("pad", [0, 37])
@pytest.mark.parametrize("t", [1, 63, 643, 4100])
@pytest.mark.parametrize("h", [2, 5, 6, 16, 20])
def test_fp32_producer_matches_plain(gen, h, t, pad, with_norm):
    """The fp32 producer (4 columns a lane, 16 lanes a head, 2 heads a pass,
    8 heads a grid row): H 5 and 6 mask a pass, H 16 fills two grid rows, 20
    three; q, k and v within FP32, v copied bit for bit, rows past T zero,
    kn to 1e-5; the bounds reject the bf16 producer's output."""
    b = 1 if t == 4100 else 2
    qkv = _randn32(gen, b, t, 3 * h * D)
    cos, sin = rope_tables(make_patch_positions(b, 1, t, offset=1, device="cuda"), D)
    kw = _producer_norm(gen) if with_norm else {}
    got, kn = qkv_rope_producer(qkv, cos, sin, h, t + pad, return_k_norms=True, **kw)
    ref, kn_ref = qkv_rope_producer_plain(qkv, cos, sin, h, t + pad, return_k_norms=True, **kw)
    bf16, _ = qkv_rope_producer(qkv.bfloat16(), cos, sin, h, t + pad, return_k_norms=True, **kw)
    c = h * D
    for i in range(2):  # q, k
        part = slice(i * c, (i + 1) * c)
        _assert_fp32(got[:, :t, part], ref[:, :t, part], bf16[:, :t, part], **FP32)
    assert torch.equal(got[:, :t, 2 * c:], qkv[..., 2 * c:])
    assert not got[:, t:].any()
    _assert_close(kn, kn_ref, max_rel=1e-5, l2_rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["block_mlp", "mlp"])
@pytest.mark.parametrize("c,hidden", [(128, 512), (384, 1536), (1024, 4096)])
@pytest.mark.parametrize("rows", [1, 44, 333, 643 * 2, 3537])
def test_fp32_gemm_entries_match_plain(gen, entry, c, hidden, rows):
    """Both MLP entries on fp32 x and weights: the fp32 LayerNorm pass and the
    3xTF32 GEMMs with their epilogues, rows not a multiple of the 128-row
    tile (3537: MoGe-2's tokens); the bounds reject the bf16 entry's
    output."""
    x = _randn32(gen, 1, rows, c)
    w = (_randn32(gen, hidden, c, scale=0.05), _randn32(gen, hidden, scale=0.1),
         _randn32(gen, c, hidden, scale=0.05), _randn32(gen, c, scale=0.1))
    if entry == "mlp":
        run, plain, bounds = (lambda a, *p: mlp(a, *p)), (lambda a, *p: mlp_plain(a, *p)), None
    else:
        norm = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
                0.1 * torch.randn(c, generator=gen, device="cuda"))
        ls = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        run = lambda a, *p: block_mlp(a, *norm, *p, ls=ls)
        plain = lambda a, *p: block_mlp_plain(a, *norm, *p, ls=ls)
    before = launch_counts()[f"{entry}_fp32"]
    got = run(x, *w)
    assert launch_counts()[f"{entry}_fp32"] == before + 1
    ref = plain(x, *w)
    bounds = FP32 if entry == "mlp" else block_mlp_bounds(x, ref)
    _assert_fp32(got, ref, run(x.bfloat16(), *(p.bfloat16() for p in w)), **bounds)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["block_mlp", "mlp"])
def test_fp32_gemm_entries_read_no_row_past_m_and_repeat_bit_for_bit(gen, entry):
    rows, c, hidden = 333, 384, 1536
    buf = _randn32(gen, 1, rows + 200, c)
    clean = buf[:, :rows].clone()
    buf[:, rows:] = float("nan")
    w = (_randn32(gen, hidden, c, scale=0.05), _randn32(gen, hidden, scale=0.1),
         _randn32(gen, c, hidden, scale=0.05), _randn32(gen, c, scale=0.1))
    if entry == "mlp":
        run = lambda a: mlp(a, *w)
    else:
        ones, zeros = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        run = lambda a: block_mlp(a, ones, zeros, *w, ls=ones)
    got = run(buf[:, :rows])
    assert torch.equal(got, run(clean))
    assert torch.equal(got, run(buf[:, :rows]))


@pytest.mark.cuda
def test_tensor_cores_read_an_fp32_pattern_as_truncated_tf32(gen):
    """The fp32 GEMM (csrc/gemm_f32.cuh) hands the raw fp32 tiles to wgmma as
    the big parts of its 3xTF32 split: that holds only if the tensor cores
    drop an fp32 pattern's low 13 bits, on both operands."""
    from pi3_slam_tpu_torch.tools.perf_lab import tf32_read

    for side, shares in tf32_read().items():
        assert shares["truncate"] == 1.0 and shares["raw fp32"] < 1.0, (side, shares)


@pytest.mark.cuda
def test_fp32_entries_count_launches_and_refuse_fp16(gen):
    """Each fp32 entry counts under <name>_fp32 and not under the bf16 name;
    fp16 is refused by every wrapper before any launch; fp32 above head dim
    256 runs (the sliced variant) and counts as fp32; a head dim that is not a
    multiple of 64 is refused."""
    qkv = _randn32(gen, 1, 70, 3 * 2 * D)
    cos, sin = rope_tables(make_patch_positions(1, 1, 70, offset=1, device="cuda"), D)
    before = launch_counts()
    packed = qkv_rope_producer(qkv, cos, sin, 2, 70, **_producer_norm(gen))
    flash_attention_packed(packed, 2)
    attention_single_pass_packed(packed, 2)
    q, k, v = packed.view(1, 70, 3, 2, D).unbind(2)
    flash_attention(q, k, v)
    attention_single_pass(q, k, v)
    flash_attention_partial(q, k, v, k.square().sum(-1).amax(1).sqrt())
    x = _randn32(gen, 1, 70, 128)
    w = (_randn32(gen, 512, 128), _randn32(gen, 512), _randn32(gen, 128, 512), _randn32(gen, 128))
    mlp(x, *w)
    block_mlp(x, torch.ones(128, device="cuda"), torch.zeros(128, device="cuda"), *w)
    after = launch_counts()
    for name in ("qkv_rope_producer", "flash_attention_packed", "attention_single_pass_packed",
                 "flash_attention", "attention_single_pass", "flash_attention_partial", "mlp",
                 "block_mlp"):
        assert after[f"{name}_fp32"] == before[f"{name}_fp32"] + 1, name
        assert after[name] == before[name], name
    half = qkv.half()
    for call in (lambda: qkv_rope_producer(half, cos, sin, 2, 70),
                 lambda: attention_single_pass_packed(half, 2),
                 lambda: flash_attention_packed(half, 2),
                 lambda: flash_attention(*(a.half() for a in (q, k, v))),
                 lambda: mlp(x.half(), *w),
                 lambda: block_mlp(x.half(), torch.ones(128, device="cuda"),
                                   torch.zeros(128, device="cuda"), *w)):
        with pytest.raises(TypeError):
            call()
    wide = _randn32(gen, 1, 300, 1, 320)
    flash_attention(wide, wide, wide)
    counts = launch_counts()
    assert counts["flash_attention_fp32"] == after["flash_attention_fp32"] + 1
    assert counts["flash_attention"] == after["flash_attention"]
    odd = _randn32(gen, 1, 300, 1, 96)
    with pytest.raises(ValueError):
        flash_attention(odd, odd, odd)
    assert launch_counts() == counts


def _ba_problem(seed: int):
    """12 cameras on a line (identity rotations, f 300) seeing 300 points
    4-10 units ahead, every track observed in every frame, poses and points
    perturbed."""
    import numpy as np

    from pi3_slam_tpu_torch.sfm.ba import make_problem

    rng = np.random.default_rng(seed)
    n, t = 12, 300
    centers = np.stack([0.3 * np.arange(n), np.zeros(n), np.zeros(n)], 1)
    points = np.stack([rng.uniform(-3, 7, t), rng.uniform(-2, 2, t), rng.uniform(4, 10, t)], 1)
    rel = points[:, None] - centers[None]  # (T, N, 3)
    uv = 300.0 * rel[..., :2] / rel[..., 2:] + np.array([320.0, 240.0])
    uv += rng.normal(size=uv.shape) * 0.5
    return make_problem(
        np.tile(np.eye(3), (n, 1, 1)), centers + rng.normal(size=centers.shape) * 0.02,
        points + rng.normal(size=points.shape) * 0.05, np.tile([300.0, 300, 320, 240], (n, 1)),
        np.tile(np.arange(n), (t, 1)), uv, np.ones((t, n)), device="cuda")


@pytest.mark.cuda
def test_online_consumer_stream_matches_the_default_stream(tmp_path):
    """The online consumer's BA (another thread, a high-priority stream of its
    own, beside work on the default stream) gives the default stream's result
    bit for bit; and the online driver's async and sync runs over a small
    random model (head dim 64, the kernels' route) give one trajectory
    (1e-5)."""
    import threading

    import numpy as np
    from PIL import Image

    from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config
    from pi3_slam_tpu_torch.sfm.ba import run_bundle_adjust
    from pi3_slam_tpu_torch.slam.config import OnlineConfig
    from pi3_slam_tpu_torch.slam.online import Pi3SLAMOnline

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the hand-written kernels run only there)")
    want = run_bundle_adjust(_ba_problem(0), 10, 2.0)
    got = {}

    def consumer():
        with torch.cuda.stream(torch.cuda.Stream(priority=-1)):
            got["out"] = run_bundle_adjust(_ba_problem(0), 10, 2.0)

    busy = torch.randn(4096, 4096, device="cuda")
    thread = threading.Thread(target=consumer)
    thread.start()
    for _ in range(20):  # default-stream work beside it
        busy = (busy @ busy).tanh()
    thread.join()
    for a, b in zip(got["out"], want):
        assert torch.equal(a, b)

    frames = tmp_path / "frames"
    frames.mkdir()
    base = np.random.default_rng(5).integers(30, 220, (64, 84, 3)).astype(np.uint8)
    for i in range(8):
        Image.fromarray(np.roll(base, 3 * i, axis=1)).save(frames / f"frame_{i:04d}.png")
    paths = sorted(str(p) for p in frames.iterdir())
    cfg = Pi3Config(encoder=DinoV2Config(embed_dim=128, depth=2, num_heads=2, pos_embed_size=6),
                    dec_embed_dim=128, dec_num_heads=2, dec_depth=4, head_dim=128, head_depth=1,
                    head_num_heads=2, camera_dim=32)
    runs = {}
    for pipelined in (False, True):
        slam = Pi3SLAMOnline(OnlineConfig(chunk_length=4, overlap=2, pixel_limit=4000,
                                          use_metric_depth=False, max_keypoints=30,
                                          output_dir=str(tmp_path / str(pipelined))),
                             pi3_config=cfg)
        r = slam.process_image_paths(paths, pipelined=pipelined)
        assert r["num_chunks"] == 4 and slam.queue_status()["chunks_inflight"] == 0
        # every chunk's step ran the hand-written kernels
        assert all(c["block_mlp"] and c["qkv_rope_producer"] for c in slam.chunk_launches)
        runs[pipelined] = slam._merged_trajectory()[0]
    np.testing.assert_allclose(runs[True], runs[False], atol=1e-5)


@pytest.mark.cuda
def test_tsdf_fusion_on_the_card_repeats_bit_for_bit_and_agrees_with_the_host(gen):
    """TSDF fusion (mapping/tsdf.py) of 12 analytic sphere views at 60x80: the
    voxel -> pixel gather has no atomics, so a second card run gives the same
    volume bit for bit; against the host CPU the pixel index may round the
    other way where u lands within rounding of .5 (another summation order in
    the product), so at most 1e-4 of the voxels may differ by more than 1e-5;
    the raycast hit masks agree on 99.9% of the rays."""
    import numpy as np

    from pi3_slam_tpu_torch.mapping import TSDFConfig, fuse_tsdf, raycast_depth

    h, w = 60, 80
    intr = np.array([70.0, 70.0, w / 2, h / 2])
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depths, rots, cens = [], [], []
    for i in range(12):
        ang = 2 * np.pi * i / 12
        elev = 0.35 * np.sin(3 * ang)
        c = 3.0 * np.array([np.cos(ang) * np.cos(elev), np.sin(ang) * np.cos(elev), np.sin(elev)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        xn, yn = (u - intr[2]) / intr[0], (v - intr[3]) / intr[1]
        rc = R @ c
        a = xn**2 + yn**2 + 1.0
        b = 2.0 * (xn * rc[0] + yn * rc[1] + rc[2])
        disc = b**2 - 4 * a * (c @ c - 1.0)
        s = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a), 0.0)
        depths.append(np.where((disc > 0) & (s > 0), s, 0.0))
        rots.append(R)
        cens.append(c)
    args = (np.stack(depths), np.tile(intr, (12, 1)), np.stack(rots), np.stack(cens))
    cfg = TSDFConfig(voxel_size=0.04)
    card = [fuse_tsdf(*args, config=cfg, device="cuda") for _ in range(2)]
    host = fuse_tsdf(*args, config=cfg, device="cpu")
    for name in ("tsdf", "weight", "color"):
        assert np.array_equal(getattr(card[0], name), getattr(card[1], name)), name
    off = (np.abs(card[0].tsdf - host.tsdf) > 1e-5).mean()
    assert off <= 1e-4, off
    c = 3.0 * np.array([np.cos(0.37), np.sin(0.37), 0.21])
    z = -c / np.linalg.norm(c)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    a = raycast_depth(card[0], intr, R, c, h, w, device="cuda")
    b = raycast_depth(host, intr, R, c, h, w, device="cpu")
    assert (a["mask"] == b["mask"]).mean() >= 0.999 and a["mask"].mean() > 0.2


# ----- threads and devices through the wrappers (the replicas of a device mesh) -----


def _partial_inputs(gen, dev, t=300):
    q, k, v = (_randn(gen, 1, t, 2, D).to(dev) for _ in range(3))
    kn = k.float().square().sum(-1).amax(dim=1).sqrt()
    return q, k, v, kn


@pytest.mark.cuda
def test_a_launch_leaves_the_calling_threads_device(gen):
    """Every launcher switches to its tensor's device for the launch and
    back after it (csrc/device_guard.cuh): a launch on each card, from this
    thread and from a new one, leaves the thread on cuda:0, where an
    allocation without an index then lands."""
    import threading

    def launch_everywhere():
        torch.cuda.set_device(0)
        for d in range(torch.cuda.device_count()):
            dev = torch.device("cuda", d)
            q, k, v, kn = _partial_inputs(gen, dev)
            flash_attention_partial(q, k, v, kn)
            attention_single_pass(q, k, v)
            x = _randn(gen, 40, 128).to(dev)
            w1, w2 = _randn(gen, 512, 128, scale=0.05).to(dev), _randn(gen, 128, 512, scale=0.05).to(dev)
            ones, zeros = torch.ones(128, device=dev), torch.zeros(128, device=dev)
            block_mlp(x, ones, zeros, w1, torch.zeros(512, device=dev), w2, zeros)
            assert torch.cuda.current_device() == 0
            assert torch.empty(1, device="cuda").device.index == 0
        torch.cuda.synchronize()

    launch_everywhere()
    errors = []
    t = threading.Thread(target=lambda: errors.append(launch_everywhere()))
    t.start()
    t.join()
    assert errors == [None]


@pytest.mark.cuda
def test_threads_launching_at_once_are_all_counted_and_agree(gen):
    """Eight threads launch the partial kernel 25 times each at once (the
    replicas of a mesh on one card): the count grows by exactly 200, and
    every output equals the one-thread output bit for bit."""
    from concurrent.futures import ThreadPoolExecutor

    q, k, v, kn = _partial_inputs(gen, "cuda")
    ref = flash_attention_partial(q, k, v, kn)
    torch.cuda.synchronize()
    before = launch_counts()["flash_attention_partial"]

    def run(_):
        outs = [flash_attention_partial(q, k, v, kn) for _ in range(25)]
        torch.cuda.current_stream().synchronize()
        return outs

    with ThreadPoolExecutor(8) as pool:
        results = [o for outs in pool.map(run, range(8)) for o in outs]
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention_partial"] - before == 200
    for acc, l in results:
        assert torch.equal(acc, ref[0]) and torch.equal(l, ref[1])


@pytest.mark.cuda
def test_a_first_build_from_eight_threads_compiles_once(gen, tmp_path, monkeypatch):
    """Eight threads ask for one library that is not built yet (an empty
    build directory): nvcc runs once, under the lock, and every thread gets
    the same handle."""
    import threading

    from pi3_slam_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    builds = []
    build = _build.build
    monkeypatch.setattr(_build, "build", lambda name: builds.append(build(name)) or builds[-1])
    handles = []
    threads = [threading.Thread(target=lambda: handles.append(_build.load_library("dots_attention")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and builds[0][1] > 0  # compiled, once
    assert len(handles) == 8 and len({id(h) for h in handles}) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_ring_launches_row_5_at_every_step_and_raises_off_its_head_dim(gen, dtype):
    """ring_attention over two sequence shards on the card: each of its 4
    steps is a counted row-5 launch (bf16 or fp32 entry), and its output, 20
    zero-padded tail keys taken out by their count, holds against plain
    attention over the real keys (ATTENTION in bf16, FP32 in fp32). At head
    dim 128, which row 5 has no kernel for, the ring raises rather than run
    a plain step on the card."""
    from pi3_slam_tpu_torch.ops.attention import sdpa_reference
    from pi3_slam_tpu_torch.parallel.ring import ring_attention

    t, n_pad = 600, 20
    q, k, v = (_randn(gen, 1, t, 4, D).to(dtype) for _ in range(3))
    for x in (q, k, v):
        x[:, t - n_pad :] = 0
    key = "flash_attention_partial" + ("_fp32" if dtype == torch.float32 else "")
    before = launch_counts()[key]
    out = ring_attention(*[[x[:, : t // 2], x[:, t // 2 :]] for x in (q, k, v)], n_pad=n_pad)
    assert launch_counts()[key] - before == 4
    got = torch.cat(out, dim=1)[:, : t - n_pad]
    real = [x[:, : t - n_pad] for x in (q, k, v)]
    if dtype == torch.bfloat16:
        _assert_close(got, blockwise_attention(*real), **ATTENTION)
    else:
        _assert_close(got, sdpa_reference(*real), **FP32)
    wide = [_randn(gen, 1, t, 2, 128).to(dtype) for _ in range(3)]
    with pytest.raises(ValueError, match="head dim 64"):
        ring_attention(*[[x[:, : t // 2], x[:, t // 2 :]] for x in wide])


def _port_checkpoint_and_frames(tmp_path, side):
    """A tiny Pi3 (head dim 64) written by the port's own converter, six
    ``side`` x ``side`` frames, and the creator's arguments for them."""
    import numpy as np
    from PIL import Image

    from pi3_slam_tpu_torch.models.convert import init_pi3_params, save_pi3_checkpoint
    from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
    from pi3_slam_tpu_torch.models.pi3 import Pi3Config

    cfg = Pi3Config(
        encoder=DinoV2Config(embed_dim=128, depth=1, num_heads=2, pos_embed_size=4),
        dec_embed_dim=128, dec_num_heads=2, dec_depth=2, head_dim=128, head_depth=1,
        head_num_heads=2, camera_dim=16,
    )
    ckpt = str(tmp_path / "pi3.npz")
    save_pi3_checkpoint(ckpt, init_pi3_params(0, cfg), cfg)
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (side, side, 3), dtype=np.uint8)).save(
            frames / f"{i}.png")
    return ["--images", str(frames), "--model-path", ckpt, "--output", str(tmp_path / "out"),
            "--chunk-length", "3", "--overlap", "1", "--pixel-limit", str(side * side),
            "--no-metric-depth"]


@pytest.mark.cuda
def test_a_profiled_chunk_s_root_span_carries_the_trace_s_device_time(tmp_path):
    """On the card, the ``chunk`` row of ``trace_summary``'s by-span table
    over a ``--profile-dir`` trace carries at least 95% of the trace's
    device time: every launch of the chunk, the hand-written kernels' among
    them, is charged to the span it was made in, whichever lane the trace
    puts the launching thread's CUDA calls on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device time of a profiled chunk)")
    from pi3_slam_tpu_torch import create_offline_chunks
    from pi3_slam_tpu_torch.tools import trace_summary

    prof = tmp_path / "prof"
    before = launch_counts()
    rc = create_offline_chunks.main(_port_checkpoint_and_frames(tmp_path, 112) + [
        "--device", "cuda", "--profile-dir", str(prof)])
    assert rc == 0
    assert sum(launch_counts().values()) > sum(before.values())  # the hand-written kernels ran
    s = trace_summary.summarize(str(prof / "chunk_trace.json"))
    total, table = s["device_total_us"], s["by_span"]
    assert total > 0 and table["chunk"]["count"] == 1
    assert table["chunk"]["device_us"] >= 0.95 * total, (table["chunk"], total)
    assert table["chunk"]["device_us"] <= total * (1 + 1e-9)
    parts = sum(table[n]["device_us"] for n in ("creator.dispatch", "creator.finish"))
    assert parts <= table["chunk"]["device_us"] * (1 + 1e-9)
    assert table["pi3.decoder"]["device_us"] > 0
