"""The kv-merge global attention of the port against the JAX package, on the CPU.

* ``partial_attention_plain`` (what the hand-written partial attention kernel
  is held to on the card) against the Pallas ``flash_attention_partial_tpu``
  in interpret mode: the unnormalised ``acc`` and ``l`` themselves, key shards
  that share ``kn`` summing to the one-shard result, and Tk < Tq. fp32 on both
  sides, different summation order: atol 3e-5 on outputs of order 1 (the
  Pallas tests' own tolerance), rtol 1e-5 on ``l``.
* The Pi3 forward with ``global_kv_merge=2`` against ``pi3_forward`` at the
  tolerance of tests/test_torch_pi3.py, and the exact fallback when the frame
  count is not a multiple of the merge factor.
* The bounds that chip_smoke.py and tests/test_torch_cuda.py hold the kernel
  to accept its bf16 arithmetic (simulated here) and fail wrong outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.models import pi3 as jax_pi3
from pi3_slam_tpu.ops.attention import sdpa_reference
from pi3_slam_tpu.ops.pallas_attention import flash_attention_partial_tpu

from pi3_slam_tpu_torch.models.convert import build_pi3, init_pi3_params, pi3_state_from_jax
from pi3_slam_tpu_torch.models.dinov2 import DinoV2Config
from pi3_slam_tpu_torch.models.pi3 import Pi3Config
from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops.compare import ATTENTION, PARTIAL_L, compare
from pi3_slam_tpu_torch.ops.partial_attention import (
    flash_attention_partial,
    partial_attention_plain,
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


D = 64
ATOL = 3e-5

CFG = Pi3Config(
    encoder=DinoV2Config(embed_dim=128, depth=2, num_heads=2, pos_embed_size=6),
    dec_embed_dim=128, dec_num_heads=2, dec_depth=4, head_dim=128, head_depth=1,
    head_num_heads=2, camera_dim=32,
)


def _qkv(rng, b, tq, tk, h):
    q = rng.normal(size=(b, tq, h, D)).astype(np.float32)
    k = rng.normal(size=(b, tk, h, D)).astype(np.float32)
    v = rng.normal(size=(b, tk, h, D)).astype(np.float32)
    kn = np.sqrt((k**2).sum(-1).max(axis=1)).astype(np.float32)  # (B, H) global
    return q, k, v, kn


def _pallas(q, k, v, kn):
    acc, l = flash_attention_partial_tpu(
        *(jnp.asarray(a) for a in (q, k, v, kn)), blk_q=128, blk_k=128, n_interleave=1,
        interpret=True,
    )
    return np.asarray(acc), np.asarray(l)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_partial_plain_shards_match_pallas_and_sum_to_full(rng):
    b, t, h = 1, 256, 2
    q, k, v, kn = _qkv(rng, b, t, t, h)
    acc = np.zeros((b, t, h, D), np.float32)
    l = np.zeros((b, t, h), np.float32)
    for s in range(2):  # two key shards of 128 with the shared global kn
        ks, vs = k[:, s * 128 : (s + 1) * 128], v[:, s * 128 : (s + 1) * 128]
        want_acc, want_l = _pallas(q, ks, vs, kn)
        got_acc, got_l = partial_attention_plain(_t(q), _t(ks), _t(vs), _t(kn))
        np.testing.assert_allclose(got_acc.numpy(), want_acc, atol=ATOL)
        np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-5)
        acc += got_acc.numpy()
        l += got_l.numpy()
    full_acc, full_l = partial_attention_plain(_t(q), _t(k), _t(v), _t(kn))
    np.testing.assert_allclose(acc, full_acc.numpy(), atol=ATOL)
    np.testing.assert_allclose(l, full_l.numpy(), rtol=1e-5)
    ref = np.asarray(sdpa_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(acc / l[..., None], ref, atol=ATOL)


@pytest.mark.parametrize("tq,tk", [(384, 192), (300, 75)])
def test_partial_plain_asymmetric_lengths_match_pallas(rng, tq, tk):
    """The merged-kv usage: one complete key set with Tk < Tq, ragged."""
    q, k, v, kn = _qkv(rng, 2, tq, tk, 2)
    want_acc, want_l = _pallas(q, k, v, kn)
    got_acc, got_l = flash_attention_partial(_t(q), _t(k), _t(v), _t(kn))
    assert got_acc.shape == (2, tq, 2, D) and got_l.shape == (2, tq, 2)
    np.testing.assert_allclose(got_acc.numpy(), want_acc, atol=ATOL)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=1e-5)
    # query blocking (needed at Tq = 64,300) does not change the result
    blocked_acc, blocked_l = partial_attention_plain(_t(q), _t(k), _t(v), _t(kn), q_block=64)
    np.testing.assert_allclose(blocked_acc.numpy(), got_acc.numpy(), atol=1e-6)
    np.testing.assert_allclose(blocked_l.numpy(), got_l.numpy(), rtol=1e-6)


def test_partial_plain_takes_strided_views_without_counting(rng):
    """q / k / v as the qkv projection's strided slices give the same result
    as contiguous copies; CPU tensors never count a kernel launch."""
    b, t, h = 1, 130, 2
    qkv = _t(rng.normal(size=(b, t, 3, h, D)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    kn = k.square().sum(-1).amax(1).sqrt()
    before = launch_counts()
    acc, l = flash_attention_partial(q, k, v, kn)
    assert launch_counts() == before
    want_acc, want_l = flash_attention_partial(q.contiguous(), k.contiguous(), v.contiguous(), kn)
    np.testing.assert_array_equal(acc.numpy(), want_acc.numpy())
    np.testing.assert_array_equal(l.numpy(), want_l.numpy())


def _perturbed_tree(seed):
    rng = np.random.default_rng(seed)
    tree = init_pi3_params(seed, CFG)
    return jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.mark.parametrize("n_frames,merge", [(4, 2), (6, 3), (3, 2)])
def test_pi3_kv_merge_matches_jax(n_frames, merge):
    """merge divides N: merged global blocks on both sides; N = 3 with merge
    2: the exact path on both sides (the JAX dispatch condition)."""
    cfg = dataclasses.replace(CFG, global_kv_merge=merge)
    jcfg = jax_pi3.Pi3Config.from_json(cfg.to_json())
    tree = _perturbed_tree(7)
    imgs = np.random.default_rng(8).random((1, n_frames, 3, 42, 56), dtype=np.float32)
    want = jax_pi3.pi3_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), jcfg)
    state = pi3_state_from_jax(tree)
    model = build_pi3(cfg, state, torch.device("cpu"), torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
        exact = build_pi3(CFG, state, torch.device("cpu"), torch.float32)(torch.from_numpy(imgs))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5, rtol=1e-4,
                                   err_msg=key)
    merged = n_frames % merge == 0
    differs = not np.allclose(got["points"].numpy(), exact["points"].numpy(), atol=1e-4)
    assert differs == merged  # the fallback is the exact model, the merge is not


def _partial_bf16_p(q, k, v, kn):
    """The hand-written kernel's arithmetic on the CPU: fp32 logits, exact
    running max, P rounded to bf16 for the PV product, l from the unrounded
    P, one rescale by 2^(max - mh) at the end."""
    d = q.shape[-1]
    scale = d**-0.5 * np.log2(np.e)
    q32, k32, v32 = (a.float().transpose(1, 2) for a in (q, k, v))
    s = (q32 @ k32.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    mh = (q32.norm(dim=-1, keepdim=True) * scale * kn[:, :, None, None] + 1).clamp_max(120)
    f = torch.exp2(m - mh)
    acc = (p.to(torch.bfloat16).float() @ v32) * f
    l = p.sum(-1, keepdim=True) * f
    return acc.transpose(1, 2), l[..., 0].transpose(1, 2)


def test_chip_bounds_pass_partial_kernel_arithmetic_and_reject_wrong_outputs(rng):
    bf16 = torch.bfloat16
    q, k, v, _ = (_t(a).to(bf16) for a in _qkv(rng, 1, 300, 150, 2))
    kn = k.float().square().sum(-1).amax(1).sqrt()
    got_acc, got_l = _partial_bf16_p(q, k, v, kn)
    ref_acc, ref_l = partial_attention_plain(q, k, v, kn)
    for got, ref, bounds in ((got_acc, ref_acc, ATTENTION), (got_l, ref_l, PARTIAL_L),
                             (got_acc / got_l[..., None], ref_acc / ref_l[..., None], ATTENTION)):
        c = compare(got, ref, **bounds)
        assert c.ok and c.rejects_wrong, c
        assert not compare(torch.zeros_like(ref), ref, **bounds).ok
        assert not compare(1.1 * ref, ref, **bounds).ok
