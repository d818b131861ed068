"""The port's cross-attention block and the generic attention layer against
the JAX package, on the CPU.

* ``cross_attention`` and ``cross_block`` (pi3_slam_tpu_torch/models/
  cross_attention.py) against ``pi3_slam_tpu.models.cross_attention`` at C 128,
  2 heads of 64, with qk-norm and LayerScale on and off, x and y of
  different lengths.
* The unpacked ``layers.attention`` route (any head dim but 64: qk-norm and
  RoPE in plain torch, then ``sdpa``) and the fallback MLP half of ``Block``
  (C or hidden not a multiple of 128: LayerNorm, ``mlp``, LayerScale,
  residual) against ``pi3_slam_tpu.models.layers.attention`` / ``block``.
* ``cross_block_state_from_jax`` round trip.

Parameter trees are the numpy random trees of ``models/convert.py`` with
every leaf perturbed (so norms, biases and LayerScales are not trivial);
inputs come from numpy seeds. fp32 on both sides: atol 2e-5
(tests/test_cross_attention.py's tolerance), rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.models import cross_attention as jax_cross
from pi3_slam_tpu.models import layers as jax_layers
from pi3_slam_tpu.ops.rope import make_patch_positions as jax_positions

from pi3_slam_tpu_torch.models.convert import (
    _BLOCK_LEAVES,
    _init_block_stack,
    build_cross_block,
    cross_block_state_from_jax,
    init_cross_block_params,
)
from pi3_slam_tpu_torch.models.cross_attention import cross_attention
from pi3_slam_tpu_torch.models.layers import Block, attention
from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops.rope import make_patch_positions, rope_tables

TOL = dict(atol=2e-5, rtol=1e-5)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32),
                        tree)


def _inputs(seed, b, tx, ty, c):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tx, c)).astype(np.float32),
            rng.normal(size=(b, ty, c)).astype(np.float32))


def _positions(b, t):
    """(y, x) positions of t tokens: a 10-wide patch grid after t % 10
    special tokens at (0, 0)."""
    return jax_positions(b, t // 10, 10, num_special=t % 10, offset=1)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("qk_norm,layerscale", [(True, 0.01), (False, None), (True, None)])
@pytest.mark.parametrize("tx,ty", [(300, 170), (64, 259)])
def test_cross_block_matches_jax(qk_norm, layerscale, tx, ty):
    c, heads = 128, 2
    tree = _perturb(init_cross_block_params(3, c, heads, 4, qk_norm, layerscale), 4)
    x, y = _inputs(5, 2, tx, ty, c)
    xpos, ypos = _positions(2, tx), _positions(2, ty)
    want = jax_cross.cross_block(jnp.asarray(x), jnp.asarray(y), _jax(tree), heads,
                                 xpos=xpos, ypos=ypos, rope_base=100.0)
    blk = build_cross_block(cross_block_state_from_jax(tree), heads, torch.device("cpu"),
                            torch.float32)
    before = launch_counts()
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(np.array(xpos)),
                  torch.from_numpy(np.array(ypos)))
    assert launch_counts() == before  # CPU tensors never count a launch
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qk_norm", [True, False])
def test_cross_attention_matches_jax(qk_norm):
    c, heads, tx, ty = 128, 2, 300, 170
    tree = _perturb(init_cross_block_params(6, c, heads, 4, qk_norm, None), 7)
    x, y = _inputs(8, 2, tx, ty, c)
    xpos, ypos = _positions(2, tx), _positions(2, ty)
    want = jax_cross.cross_attention(jnp.asarray(x), jnp.asarray(y), jnp.asarray(y),
                                     _jax(tree["cross_attn"]), heads, qpos=xpos, kpos=ypos)
    blk = build_cross_block(cross_block_state_from_jax(tree), heads, torch.device("cpu"),
                            torch.float32)
    qrope = rope_tables(torch.from_numpy(np.array(xpos)), c // heads)
    krope = rope_tables(torch.from_numpy(np.array(ypos)), c // heads)
    yt = torch.from_numpy(y)
    with torch.no_grad():
        got = cross_attention(torch.from_numpy(x), yt, yt, blk.cross_attn, qrope, krope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _single_block(seed, c, heads, qk_norm, layerscale):
    """One block's JAX params (unstacked) and the port's Block holding them."""
    stacked = _perturb(_init_block_stack(seed, 1, c, 4, qk_norm, layerscale, heads), seed + 1)
    params = {k: v[0] for k, v in stacked.items()}
    state = {name: torch.from_numpy(np.ascontiguousarray(
        params[leaf].T if leaf.endswith("_kernel") else params[leaf]))
        for leaf, name in _BLOCK_LEAVES.items() if leaf in params}
    blk = Block(c, heads, 4, qk_norm=qk_norm, layerscale=layerscale is not None)
    blk.load_state_dict(state, strict=True)
    return params, blk.eval()


@pytest.mark.parametrize(
    "c,heads,qk_norm,layerscale,with_rope",
    [
        (96, 3, True, 0.01, True),   # unpacked (3 heads of 32), fallback MLP half (C 96)
        (96, 3, False, None, False),  # unpacked, no qk-norm, no RoPE
        (256, 2, True, 0.01, True),  # unpacked at head dim 128, fused MLP half
        (320, 5, True, 0.01, True),  # packed (5 heads of 64), fallback MLP half (C 320)
    ],
)
def test_block_routes_match_jax(c, heads, qk_norm, layerscale, with_rope):
    b, t = 2, 130
    params, blk = _single_block(11, c, heads, qk_norm, layerscale)
    x = np.random.default_rng(12).normal(size=(b, t, c)).astype(np.float32)
    pos = _positions(b, t) if with_rope else None
    want_attn = jax_layers.attention(jnp.asarray(x), _jax(params), heads, positions=pos)
    want = jax_layers.block(jnp.asarray(x), _jax(params), heads, positions=pos)
    rope = rope_tables(torch.from_numpy(np.array(pos)), c // heads) if with_rope else None
    with torch.no_grad():
        got_attn = attention(torch.from_numpy(x), blk, rope)
        got = blk(torch.from_numpy(x), rope=rope)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("qk_norm,layerscale", [(True, 0.01), (False, None)])
def test_cross_block_state_round_trip(qk_norm, layerscale):
    """Every JAX leaf lands in the module once (kernels transposed), and the
    module's state dict is the converted one."""
    c, heads = 128, 2
    tree = init_cross_block_params(0, c, heads, 4, qk_norm, layerscale)
    state = cross_block_state_from_jax(tree)
    blk = build_cross_block(state, heads, torch.device("cpu"), torch.float32)
    assert blk.attn.q_norm is not None if qk_norm else blk.attn.q_norm is None
    assert (blk.ls1 is not None) == (layerscale is not None)
    got = blk.state_dict()
    assert set(got) == set(state)
    for name, value in state.items():
        np.testing.assert_array_equal(got[name].numpy(), value.numpy())
    leaves = jax.tree.leaves(tree)
    assert len(leaves) == len(state)
    np.testing.assert_array_equal(state["cross_attn.k_proj.weight"].numpy(),
                                  tree["cross_attn"]["k_kernel"].T)
    np.testing.assert_array_equal(state["attn.qkv.weight"].numpy(),
                                  tree["self_attn"]["qkv_kernel"].T)
    np.testing.assert_array_equal(state["mlp.fc2.bias"].numpy(), tree["mlp"]["fc2_bias"])
    np.testing.assert_array_equal(state["norm_y.weight"].numpy(), tree["norm_y_scale"])
    # same seed, same tree
    again = init_cross_block_params(0, c, heads, 4, qk_norm, layerscale)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, jax.tree.leaves(again)))


def test_cross_block_positions_are_the_pi3_frame_layout():
    """make_patch_positions of the port and the JAX package agree (the
    cross block's RoPE positions in chip_smoke.py)."""
    want = np.asarray(jax_positions(4, 22, 29, num_special=5, offset=1))
    got = make_patch_positions(4, 22, 29, num_special=5, offset=1).numpy()
    np.testing.assert_array_equal(got, want)
