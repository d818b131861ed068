"""The port's transformer MLP (pi3_slam_tpu_torch/ops/mlp.py) against the JAX
package, on the CPU.

``mlp`` on a CPU tensor runs ``mlp_plain``, the plain version the
hand-written kernel (``csrc/block_mlp.cu``, entry ``pi3_mlp``) is held to on
the card. Here it is held to the Pallas ``mlp_fused_tpu`` in interpret mode at
the sizes of tests/test_pallas_mlp.py, and to ``models.layers.mlp``, in fp32:
atol 2e-5 and rtol 1e-5 (tests/test_pallas_mlp.py's own).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pi3_slam_tpu.models.layers import mlp as jax_mlp
from pi3_slam_tpu.ops.pallas_mlp import mlp_fused_tpu

from pi3_slam_tpu_torch.ops import launch_counts
from pi3_slam_tpu_torch.ops.block_mlp import check_kernel_operands
from pi3_slam_tpu_torch.ops.compare import MLP, compare
from pi3_slam_tpu_torch.ops.mlp import mlp, mlp_kernel_supported, mlp_plain
from pi3_slam_tpu_torch.tools import perf_lab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(rng, c, hidden):
    """JAX layout: kernels (in, out)."""
    return {
        "fc1_kernel": (rng.normal(size=(c, hidden)) * 0.05).astype(np.float32),
        "fc1_bias": (rng.normal(size=(hidden,)) * 0.1).astype(np.float32),
        "fc2_kernel": (rng.normal(size=(hidden, c)) * 0.05).astype(np.float32),
        "fc2_bias": (rng.normal(size=(c,)) * 0.1).astype(np.float32),
    }


def _torch_args(p):
    return (torch.from_numpy(p["fc1_kernel"].T.copy()), torch.from_numpy(p["fc1_bias"]),
            torch.from_numpy(p["fc2_kernel"].T.copy()), torch.from_numpy(p["fc2_bias"]))


@pytest.mark.parametrize("t,c,hidden,blk", [(300, 256, 1024, 128), (512, 128, 512, 256)])
def test_mlp_matches_pallas_and_layers_mlp(rng, t, c, hidden, blk):
    p = _params(rng, c, hidden)
    x = (rng.normal(size=(2, t, c)) * 0.5).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = mlp_fused_tpu(jnp.asarray(x), jp["fc1_kernel"], jp["fc1_bias"], jp["fc2_kernel"],
                         jp["fc2_bias"], blk_rows=blk, interpret=True)
    before = launch_counts()
    got = mlp(torch.from_numpy(x), *_torch_args(p))
    assert launch_counts() == before  # CPU tensors never count a launch
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mlp(jnp.asarray(x), jp)),
                               atol=2e-5, rtol=1e-5)


def test_mlp_outside_the_kernel_widths_matches_layers_mlp(rng):
    """C = 320 (not a multiple of 128): the card runs the plain matmuls too."""
    c, hidden = 320, 1280
    assert not mlp_kernel_supported(c, hidden)
    p = _params(rng, c, hidden)
    x = rng.normal(size=(3, 50, c)).astype(np.float32)
    want = jax_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    np.testing.assert_allclose(mlp(torch.from_numpy(x), *_torch_args(p)).numpy(),
                               np.asarray(want), atol=2e-5, rtol=1e-5)


def test_mlp_refuses_mismatched_weights():
    x = torch.zeros(2, 5, 128)
    with pytest.raises(ValueError):
        mlp(x, torch.zeros(512, 128), torch.zeros(512), torch.zeros(512, 128), torch.zeros(128))


def test_chip_bounds_pass_kernel_arithmetic_and_reject_wrong_outputs(rng):
    """The bounds chip_smoke.py and the GPU tests hold the kernel to accept
    its bf16 arithmetic (fp32 products of bf16 operands, fp32 biases and
    GELU, the GELU output stored in bf16; simulated here) and fail an
    all-zero and a 10%-off output."""
    bf16 = torch.bfloat16
    c, hidden = 256, 1024
    x = torch.from_numpy(rng.normal(size=(1, 500, c)).astype(np.float32)).to(bf16)
    w1, b1, w2, b2 = (a.to(bf16) for a in _torch_args(_params(rng, c, hidden)))
    h = torch.nn.functional.gelu(x.float() @ w1.float().T + b1.float()).to(bf16)
    got = (h.float() @ w2.float().T + b2.float()).to(bf16)
    ref = mlp_plain(x, w1, b1, w2, b2)
    cmp = compare(got, ref, **MLP)
    assert cmp.ok and cmp.rejects_wrong, cmp
    assert not compare(torch.zeros_like(ref), ref, **MLP).ok
    assert not compare(1.1 * ref.float(), ref, **MLP).ok


def _operands(case):
    """(x, fc1 weight, fc2 weight) in bf16 at C 128 / hidden 512, with one
    thing the GEMM kernel does not take (or none)."""
    bf16 = torch.bfloat16
    c, hidden = (320, 1280) if case == "C not a multiple of 128" else (128, 512)
    x = torch.zeros(2, 7, c, dtype=bf16)
    w1, w2 = torch.zeros(hidden, c, dtype=bf16), torch.zeros(c, hidden, dtype=bf16)
    if case == "fp32 x":
        x = x.float()
    elif case == "x 2 bytes off 16":
        x = torch.zeros(14 * c + 1, dtype=bf16)[1:].view(2, 7, c)
    elif case == "x not contiguous":
        x = torch.zeros(2, 7, 2 * c, dtype=bf16)[..., :c]
    elif case == "fc1 weight 2 bytes off 16":
        w1 = torch.zeros(hidden * c + 1, dtype=bf16)[1:].view(hidden, c)
    elif case == "fc2 weight transposed":
        w2 = torch.zeros(hidden, c, dtype=bf16)
    return x, w1, w2


@pytest.mark.parametrize("case,error", [
    ("fp32 x", TypeError),
    ("C not a multiple of 128", ValueError),
    ("x 2 bytes off 16", ValueError),
    ("x not contiguous", ValueError),
    ("fc1 weight 2 bytes off 16", ValueError),
    ("fc2 weight transposed", ValueError),
])
def test_gemm_operand_checks_refuse_what_the_tensor_maps_cannot_take(case, error):
    """The checks both MLP wrappers run on CUDA operands before launching
    csrc/block_mlp.cu (its GEMMs read x and the weights through TMA tensor
    maps: 16-byte aligned bases, rows a multiple of 16 bytes); here on CPU
    tensors of the same shapes and strides."""
    x, w1, w2 = _operands(case)
    with pytest.raises(error):
        check_kernel_operands(x, w1, w2, "mlp")


def test_gemm_operand_checks_take_the_main_path_operands():
    x, w1, w2 = _operands("none")
    check_kernel_operands(x, w1, w2, "mlp")
    # the first rows of a longer buffer, as the NaN-past-M checks pass them
    check_kernel_operands(torch.zeros(1, 50, 128, dtype=torch.bfloat16)[:, :7], w1, w2, "mlp")


@pytest.mark.parametrize("case,error", [
    ("fp32 operands", None),
    ("fp32 x, first rows of a longer buffer", None),
    ("fp16 operands", TypeError),
    ("fp32 x, bf16 weights", TypeError),
    ("fp32 x 4 bytes off 16", ValueError),
])
def test_gemm_operand_checks_take_fp32_and_refuse_fp16(case, error):
    """The fp32 entries (pi3_block_mlp_f32, pi3_mlp_f32) take fp32 x with
    fp32 weights of the same rules (contiguous, 16-byte aligned bases: their
    cp.async loads); fp16 has no entry, and mixed dtypes are refused."""
    c, hidden = 128, 512
    dtype = torch.float16 if case.startswith("fp16") else torch.float32
    x = torch.zeros(2, 7, c, dtype=dtype)
    w1, w2 = torch.zeros(hidden, c, dtype=dtype), torch.zeros(c, hidden, dtype=dtype)
    if case == "fp32 x, first rows of a longer buffer":
        x = torch.zeros(1, 50, c)[:, :7]
    elif case == "fp32 x, bf16 weights":
        w1, w2 = w1.bfloat16(), w2.bfloat16()
    elif case == "fp32 x 4 bytes off 16":
        x = torch.zeros(14 * c + 1)[1:].view(2, 7, c)
    if error is None:
        assert check_kernel_operands(x, w1, w2, "mlp") is True  # the fp32 entry
    else:
        with pytest.raises(error):
            check_kernel_operands(x, w1, w2, "mlp")


def test_mlp_probe_needs_a_gpu():
    """``python -m pi3_slam_tpu_torch.tools.perf_lab mlp`` times the GEMM
    entries on the card only: without one it fails and prints no time."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the probe runs")
    with pytest.raises(RuntimeError, match="GPU"):
        perf_lab.bench_mlp()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "pi3_slam_tpu_torch.tools.perf_lab", "mlp"],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr and "ms" not in proc.stdout


@pytest.mark.parametrize("value,truncate,rna,rne", [
    (1 + 2**-12, 1.0, 1.0, 1.0),                               # a quarter TF32 ulp
    (1 + 2**-11, 1.0, 1 + 2**-10, 1.0),                        # a tie, even below
    (1 + 2**-10 + 2**-11, 1 + 2**-10, 1 + 2**-9, 1 + 2**-9),   # a tie, odd below
    (1 + 2**-11 + 2**-23, 1.0, 1 + 2**-10, 1 + 2**-10),        # just above a tie
])
def test_tf32_probe_roundings(value, truncate, rna, rne):
    """``perf_lab tf32`` tells the tensor cores' read of an fp32 pattern by
    comparing it with these three TF32 roundings (10 mantissa bits); the
    probe itself needs the card."""
    x = torch.tensor([value], dtype=torch.float32)
    for rounding, want in (("truncate", truncate), ("rna", rna), ("rne", rne)):
        assert perf_lab._tf32_bits(x, rounding).item() == want, rounding
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            perf_lab.bench_tf32()
