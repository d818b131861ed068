"""Kernel-against-plain comparison with bounds that scale with the reference.

``compare(got, ref, max_rel, l2_rel)`` passes when ``got`` is finite and

    max |got - ref|   <= max_rel * max |ref| + atol
    ||got - ref||_2   <= l2_rel * ||ref||_2

after subtracting a common ``base`` from both where one is given (a block's
residual input, so that the bounds see the branch and not the residual).

A bound scaled by an input instead (say max |v| for attention) can exceed
the output's own magnitude, and then a kernel that returns zeros passes. So
each comparison also says whether each bound, on its own, rejects the two
wrong outputs every check must fail: all zeros (error = ref) and the
reference off by 10% (error = 0.1 * ref).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Comparison:
    max_abs_err: float
    max_tol: float
    rel_l2: float
    l2_tol: float
    finite: bool
    rejects_wrong: bool

    @property
    def ok(self) -> bool:
        return self.finite and self.max_abs_err <= self.max_tol and self.rel_l2 <= self.l2_tol

    def __str__(self) -> str:
        return (f"max|err| {self.max_abs_err:.3e} <= {self.max_tol:.3e}, "
                f"rel L2 {self.rel_l2:.3e} <= {self.l2_tol:.0e}")


def compare(
    got: torch.Tensor,
    ref: torch.Tensor,
    max_rel: float,
    l2_rel: float = 1e-2,
    atol: float = 0.0,
    base: torch.Tensor | None = None,
) -> Comparison:
    if got.shape != ref.shape:
        raise ValueError(f"shape {tuple(got.shape)} != reference {tuple(ref.shape)}")
    got, ref = got.float(), ref.float()
    if base is not None:
        got, ref = got - base.float(), ref - base.float()
    finite = bool(torch.isfinite(got).all())
    diff = got - ref
    err = diff.abs().max().item()
    ref_max = ref.abs().max().item()
    err_l2 = torch.linalg.vector_norm(diff).item()
    ref_l2 = torch.linalg.vector_norm(ref).item()
    if ref_l2 > 0:
        rel_l2 = err_l2 / ref_l2
    else:
        rel_l2 = 0.0 if err_l2 == 0 else float("inf")
    max_tol = max_rel * ref_max + atol
    # zeros miss by max|ref| and rel L2 1; 1.1 * ref by 0.1 of each
    rejects = ref_max > 0 and 0.1 * ref_max > max_tol and 0.1 > l2_rel
    return Comparison(err, max_tol, rel_l2, l2_rel, finite, rejects)


def hold(name: str, shape: str, got: torch.Tensor, ref: torch.Tensor, why: str,
         **bounds) -> Comparison:
    """A kernel's output against its plain version's (:func:`compare` with
    ``bounds``), printed on one line; raises if the bounds would pass an
    all-zero or a 10%-off output, or if the kernel misses them."""
    c = compare(got, ref, **bounds)
    print(f"  {name:32s} {shape:28s} {c} ({why}) {'ok' if c.ok else 'FAIL'}", flush=True)
    if not c.rejects_wrong:
        raise RuntimeError(f"{name} {shape}: the bounds would pass a zero or 10%-off output")
    if not c.ok:
        raise RuntimeError(f"{name} {shape}: kernel disagrees with its plain version ({c})")
    return c


# Per-kernel bounds for the hand-written kernels against their plain versions
# in bf16. The producer's outputs are the same fp32 arithmetic in another
# order, rounded to bf16: at most 1 ulp apart per element, which is <= 2^-7
# of its magnitude. Check q, k and v apart (q is prescaled by D^-1/2 log2(e)).
PRODUCER = dict(max_rel=2.0**-7, l2_rel=1e-2)
# Attention rounds P to bf16 for the PV product (2^-9 relative per term) and
# both versions round the output to bf16.
ATTENTION = dict(max_rel=2.0**-6, l2_rel=1e-2)
# Dots-only attention: both versions round the fp32 logits and the output to
# bf16; fp32 sums in another order can put one logit's rounding one bf16 ulp
# (2^-8 of it) apart, and cuBLAS may reduce the plain version's long (T-deep)
# second product in split-K partial sums of the input dtype.
DOTS = dict(max_rel=2.0**-6, l2_rel=1e-2)
# The bare MLP fc2(GELU(fc1 x)): the plain version rounds the fc1 output to
# bf16 before the GELU and adds the fc2 bias in bf16 where the kernel keeps
# fp32 (block_mlp_bounds' reason, without a residual to subtract).
MLP = dict(max_rel=2.0**-6, l2_rel=2e-2)
# The fp32 entries (3xTF32 products on the tensor cores, everything else in
# fp32) against their fp32 plain versions (cuBLAS fp32 with TF32 off, or
# elementwise torch): the same fp32 arithmetic in another order, with each
# 3xTF32 product ~2^-22 of its size off (the dropped small x small term;
# ~2^-20 where big is x truncated to TF32, as in the wgmma GEMM), so
# relative L2 1e-5 and max |err| 1e-4 of max |ref|. The bf16 entries' output
# misses by bf16's 2^-9 rounding alone (~2e-3 of max |ref| at the largest
# entry, relative L2 ~1e-3): each bound rejects it, which chip_smoke.py and
# the GPU tests show on the same inputs. Attention, the partial sums (acc and
# l) and the producer (q, k and v apart) take these.
FP32 = dict(max_rel=1e-4, l2_rel=1e-5)
# The partial attention's denominator l: fp32 sums of the same unrounded
# terms in another order, with logits (and so exp2) that differ by fp32
# rounding of the q.k products; its acc and normalised output take ATTENTION.
PARTIAL_L = dict(max_rel=1e-3, l2_rel=1e-3)


def block_mlp_bounds(x: torch.Tensor, out_ref: torch.Tensor) -> dict:
    """Bounds on the branch out - x, since x would dominate max |out|. In
    bf16 the plain version rounds the fc1 and fc2 outputs to bf16 where the
    kernel keeps fp32, and both round x + branch to bf16, which can put them
    one ulp of |out| (<= 2^-7 max |out|) apart. In fp32 (the fp32 entry) the
    FP32 bounds, with x + branch rounded to fp32 (<= 2^-23 max |out| apart;
    2^-20 allowed)."""
    out_max = out_ref.float().abs().max().item()
    if out_ref.dtype == torch.float32:
        return dict(FP32, atol=2.0**-20 * out_max, base=x)
    return dict(max_rel=2.0**-6, l2_rel=2e-2, atol=2.0**-7 * out_max, base=x)
