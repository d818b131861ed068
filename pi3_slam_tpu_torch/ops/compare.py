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


# Per-kernel bounds for the hand-written kernels against their plain versions
# in bf16. The producer's outputs are the same fp32 arithmetic in another
# order, rounded to bf16: at most 1 ulp apart per element, which is <= 2^-7
# of its magnitude. Check q, k and v apart (q is prescaled by D^-1/2 log2(e)).
PRODUCER = dict(max_rel=2.0**-7, l2_rel=1e-2)
# Attention rounds P to bf16 for the PV product (2^-9 relative per term) and
# both versions round the output to bf16.
ATTENTION = dict(max_rel=2.0**-6, l2_rel=1e-2)


def block_mlp_bounds(x: torch.Tensor, out_ref: torch.Tensor) -> dict:
    """Bounds on the branch out - x, since x would dominate max |out|. The
    plain version rounds the fc1 and fc2 outputs to bf16 where the kernel
    keeps fp32, and both round x + branch to bf16, which can put them one ulp
    of |out| (<= 2^-7 max |out|) apart."""
    return dict(max_rel=2.0**-6, l2_rel=2e-2, atol=2.0**-7 * out_ref.float().abs().max().item(),
                base=x)
