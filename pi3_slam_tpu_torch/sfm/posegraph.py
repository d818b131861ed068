"""Sim3 pose-graph optimisation for loop closure.

Port of ``pi3_slam_tpu/sfm/posegraph.py``. When a loop edge relates two
non-adjacent chunks, one similarity correction per chunk spreads the
accumulated error over the chain: Gauss-Newton over the per-node retraction
X_n <- X_n o exp(xi_n), one dense 7N x 7N solve per step. Residuals are
chordal, entries of (M^-1 X_i^-1 X_j) minus the identity. The JAX version
takes the Jacobian by ``jax.jacfwd`` through ``sim3_exp`` at zero; here it is
that derivative in closed form (:func:`_edge_jacobians`): ``torch.func``'s
first call in a process costs seconds, and its per-tangent kernels
thousands of launches a solve. Everything runs in fp32 on ``device``, the card by default (TF32 off:
``device.select_device``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..geometry.sim3 import Sim3, sim3_compose, sim3_exp, sim3_identity, sim3_inverse, sim3_matrix


def stack_sim3(transforms: Sequence[Sim3]) -> Sim3:
    """A list of Sim3 -> one batched Sim3 with leading axis N."""
    return Sim3(torch.stack([torch.as_tensor(t.scale) for t in transforms]),
                torch.stack([torch.as_tensor(t.rotation) for t in transforms]),
                torch.stack([torch.as_tensor(t.translation) for t in transforms]))


def index_sim3(batched: Sim3, idx) -> Sim3:
    return Sim3(batched.scale[idx], batched.rotation[idx], batched.translation[idx])


@dataclasses.dataclass
class PoseGraphResult:
    nodes: Sim3  # batched (N,) corrections
    initial_cost: float
    final_cost: float
    iterations: int


def _edge_residuals(nodes: Sim3, edges_i: torch.Tensor, edges_j: torch.Tensor, meas_inv: Sim3,
                    translation_weight: float) -> torch.Tensor:
    """Chordal residuals (E, 12): the rows of (s R - I) and the weighted t of
    err = meas^-1 o X_i^-1 o X_j (the identity where the constraint holds)."""
    err = sim3_compose(meas_inv, sim3_compose(sim3_inverse(index_sim3(nodes, edges_i)),
                                              index_sim3(nodes, edges_j)))
    eye = torch.eye(3, dtype=err.rotation.dtype, device=err.rotation.device)
    sr = err.scale[..., None, None] * err.rotation - eye
    return torch.cat([sr.reshape(sr.shape[:-2] + (9,)), translation_weight * err.translation],
                     dim=-1)


def _generators(dtype, device) -> torch.Tensor:
    """(7, 4, 4) derivatives of the 4 x 4 matrix of sim3_exp(xi) at xi = 0
    along [rho(3), phi(3), sigma]: the algebra's basis."""
    g = torch.zeros(7, 4, 4, dtype=dtype, device=device)
    for k in range(3):
        g[k, k, 3] = 1.0  # rho: translation
    g[3, 2, 1], g[3, 1, 2] = 1.0, -1.0  # phi: skew(e_k)
    g[4, 0, 2], g[4, 2, 0] = 1.0, -1.0
    g[5, 1, 0], g[5, 0, 1] = 1.0, -1.0
    g[6, 0, 0] = g[6, 1, 1] = g[6, 2, 2] = 1.0  # sigma: scale
    return g


def _edge_jacobians(nodes: Sim3, edges_i: torch.Tensor, edges_j: torch.Tensor, meas_inv: Sim3,
                    translation_weight: float):
    """d r_e / d xi_i and d r_e / d xi_j, each (E, 12, 7), of
    :func:`_edge_residuals` under X_k <- X_k o exp(xi_k) at xi = 0. With
    A = X_i^-1 X_j and G the generator of xi: d(M^-1 E_i^-1 A E_j) =
    M^-1 (A G_j - G_i A), read off as the residual's entries."""
    xi, xj = index_sim3(nodes, edges_i), index_sim3(nodes, edges_j)
    a = sim3_matrix(sim3_compose(sim3_inverse(xi), xj))
    m = sim3_matrix(meas_inv)
    g = _generators(a.dtype, a.device)
    d_j = torch.einsum("eab,kbc->ekac", m @ a, g)
    d_i = -torch.einsum("eab,kbc,ecd->ekad", m, g, a)

    def as_residual(d):  # (E, 7, 4, 4) -> (E, 12, 7)
        top = torch.cat([d[:, :, :3, :3].reshape(d.shape[0], 7, 9),
                         translation_weight * d[:, :, :3, 3]], dim=-1)
        return top.transpose(1, 2)

    return as_residual(d_i), as_residual(d_j)


def _f32(s: Sim3, device) -> Sim3:
    return Sim3(*(torch.as_tensor(x, dtype=torch.float32).to(device) for x in s))


def optimize_sim3_pose_graph(
    nodes_init: Sim3,
    edges_i,
    edges_j,
    measurements: Sim3,
    edge_weights=None,
    *,
    iterations: int = 15,
    huber_delta: float = 0.5,
    translation_weight: float = 1.0,
    damping: float = 1e-8,
    fixed_node: int = 0,
    device="cuda",
) -> PoseGraphResult:
    """Gauss-Newton over per-node Sim3 corrections on ``device``.

    Edge (i, j) with measurement M constrains X_i^-1 o X_j = M. The gauge is
    fixed by a stiff 1e8 diagonal on node ``fixed_node``; Huber IRLS weights
    on the per-edge residual norms guard against a bad loop edge.
    ``initial_cost`` is the first step's cost."""
    dev = torch.device(device)
    n = int(nodes_init.scale.shape[0])
    edges_i = torch.as_tensor(np.asarray(edges_i), dtype=torch.long).to(dev)
    edges_j = torch.as_tensor(np.asarray(edges_j), dtype=torch.long).to(dev)
    e = int(edges_i.shape[0])
    w_edge = (torch.ones(e, dtype=torch.float32, device=dev) if edge_weights is None
              else torch.as_tensor(np.asarray(edge_weights), dtype=torch.float32).to(dev))
    meas_inv = sim3_inverse(_f32(measurements, dev))
    gauge = torch.zeros(n * 7, dtype=torch.float32, device=dev)
    gauge[fixed_node * 7:fixed_node * 7 + 7] = 1e8

    def residuals(nodes):
        return _edge_residuals(nodes, edges_i, edges_j, meas_inv, translation_weight)

    def cost_of(r):  # Huber cost of the per-edge residual norms
        rn = torch.linalg.vector_norm(r, dim=-1)
        quad = 0.5 * rn * rn
        lin = huber_delta * (rn - 0.5 * huber_delta)
        return (w_edge * torch.where(rn <= huber_delta, quad, lin)).sum()

    nodes = _f32(nodes_init, dev)
    costs = []
    rows = torch.arange(e, device=dev)
    for _ in range(iterations):
        r0 = residuals(nodes)
        rn = torch.linalg.vector_norm(r0, dim=-1)
        w_huber = torch.where(rn <= huber_delta, torch.ones_like(rn),
                              huber_delta / rn.clamp_min(1e-12))
        w_row = (w_edge * w_huber).repeat_interleave(12)
        d_i, d_j = _edge_jacobians(nodes, edges_i, edges_j, meas_inv, translation_weight)
        jac = torch.zeros(e, 12, n, 7, dtype=torch.float32, device=dev)
        jac[rows, :, edges_i] = d_i
        jac[rows, :, edges_j] = d_j
        jac = jac.reshape(e * 12, n * 7)
        jtw = jac.T * w_row[None, :]
        h = jtw @ jac
        h = h + torch.diag(gauge + damping * torch.diagonal(h).clamp_min(1.0))
        g = jtw @ r0.reshape(-1)
        delta = -torch.linalg.solve(h, g)
        nodes = sim3_compose(nodes, sim3_exp(delta.reshape(n, 7)))
        costs.append(cost_of(r0))
    final_cost = cost_of(residuals(nodes))
    return PoseGraphResult(nodes=nodes, initial_cost=float(costs[0]),
                           final_cost=float(final_cost), iterations=iterations)


def sequential_edges(num_nodes: int) -> Tuple[np.ndarray, np.ndarray, List[Sim3]]:
    """Identity-measurement odometry edges (i, i + 1): consecutive chunks are
    already stitched by the overlap alignment, so the graph keeps their
    relative placement while it absorbs the loop error."""
    i = np.arange(num_nodes - 1, dtype=np.int32)
    return i, i + 1, [sim3_identity() for _ in range(num_nodes - 1)]
