"""Sim(3) pose-graph optimization (port of lpslam_tpu/loop/pose_graph.py).

State: (K, 7) Sim3 tangent deltas around the current estimates. Edge
residual r = log(S_ij · S_j · S_i⁻¹). Jacobians by forward-mode autodiff
through the sim3 exp/log chain (``torch.func.jacfwd``); Gauss-Newton blocks
are summed into a dense (7K, 7K) system and solved with one
``torch.linalg.solve`` per iteration.

JAX takes one ``jacfwd`` per edge under ``vmap``. Here one ``jacfwd``
differentiates all E residuals at once with respect to a single (7,)
perturbation shared by every edge: residual e depends only on its own copy,
so the (E, 7, 7) result is the per-edge Jacobian. Besides being one batched
evaluation, this keeps every tensor batched: under ``vmap`` the per-edge
scalars are 0-d, and torch's forward-mode ``where`` on 0-d operands returns
float64 tangents (torch 2.13), which breaks the float32 chain.

JAX's ``H.at[ei, :, ej, :].add`` sums duplicate edges. Indexed ``+=`` in
torch does not (the last write wins), so the blocks are summed by cell of
a (K*K, 7, 7) view with ``kernels.linalg.segment_sum``: the four blocks of
every edge (ii, jj, ij, ij^T) and b's two are concatenated in that order
and summed in it, over one sort per solve. That is the order of one
``index_add_`` per block on the CPU, and it repeats bit for bit on the
card, where ``index_add_``'s float atomics do not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..geometry.sim3 import Sim3, sim3_compose, sim3_exp, sim3_inverse, sim3_log
from ..kernels.linalg import segment_plan, segment_sum


class PoseGraphProblem(NamedTuple):
    """Fixed-capacity pose-graph problem (see the JAX docstring).

    node_R/t/s: (K, ...) Sim3 estimates (world->kf); edge_i/j: (E,) int
    node indices; edge_R/t/s: (E, ...) measured S_ij = S_i ∘ S_j⁻¹;
    edge_weight: (E,) (0 = padding); node_fixed: (K,) bool gauge anchors.
    """

    node_R: torch.Tensor
    node_t: torch.Tensor
    node_s: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_R: torch.Tensor
    edge_t: torch.Tensor
    edge_s: torch.Tensor
    edge_weight: torch.Tensor
    node_fixed: torch.Tensor


def _edge_residual(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Residual of one edge with tangent perturbations xi on both nodes:
    S_i' = exp(xi_i) ∘ S_i, r = log(S_m ∘ S_j' ∘ S_i'⁻¹)."""
    Si = sim3_compose(sim3_exp(xi_i), Sim3(Ri, ti, si))
    Sj = sim3_compose(sim3_exp(xi_j), Sim3(Rj, tj, sj))
    return sim3_log(sim3_compose(Sim3(Rm, tm, sm), sim3_compose(Sj, sim3_inverse(Si))))


def _res_and_jac(*edges):
    """Residuals (E, 7) and Jacobians (E, 7, 7) with respect to the
    perturbations of node i and node j of every edge, at zero."""
    E = edges[0].shape[0]
    z = torch.zeros(7, dtype=edges[0].dtype, device=edges[0].device)

    def shared(xi_i, xi_j):
        return _edge_residual(xi_i.expand(E, 7), xi_j.expand(E, 7), *edges)

    Ji, Jj = jacfwd(shared, argnums=(0, 1))(z, z)
    return shared(z, z), Ji, Jj


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 10, damping: float = 1e-4):
    """Gauss-Newton over the Sim3 pose graph. Returns (R, t, s, costs)."""
    K = prob.node_R.shape[0]
    dev = prob.node_R.device
    ei = prob.edge_i.to(torch.int64)
    ej = prob.edge_j.to(torch.int64)
    w = prob.edge_weight
    fixed = torch.repeat_interleave(prob.node_fixed, 7)
    eye = torch.eye(7 * K, dtype=prob.node_R.dtype, device=dev)
    R, t, s = prob.node_R, prob.node_t, prob.node_s
    plan_H = segment_plan(torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),
                          K * K)
    plan_b = segment_plan(torch.cat([ei, ej]), K)
    costs = []
    for _ in range(iters):
        r, Ji, Jj = _res_and_jac(
            R[ei], t[ei], s[ei], R[ej], t[ej], s[ej],
            prob.edge_R, prob.edge_t, prob.edge_s,
        )  # (E,7), (E,7,7), (E,7,7)
        Hii = torch.einsum("eki,e,ekj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eki,e,ekj->eij", Jj, w, Jj)
        Hij = torch.einsum("eki,e,ekj->eij", Ji, w, Jj)
        bi = torch.einsum("eki,e,ek->ei", Ji, w, r)
        bj = torch.einsum("eki,e,ek->ei", Jj, w, r)
        H = segment_sum(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]), plan_H)
        b = segment_sum(torch.cat([bi, bj]), plan_b)

        Hm = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hm = torch.where(fixed[:, None] | fixed[None, :], eye, Hm + damping * eye)
        bv = torch.where(fixed, 0.0, b.reshape(-1))
        dx = -torch.linalg.solve(Hm, bv).reshape(K, 7)
        dx = torch.where(prob.node_fixed[:, None], 0.0, dx)
        R, t, s = sim3_compose(sim3_exp(dx), Sim3(R, t, s))
        costs.append(torch.sum(w * torch.sum(r * r, -1)))
    return R, t, s, torch.stack(costs)
