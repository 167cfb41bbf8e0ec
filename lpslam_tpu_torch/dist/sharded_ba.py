"""Distributed bundle adjustment: Schur blocks reduced over the mesh (port
of lpslam_tpu/dist/sharded_ba.py).

The observations are sharded along the keypoint-slot axis. Every rank
builds the normal-equation partials of its slots (the per-camera 6x6
blocks, the per-landmark 3x3 blocks, the camera-point coupling), one
all-reduce sums them, and every rank solves the small reduced camera
system and back-substitutes the points itself. One LM iteration is

    local blocks -> all_reduce(Hcc, bc, Hpp, bp, Hcp, cost)
    -> replicated Schur solve -> replicated point back-substitution

compute where the observations live, reduce only normal-equation blocks.
Every rank takes the same full problem and returns the same result.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..backend.ba import BAProblem, BAResult, CHI2_2D
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3, se3_compose, se3_exp
from ..kernels.linalg import inv3x3_guarded, segment_plan, segment_sum
from .mesh import Mesh, make_mesh
from .sharded_map import _accept, _local_obs_blocks, _masked_cost


def _local_blocks(cam, R, t, points, obs_lm, obs_uv, obs_sigma2, cam_fixed,
                  point_valid, gate, plan):
    """This rank's normal-equation partials: Hcc (C,6,6), bc (C,6), Hpp
    (P,3,3), bp (P,3), Hcp (C,P,6,3), cost, and the active observations.
    ``plan``: the segment plan of the slots' landmarks (fixed per solve)."""
    C, Nl = obs_lm.shape
    Pn = points.shape[0]
    Hcc, bc, JpTJp, bp_terms, JcTJp, cost, n_active = _local_obs_blocks(
        cam, R, t, points, obs_lm, obs_uv, obs_sigma2, cam_fixed, gate, point_valid)
    flat_lm = torch.clamp(obs_lm, min=0).to(torch.int64).reshape(-1)
    dt, dev = points.dtype, points.device
    Hpp = segment_sum(JpTJp.reshape(-1, 3, 3), plan)
    bp = segment_sum(bp_terms.reshape(-1, 3), plan)
    cam_rows = torch.arange(C, device=dev)[:, None].expand(C, Nl).reshape(-1)
    Hcp = torch.zeros((C, Pn, 6, 3), dtype=dt, device=dev).index_put_(
        (cam_rows, flat_lm), JcTJp.reshape(-1, 6, 3), accumulate=True)
    return Hcc, bc, Hpp, bp, Hcp, cost, n_active


def _dba_impl(prob: BAProblem, cam: PinholeCamera, iters: int, mesh: Mesh) -> BAResult:
    C, N = prob.obs_lm.shape
    Pn = prob.points.shape[0]
    dev, dt = prob.points.device, prob.points.dtype
    sl = mesh.block(N)
    obs_lm, obs_uv, obs_sigma2 = prob.obs_lm[:, sl], prob.obs_uv[:, sl], prob.obs_sigma2[:, sl]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6c = torch.eye(6 * C, dtype=dt, device=dev)
    fixed_diag = torch.repeat_interleave(prob.cam_fixed, 6)
    plan = segment_plan(obs_lm, Pn)

    def one_iteration(R, t, points, lam, gate_full):
        parts = _local_blocks(cam, R, t, points, obs_lm, obs_uv, obs_sigma2, prob.cam_fixed,
                              prob.point_valid, gate_full[:, sl], plan)
        # the compact normal-equation reduction: one all-reduce of every block
        red = mesh.all_reduce(torch.cat([x.reshape(-1) for x in parts]))
        Hcc, bc, Hpp, bp, Hcp, cost, n_active = (
            y.reshape(x.shape) for x, y in zip(parts, torch.split(red, [x.numel() for x in parts])))

        # the replicated Schur solve (backend.ba's math)
        Hpp_inv = inv3x3_guarded(Hpp + (lam + 1e-8) * eye3)
        X = torch.einsum("apij,pjk->apik", Hcp, Hpp_inv)                  # (C,P,6,3)
        Xr = X.permute(0, 2, 1, 3).reshape(6 * C, 3 * Pn)
        Hr = Hcp.permute(0, 2, 1, 3).reshape(6 * C, 3 * Pn)
        S = torch.block_diag(*Hcc) - Xr @ Hr.T
        bS = bc - torch.einsum("apik,pk->ai", X, bp)
        Sm = torch.where(fixed_diag[:, None] | fixed_diag[None, :], eye6c, S + lam * eye6c)
        bSm = torch.where(fixed_diag, 0.0, bS.reshape(-1))
        dc = -torch.linalg.solve(Sm, bSm).reshape(C, 6)
        dc = torch.where(prob.cam_fixed[:, None], 0.0, dc)
        dp = -torch.einsum("pjk,pk->pj", Hpp_inv,
                           bp + torch.einsum("apij,ai->pj", Hcp, dc))
        dp = torch.where(prob.point_valid[:, None], dp, 0.0)
        T_new = se3_compose(se3_exp(dc), SE3(R, t))
        return T_new.R, T_new.t, points + dp, cost, n_active

    def step(carry, gate_full):
        R, t, points, lam = carry
        R2, t2, pts2, cost, n_active = one_iteration(R, t, points, lam, gate_full)
        # the tentative cost on the full problem, on every rank alike
        cost_new, _, _, active2 = _masked_cost(cam, R2, t2, pts2, prob, gate_full)
        accept = _accept(cost_new, cost, torch.sum(active2), n_active)
        return (torch.where(accept, R2, R), torch.where(accept, t2, t),
                torch.where(accept, pts2, points),
                torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3))

    def lam0():
        return torch.tensor(1e-4, dtype=torch.float32, device=dev)

    all_obs = torch.ones_like(prob.obs_lm, dtype=torch.bool)
    n1 = max(iters // 2, 1)
    n2 = max(iters - n1, 1)
    carry = (prob.cam_R, prob.cam_t, prob.points, lam0())
    for _ in range(n1):
        carry = step(carry, all_obs)
    _, r1, pc1, _ = _masked_cost(cam, *carry[:3], prob)
    gate = (torch.sum(r1 * r1, -1) / prob.obs_sigma2 <= CHI2_2D * 4.0) & (pc1[..., 2] > 1e-2)
    carry = (*carry[:3], lam0())
    for _ in range(n2):
        carry = step(carry, gate)
    R, t, points, _ = carry

    cost0 = _masked_cost(cam, prob.cam_R, prob.cam_t, prob.points, prob)[0]
    costf, rf, _, front = _masked_cost(cam, R, t, points, prob)
    return BAResult(cam_R=R, cam_t=t, points=points, initial_cost=cost0, final_cost=costf,
                    obs_inlier=front & (torch.sum(rf * rf, -1) / prob.obs_sigma2 <= CHI2_2D))


def distributed_bundle_adjust(prob: BAProblem, cam: PinholeCamera,
                              mesh: Optional[Mesh] = None, iters: int = 10) -> BAResult:
    """BA with the observation-slot axis sharded across the mesh. Slots are
    padded to a multiple of the mesh size (obs_lm = -1: they cost nothing).
    With no mesh, a world of one on the device the problem lies on."""
    if mesh is None:
        mesh = make_mesh(device=prob.obs_lm.device)
    C, N = prob.obs_lm.shape
    pad = -N % mesh.size
    if pad:
        dev = prob.obs_lm.device
        prob = prob._replace(
            obs_lm=torch.cat([prob.obs_lm, torch.full((C, pad), -1, dtype=prob.obs_lm.dtype,
                                                      device=dev)], 1),
            obs_uv=torch.cat([prob.obs_uv, torch.zeros((C, pad, 2), dtype=prob.obs_uv.dtype,
                                                       device=dev)], 1),
            obs_sigma2=torch.cat([prob.obs_sigma2, torch.ones(
                (C, pad), dtype=prob.obs_sigma2.dtype, device=dev)], 1),
        )
    return _dba_impl(prob, cam, iters, mesh)
