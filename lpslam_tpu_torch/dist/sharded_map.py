"""Keyframe-axis-sharded global bundle adjustment and distributed loop
scoring (port of lpslam_tpu/dist/sharded_map.py).

Each rank owns a contiguous block of keyframes and all of their
observations; landmark state (P x 3) is replicated. The reduced camera
system S = Hcc - Hcp Hpp^-1 Hpc couples keyframes of different ranks
through shared landmarks, so it is never formed: block-Jacobi PCG solves it
with a fixed iteration count, and each matvec

    S x = Hcc_local x_local - Hcp_local Hpp^-1 all_reduce(Hpc_local x_local)

moves exactly one (P, 3) all-reduce. Per LM iteration the wire carries Hpp
(P,3,3), bp (P,3) and the cost, one (P,3) vector and two scalars per CG
step, and one (P,3) vector for the landmark back-substitution; never an
observation.

Every public function takes the same full inputs on every rank, solves its
own block, and returns the same replicated result on every rank.
``_sgba_local`` is the solver on a rank's block, which ``ResidentMap``
calls on the blocks it keeps resident.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..backend.ba import BAProblem, BAResult, CHI2_2D, _cost_and_weights, _project_residuals
from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3, se3_compose, se3_exp
from ..kernels.linalg import inv3x3_guarded, inv6x6_spd, segment_plan, segment_sum
from .mesh import Mesh, make_mesh


def _local_obs_blocks(cam, R, t, points, obs_lm, obs_uv, obs_sigma2,
                      cam_fixed, gate, point_valid):
    """Residual cost and the per-observation normal-equation blocks of this
    rank's observations: Hcc (c,6,6), bc (c,6), JpTJp (c,N,3,3), bp terms
    (c,N,3), JcTJp (c,N,6,3), cost, and the number of active observations."""
    lm = torch.clamp(obs_lm, min=0).to(torch.int64)
    active0 = (obs_lm >= 0) & point_valid[lm]
    r, Jc, Jp, p_c = _project_residuals(cam, R, t, points, obs_lm, obs_uv)
    active = active0 & gate & (p_c[..., 2] > 1e-2)
    cost, w = _cost_and_weights(r, obs_sigma2, active)
    Jc = torch.where(cam_fixed[:, None, None, None], 0.0, Jc)
    Jcw = Jc * w[..., None, None]
    Jpw = Jp * w[..., None, None]
    Hcc = torch.einsum("cnik,cnil->ckl", Jcw, Jc)
    bc = torch.einsum("cnik,cni->ck", Jcw, r)
    JpTJp = torch.einsum("cnik,cnil->cnkl", Jpw, Jp)
    bp_terms = torch.einsum("cnik,cni->cnk", Jpw, r)
    JcTJp = torch.einsum("cnik,cnil->cnkl", Jcw, Jp)
    return Hcc, bc, JpTJp, bp_terms, JcTJp, cost, torch.sum(active).to(cost.dtype)


def _accept(cost_new, cost, n_new, n_active):
    """The LM step is taken when it lowers the cost and keeps at least half
    the active observations (backend.ba's rule). A lower cost alone is not
    enough: a step that sends every point behind its camera, or to NaN,
    leaves no active observation and costs 0."""
    return (cost_new < cost) & torch.isfinite(cost_new) & (n_new * 2 >= n_active)


def _masked_cost(cam, R, t, points, prob, gate=None):
    """(cost, residuals, camera-frame points, active mask) of a (block)
    problem: the cost over the valid observations in front of their camera,
    and in ``gate`` where it is given."""
    lm = torch.clamp(prob.obs_lm, min=0).to(torch.int64)
    active0 = (prob.obs_lm >= 0) & prob.point_valid[lm]
    r, _, _, p_c = _project_residuals(cam, R, t, points, prob.obs_lm, prob.obs_uv)
    active = active0 & (p_c[..., 2] > 1e-2)
    if gate is not None:
        active = active & gate
    cost, _ = _cost_and_weights(r, prob.obs_sigma2, active)
    return cost, r, p_c, active


def _sgba_local(prob: BAProblem, cam: PinholeCamera, iters: int, cg_iters: int,
                mesh: Mesh) -> BAResult:
    """Global BA on this rank's keyframe block: ``prob``'s camera-axis
    fields are the block, its points and point_valid the replicated
    landmarks. Returns the block's poses and inliers, and the replicated
    points and costs."""
    dev = prob.points.device
    dt = prob.points.dtype
    Pn = prob.points.shape[0]
    obs_p = torch.clamp(prob.obs_lm, min=0).to(torch.int64)
    flat_lm = obs_p.reshape(-1)
    free = ~prob.cam_fixed
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    # one sort of the observations by landmark for the whole solve, empty
    # slots left out: the sums then add in the same order on every run
    # (index_add_'s atomics on the card did not, and two solves of one room
    # map landed kf_t up to 1.05e-2 apart on an H100 80GB HBM3 at 700 W,
    # tools/card_map_repeat.py)
    plan = segment_plan(torch.where(prob.obs_lm >= 0, obs_p, -1), Pn)

    def landmark_sum(vals):
        return segment_sum(vals.reshape(-1, *vals.shape[2:]), plan)

    def all_sum(x):
        return mesh.all_reduce(x.reshape(1))[0]

    def lm_iteration(lam, R, t, points, gate):
        Hcc, bc, JpTJp, bp_terms, JcTJp, cost, n_active = _local_obs_blocks(
            cam, R, t, points, prob.obs_lm, prob.obs_uv, prob.obs_sigma2,
            prob.cam_fixed, gate, prob.point_valid)
        # the replicated landmark blocks: one all-reduce of the local partials
        red = mesh.all_reduce(torch.cat([
            landmark_sum(JpTJp).reshape(-1), landmark_sum(bp_terms).reshape(-1),
            torch.stack([cost, n_active])]))
        Hpp = red[:Pn * 9].reshape(Pn, 3, 3)
        bp = red[Pn * 9:Pn * 12].reshape(Pn, 3)
        cost, n_active = red[-2], red[-1]

        # relative (Marquardt) damping: with an absolute 1e-4 the point
        # blocks (entries ~fx^2/z^2 * n_obs ~ 1e5) keep a condition of ~1e9,
        # whose fp32 inverses depend on the reduction order, i.e. on the
        # world size; lam * mean diagonal bounds it by ~1/lam
        damp = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1) / 3.0 + 1e-6
        Hpp_inv = inv3x3_guarded(Hpp + damp[:, None, None] * eye3)

        def apply_Hpc(x_loc):
            """(c,6) camera vector -> (P,3) landmark vector, all-reduced."""
            return mesh.all_reduce(landmark_sum(torch.einsum("cnik,ci->cnk", JcTJp, x_loc)))

        def apply_Hcp(v):
            """(P,3) landmark vector -> (c,6) camera vector (local)."""
            return torch.einsum("cnik,cnk->ci", JcTJp, v[obs_p])

        cdamp = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-6

        def S_mv(x_loc):
            """Reduced-camera-system matvec; one (P,3) all-reduce."""
            x_loc = torch.where(free[:, None], x_loc, 0.0)
            u = apply_Hpc(x_loc)
            y = (torch.einsum("ckl,cl->ck", Hcc, x_loc) + cdamp[:, None] * x_loc
                 - apply_Hcp(torch.einsum("pjk,pk->pj", Hpp_inv, u)))
            return torch.where(free[:, None], y, 0.0)

        # block-Jacobi preconditioner: each camera's 6x6 diagonal block of S
        # (the landmark coupling approximated per slot)
        Sdiag = (Hcc + cdamp[:, None, None] * eye6
                 - torch.einsum("cnik,cnkl,cnjl->cij", JcTJp, Hpp_inv[obs_p], JcTJp))
        Mi = inv6x6_spd(Sdiag + 1e-6 * eye6)
        Mi = torch.where(torch.all(torch.isfinite(Mi).flatten(-2), dim=-1)[:, None, None],
                         Mi, eye6)

        def precond(v):
            return torch.where(free[:, None], torch.einsum("cij,cj->ci", Mi, v), 0.0)

        # PCG on S dx = -bS, a fixed number of steps (branch-free)
        bS = bc - apply_Hcp(torch.einsum("pjk,pk->pj", Hpp_inv, bp))
        res = torch.where(free[:, None], -bS, 0.0)
        x = torch.zeros_like(res)
        z = precond(res)
        p_dir = z
        rz = all_sum(torch.sum(res * z))
        for _ in range(cg_iters):
            Sp = S_mv(p_dir)
            alpha = rz / torch.clamp(all_sum(torch.sum(p_dir * Sp)), min=1e-20)
            x = x + alpha * p_dir
            res = res - alpha * Sp
            z = precond(res)
            rz2 = all_sum(torch.sum(res * z))
            p_dir = z + rz2 / torch.clamp(rz, min=1e-20) * p_dir
            rz = rz2

        # landmark back-substitution: dp = -Hpp^-1 (bp + Hpc dc)
        dp = -torch.einsum("pjk,pk->pj", Hpp_inv, bp + apply_Hpc(x))
        dp = torch.where(prob.point_valid[:, None], dp, 0.0)
        T_new = se3_compose(se3_exp(x), SE3(R, t))
        return T_new.R, T_new.t, dp, cost, n_active

    def step(carry, gate):
        R, t, points, lam = carry
        R2, t2, dp, cost, n_active = lm_iteration(lam, R, t, points, gate)
        pts2 = points + dp
        cost_new, _, _, active2 = _masked_cost(cam, R2, t2, pts2, prob, gate)
        cost_new, n_new = mesh.all_reduce(torch.stack([cost_new,
                                                       torch.sum(active2).to(dt)]))
        accept = _accept(cost_new, cost, n_new, n_active)
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
    costs = mesh.all_reduce(torch.stack([cost0, costf]))
    inlier = front & (torch.sum(rf * rf, -1) / prob.obs_sigma2 <= CHI2_2D)
    return BAResult(cam_R=R, cam_t=t, points=points, initial_cost=costs[0],
                    final_cost=costs[1], obs_inlier=inlier)


def sharded_global_ba_problem(prob: BAProblem, cam: PinholeCamera,
                              mesh: Optional[Mesh] = None, iters: int = 8,
                              cg_iters: int = 15) -> BAResult:
    """Global BA with the keyframe axis sharded across the mesh. The camera
    axis is padded to a multiple of the mesh size with fixed cameras that
    observe nothing; the result keeps the padding. With no mesh, a world of
    one on the device the problem lies on."""
    if mesh is None:
        mesh = make_mesh(device=prob.obs_lm.device)
    C, N = prob.obs_lm.shape
    pad = -C % mesh.size
    if pad:
        dev, dt = prob.cam_R.device, prob.cam_R.dtype
        prob = prob._replace(
            cam_R=torch.cat([prob.cam_R, torch.eye(3, dtype=dt, device=dev).expand(pad, 3, 3)]),
            cam_t=torch.cat([prob.cam_t, torch.zeros((pad, 3), dtype=dt, device=dev)]),
            obs_lm=torch.cat([prob.obs_lm, torch.full((pad, N), -1, dtype=prob.obs_lm.dtype,
                                                      device=dev)]),
            obs_uv=torch.cat([prob.obs_uv, torch.zeros((pad, N, 2), dtype=dt, device=dev)]),
            obs_sigma2=torch.cat([prob.obs_sigma2, torch.ones((pad, N), dtype=dt, device=dev)]),
            cam_fixed=torch.cat([prob.cam_fixed, torch.ones((pad,), dtype=torch.bool,
                                                            device=dev)]),
        )
    sl = mesh.block(C + pad)
    local = prob._replace(cam_R=prob.cam_R[sl], cam_t=prob.cam_t[sl], obs_lm=prob.obs_lm[sl],
                          obs_uv=prob.obs_uv[sl], obs_sigma2=prob.obs_sigma2[sl],
                          cam_fixed=prob.cam_fixed[sl])
    res = _sgba_local(local, cam, iters, cg_iters, mesh)
    return res._replace(cam_R=mesh.all_gather(res.cam_R), cam_t=mesh.all_gather(res.cam_t),
                        obs_inlier=mesh.all_gather(res.obs_inlier))


def _map_problem(m, row0: int = 0) -> BAProblem:
    """The global BA problem of a MapStore's keyframe rows (all of them, or
    the block starting at global row ``row0``): the first two keyframes are
    the gauge, empty slots are fixed and observe nothing."""
    K = m.kf_R.shape[0]
    dev = m.kf_R.device
    kf_ids = row0 + torch.arange(K, device=dev)
    exists = kf_ids < m.n_kf
    obs_lm = torch.where(m.kf_kp_valid & exists[:, None], m.kf_lm_idx, -1)
    return BAProblem(
        cam_R=m.kf_R, cam_t=m.kf_t, points=m.lm_pos, obs_lm=obs_lm, obs_uv=m.kf_uv,
        obs_sigma2=torch.ones(obs_lm.shape, dtype=torch.float32, device=dev),
        cam_fixed=(kf_ids < 2) | ~exists, point_valid=m.lm_valid)


def sharded_global_ba(m, cam: PinholeCamera, mesh: Optional[Mesh] = None,
                      iters: int = 8, cg_iters: int = 15):
    """Global BA over a whole MapStore with its keyframes partitioned across
    the mesh. Returns (map', BAResult)."""
    K = m.kf_R.shape[0]
    res = sharded_global_ba_problem(_map_problem(m), cam, mesh=mesh, iters=iters,
                                    cg_iters=cg_iters)
    return m._replace(kf_R=res.cam_R[:K], kf_t=res.cam_t[:K], lm_pos=res.points), res


def _bow_scores_local(db_loc, query, mesh: Mesh):
    """Cosine scores of this rank's database rows against the query, all
    gathered into the (rows,) vector of every rank."""
    qn = query / torch.clamp(torch.linalg.norm(query), min=1e-9)
    dn = db_loc / torch.clamp(torch.linalg.norm(db_loc, dim=1, keepdim=True), min=1e-9)
    return mesh.all_gather(dn @ qn)


def sharded_bow_scores(db, query, mesh: Optional[Mesh] = None):
    """Loop-candidate scores with the keyframe axis of the BoW database
    sharded across the mesh: each rank scores its block against the
    replicated query, and only the (K,) scores are gathered. With no mesh,
    a world of one on the device the database lies on."""
    if mesh is None:
        mesh = make_mesh(device=db.device)
    K = db.shape[0]
    pad = -K % mesh.size
    if pad:
        db = torch.cat([db, torch.zeros((pad, db.shape[1]), dtype=db.dtype, device=db.device)])
    return _bow_scores_local(db[mesh.block(K + pad)], query, mesh)[:K]
