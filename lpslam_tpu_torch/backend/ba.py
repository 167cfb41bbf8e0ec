"""Bundle adjustment: Levenberg-Marquardt with Schur-complement reduction
(port of lpslam_tpu/backend/ba.py, minus the ablation env hooks).

Two solvers with the JAX package's switch at C*N*P = 2**25:

- ``bundle_adjust`` (dense): the landmark-side blocks are built by the
  same one-hot (C, N, P) contraction as the JAX code, which on the GPU is a
  deterministic matmul; the reduced (6C, 6C) camera system is solved densely.
- ``bundle_adjust_cg`` (matrix-free Schur + block-Jacobi CG): its segment
  sums are ``kernels.linalg.segment_sum`` over one sort of the observations
  by landmark per solve: each landmark's terms added in observation order,
  as ``index_add_`` adds them on the CPU, and in that same order on the
  card, so a solve repeats itself bit for bit there (``index_add_``'s
  float atomics did not). Empty slots (weight 0) are left out of the sums
  rather than added to landmark 0. The tests hold the final cost to 1e-3
  relative of the JAX package.

LM accept/reject stays branch-free (``torch.where`` on the better iterate),
so an iteration makes no host round trip.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera
from ..geometry.se3 import SE3, se3_compose, se3_exp
from ..geometry.so3 import hat
from ..kernels.fast import topk_stable
from ..kernels.linalg import inv3x3_guarded, inv6x6_spd, segment_plan, segment_sum

CHI2_2D = 5.991
_GUARD_TOL = 1e12


class BAProblem(NamedTuple):
    """Dense masked BA problem (see the JAX docstring for every field)."""

    cam_R: torch.Tensor       # (C,3,3)
    cam_t: torch.Tensor       # (C,3)
    points: torch.Tensor      # (P,3)
    obs_lm: torch.Tensor      # (C,N) landmark index per slot, -1 = none
    obs_uv: torch.Tensor      # (C,N,2)
    obs_sigma2: torch.Tensor  # (C,N)
    cam_fixed: torch.Tensor   # (C,) bool
    point_valid: torch.Tensor  # (P,) bool
    point_fixed: torch.Tensor = None  # (P,) bool or None


class BAResult(NamedTuple):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    obs_inlier: torch.Tensor  # (C,N) bool


def _project_residuals(cam: PinholeCamera, R, t, points, obs_lm, obs_uv):
    """r (C,N,2), Jc (C,N,2,6), Jp (C,N,2,3), p_c (C,N,3)."""
    p_w = points[torch.clamp(obs_lm, min=0).to(torch.int64)]
    p_c = p_w @ R.transpose(-1, -2) + t[:, None, :]
    z = torch.clamp(p_c[..., 2], min=1e-2)
    u = cam.fx * p_c[..., 0] / z + cam.cx
    v = cam.fy * p_c[..., 1] / z + cam.cy
    r = torch.stack([u, v], -1) - obs_uv
    zinv = 1.0 / z
    zinv2 = zinv * zinv
    x, y = p_c[..., 0], p_c[..., 1]
    zero = torch.zeros_like(z)
    Jproj = torch.stack(
        [
            torch.stack([cam.fx * zinv, zero, -cam.fx * x * zinv2], -1),
            torch.stack([zero, cam.fy * zinv, -cam.fy * y * zinv2], -1),
        ],
        dim=-2,
    )  # (C,N,2,3)
    I3 = torch.eye(3, dtype=r.dtype, device=r.device).expand(*p_c.shape, 3)
    Jse3 = torch.cat([I3, -hat(p_c)], dim=-1)  # (C,N,3,6)
    Jc = Jproj @ Jse3
    Jp = Jproj @ R[:, None]
    return r, Jc, Jp, p_c


def _cost_and_weights(r, sigma2, active):
    chi2 = torch.sum(r * r, -1) / sigma2
    rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
    delta = CHI2_2D ** 0.5
    w = torch.where(rn <= delta, 1.0, delta / rn) / sigma2
    w = torch.where(active, w, 0.0)
    huber = torch.where(chi2 <= CHI2_2D, chi2, 2.0 * delta * rn - CHI2_2D)
    return torch.sum(torch.where(active, huber, 0.0)), w


def _blocks(prob, cam, R, t, points, gate, active0):
    """Residuals, weights and the per-observation Jacobian products shared by
    both solvers."""
    r, Jc, Jp, p_c = _project_residuals(cam, R, t, points, prob.obs_lm, prob.obs_uv)
    active = active0 & gate & (p_c[..., 2] > 1e-2)
    cost, w = _cost_and_weights(r, prob.obs_sigma2, active)
    Jc = torch.where(prob.cam_fixed[:, None, None, None], 0.0, Jc)
    Jcw = Jc * w[..., None, None]
    Jpw = Jp * w[..., None, None]
    Hcc = torch.einsum("cnik,cnil->ckl", Jcw, Jc)          # (C,6,6)
    bc = torch.einsum("cnik,cni->ck", Jcw, r)              # (C,6)
    JpTJp = torch.einsum("cnik,cnil->cnkl", Jpw, Jp)       # (C,N,3,3)
    bp_terms = torch.einsum("cnik,cni->cnk", Jpw, r)       # (C,N,3)
    return r, Jc, Jp, w, active, cost, Hcc, bc, JpTJp, bp_terms


def _point_inverse(prob, Hpp, lam):
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_inv = inv3x3_guarded(Hpp + (lam + 1e-8) * eye3, tol=_GUARD_TOL)
    if prob.point_fixed is not None:
        Hpp_inv = torch.where(prob.point_fixed[:, None, None], 0.0, Hpp_inv)
    return Hpp_inv


def _try_step(prob, cam, carry, gate, active0, active, cost, dc, dp):
    """Tentative update, cost comparison over comparable active sets, and
    the branch-free LM accept/reject."""
    R, t, points, lam = carry
    T_new = se3_compose(se3_exp(dc), SE3(R, t))
    pts_new = points + dp
    r2, _, _, p_c2 = _project_residuals(
        cam, T_new.R, T_new.t, pts_new, prob.obs_lm, prob.obs_uv
    )
    active2 = active0 & gate & (p_c2[..., 2] > 1e-2)
    cost_new, _ = _cost_and_weights(r2, prob.obs_sigma2, active2)
    accept = (
        (cost_new < cost)
        & torch.isfinite(cost_new)
        & (torch.sum(active2) * 2 >= torch.sum(active))
    )
    R = torch.where(accept, T_new.R, R)
    t = torch.where(accept, T_new.t, t)
    points = torch.where(accept, pts_new, points)
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)
    return (R, t, points, lam)


def bundle_adjust(prob: BAProblem, cam: PinholeCamera, iters: int = 10,
                  lm_lambda0: float = 1e-4) -> BAResult:
    C, N = prob.obs_lm.shape
    P = prob.points.shape[0]
    if C * N * P > (1 << 25):
        return bundle_adjust_cg(prob, cam, iters=iters, lm_lambda0=lm_lambda0)
    dev = prob.points.device
    lm_c = torch.clamp(prob.obs_lm, min=0).to(torch.int64)
    active0 = (prob.obs_lm >= 0) & prob.point_valid[lm_c]
    onehot = (
        prob.obs_lm[:, :, None] == torch.arange(P, dtype=prob.obs_lm.dtype, device=dev)
    ).to(prob.points.dtype)                                   # (C,N,P)
    onehot_flat_t = onehot.reshape(C * N, P).T                # (P,C*N)
    onehot_t = onehot.transpose(1, 2)                         # (C,P,N)
    fixed_diag = torch.repeat_interleave(prob.cam_fixed, 6)
    eye6c = torch.eye(6 * C, dtype=prob.points.dtype, device=dev)

    def step(carry, gate):
        R, t, points, lam = carry
        r, Jc, Jp, w, active, cost, Hcc, bc, JpTJp, bp_terms = _blocks(
            prob, cam, R, t, points, gate, active0
        )
        JcTJp = torch.einsum("cnik,cnil->cnkl", Jc * w[..., None, None], Jp)
        Hpp = (onehot_flat_t @ JpTJp.reshape(C * N, 9)).reshape(P, 3, 3)
        bp = onehot_flat_t @ bp_terms.reshape(C * N, 3)
        Hcp = (onehot_t @ JcTJp.reshape(C, N, 18)).reshape(C, P, 6, 3)
        Hpp_inv = _point_inverse(prob, Hpp, lam)

        # Schur complement on cameras: S = Hcc - Hcp Hpp^-1 Hpc
        X = torch.einsum("apij,pjk->apik", Hcp, Hpp_inv)       # (C,P,6,3)
        Xr = X.permute(0, 2, 1, 3).reshape(6 * C, 3 * P)
        Hr = Hcp.permute(0, 2, 1, 3).reshape(6 * C, 3 * P)
        S = torch.block_diag(*Hcc) - Xr @ Hr.T
        bS = bc - torch.einsum("apik,pk->ai", X, bp)
        Sm = torch.where(
            fixed_diag[:, None] | fixed_diag[None, :], eye6c, S + lam * eye6c
        )
        bSm = torch.where(fixed_diag, 0.0, bS.reshape(-1))
        dc = -torch.linalg.solve(Sm, bSm).reshape(C, 6)
        dc = torch.where(prob.cam_fixed[:, None], 0.0, dc)

        Hpc_dc = torch.einsum("apij,ai->pj", Hcp, dc)
        dp = -torch.einsum("pjk,pk->pj", Hpp_inv, bp + Hpc_dc)
        dp = torch.where(prob.point_valid[:, None], dp, 0.0)
        return _try_step(prob, cam, carry, gate, active0, active, cost, dc, dp)

    return _staged_lm(prob, cam, iters, lm_lambda0, active0, step)


def _staged_lm(prob, cam, iters, lm_lambda0, active0, step):
    """Staged LM: every observation first (Huber-weighted), then two rounds
    of hard chi2 culls recomputed from the current estimate, with lambda
    reset at each phase boundary."""
    dev = prob.points.device
    r0, _, _, pc0 = _project_residuals(
        cam, prob.cam_R, prob.cam_t, prob.points, prob.obs_lm, prob.obs_uv
    )
    cost0, _ = _cost_and_weights(r0, prob.obs_sigma2, active0 & (pc0[..., 2] > 1e-2))

    def lam0():
        return torch.tensor(lm_lambda0, dtype=torch.float32, device=dev)

    def cull(carry, mult):
        r_, _, _, pc_ = _project_residuals(
            cam, carry[0], carry[1], carry[2], prob.obs_lm, prob.obs_uv
        )
        chi = torch.sum(r_ * r_, -1) / prob.obs_sigma2
        return (chi <= CHI2_2D * mult) & (pc_[..., 2] > 1e-2)

    n1 = max(iters // 3, 1)
    n2 = max(iters // 3, 1)
    n3 = max(iters - n1 - n2, 1)
    carry = (prob.cam_R, prob.cam_t, prob.points, lam0())
    all_obs = torch.ones_like(active0)
    for _ in range(n1):
        carry = step(carry, all_obs)
    gate = cull(carry, 4.0)
    carry = (*carry[:3], lam0())
    for _ in range(n2):
        carry = step(carry, gate)
    gate = gate & cull(carry, 1.5)
    carry = (*carry[:3], lam0())
    for _ in range(n3):
        carry = step(carry, gate)
    R, t, points, _ = carry

    rf, _, _, pcf = _project_residuals(cam, R, t, points, prob.obs_lm, prob.obs_uv)
    chi2 = torch.sum(rf * rf, -1) / prob.obs_sigma2
    front = active0 & (pcf[..., 2] > 1e-2)
    costf, _ = _cost_and_weights(rf, prob.obs_sigma2, front)
    return BAResult(
        cam_R=R, cam_t=t, points=points, initial_cost=cost0, final_cost=costf,
        obs_inlier=front & (chi2 <= CHI2_2D),
    )


def bundle_adjust_cg(prob: BAProblem, cam: PinholeCamera, iters: int = 10,
                     cg_iters: int = 24, lm_lambda0: float = 1e-4) -> BAResult:
    """Matrix-free Schur complement + block-Jacobi preconditioned CG on the
    camera system; nothing of size C x P is materialized."""
    P = prob.points.shape[0]
    dev = prob.points.device
    obs_p = torch.clamp(prob.obs_lm, min=0).to(torch.int64)   # (C,N)
    flat_lm = obs_p.reshape(-1)
    active0 = (prob.obs_lm >= 0) & prob.point_valid[obs_p]
    eye6 = torch.eye(6, dtype=prob.points.dtype, device=dev)

    # the observations by landmark, once per solve; empty slots left out
    plan = segment_plan(torch.where(prob.obs_lm >= 0, obs_p, -1), P)

    def landmark_sum(vals):
        return segment_sum(vals.reshape(-1, *vals.shape[2:]), plan)

    def step(carry, gate):
        R, t, points, lam = carry
        r, Jc, Jp, w, active, cost, Hcc, bc, JpTJp, bp_terms = _blocks(
            prob, cam, R, t, points, gate, active0
        )
        Hpp = landmark_sum(JpTJp)
        bp = landmark_sum(bp_terms)
        Hpp_inv = _point_inverse(prob, Hpp, lam)
        Jpw = Jp * w[..., None, None]

        def hpc_apply(x):
            """(C,6) camera vector -> (P,3) sum of J_p^T w J_c x."""
            y = torch.einsum("cnik,ck->cni", Jc, x)
            return landmark_sum(torch.einsum("cnik,cni->cnk", Jpw, y))

        def hcp_apply(v):
            """(P,3) point vector -> (C,6) sum of J_c^T w J_p v."""
            yy = torch.einsum("cnik,cnk->cni", Jp, v[obs_p])
            return torch.einsum("cnik,cni->ck", Jc * w[..., None, None], yy)

        def S_apply(x):
            u = torch.einsum("pij,pj->pi", Hpp_inv, hpc_apply(x))
            out = torch.einsum("ckl,cl->ck", Hcc, x) + lam * x - hcp_apply(u)
            return torch.where(prob.cam_fixed[:, None], x, out)

        bS = bc - hcp_apply(torch.einsum("pij,pj->pi", Hpp_inv, bp))
        b_rhs = torch.where(prob.cam_fixed[:, None], 0.0, -bS)

        Mi = inv6x6_spd(Hcc + (lam + 1e-6) * eye6)
        Mi = torch.where(
            torch.all(torch.isfinite(Mi).flatten(-2), dim=-1)[:, None, None], Mi, eye6
        )
        Mi = torch.where(prob.cam_fixed[:, None, None], eye6, Mi)

        def precond(v):
            return torch.einsum("cij,cj->ci", Mi, v)

        x = torch.zeros_like(b_rhs)
        res = b_rhs
        z = precond(res)
        p = z
        rz = torch.sum(res * z)
        for _ in range(cg_iters):
            Ap = S_apply(p)
            denom = torch.sum(p * Ap)
            alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, 0.0)
            x = x + alpha * p
            res = res - alpha * Ap
            z = precond(res)
            rz_new = torch.sum(res * z)
            beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            rz = rz_new
        dc = torch.where(prob.cam_fixed[:, None], 0.0, x)

        dp = -torch.einsum("pjk,pk->pj", Hpp_inv, bp + hpc_apply(dc))
        dp = torch.where(prob.point_valid[:, None], dp, 0.0)
        return _try_step(prob, cam, carry, gate, active0, active, cost, dc, dp)

    return _staged_lm(prob, cam, iters, lm_lambda0, active0, step)


# ---------------------------------------------------------------------------
# Local BA over a MapStore window
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def local_ba(m, cam: PinholeCamera, window: int = 6, iters: int = 8,
             covisibility: bool = False):
    """Optimize a window of keyframes + every landmark they observe; the two
    anchor cameras are held fixed. Returns (updated MapStore, BAResult)."""
    return _local_ba_impl(m, cam, window, iters, covisibility)


def _local_ba_impl(m, cam: PinholeCamera, window: int, iters: int,
                   covisibility: bool = False):
    from ..mapstore.store import scatter_drop

    K = m.kf_R.shape[0]
    P = m.lm_pos.shape[0]
    N = m.kf_uv.shape[1]
    dev = m.lm_pos.device
    rank = torch.arange(window, device=dev)
    if covisibility and window >= 4:
        n_recent = window - 2
        base = torch.clamp(m.n_kf - n_recent, min=0)
        recent = base + torch.arange(n_recent, device=dev)
        newest = torch.clamp(m.n_kf - 1, min=0).reshape(1).to(torch.int64)
        lm_new = m.kf_lm_idx.index_select(0, newest)[0]
        flags = torch.zeros((P,), dtype=torch.int32, device=dev).scatter_reduce_(
            0, torch.clamp(lm_new, min=0).to(torch.int64),
            (lm_new >= 0).to(torch.int32), reduce="amax",
        )
        shared = torch.sum(
            flags[torch.clamp(m.kf_lm_idx, min=0).to(torch.int64)] * (m.kf_lm_idx >= 0),
            dim=1,
        )
        older = (torch.arange(K, device=dev) < base) & m.kf_valid
        shared = torch.where(older, shared, -1)
        top_scores, top2 = topk_stable(shared, 2)
        top2_valid = top_scores > 0
        win_idx = torch.clamp(torch.cat([top2, recent]), 0, K - 1)
        win_exists = torch.cat([top2_valid, recent < m.n_kf])
        n_covis = torch.sum(top2_valid.to(torch.int32))
        extra_fix = (rank >= 2) & ((rank - 2) < (2 - n_covis))
        cam_fixed = (rank < 2) | extra_fix | ~win_exists
    else:
        base = torch.clamp(m.n_kf - window, min=0)
        win_idx = torch.clamp(base + rank, 0, K - 1)
        win_exists = (base + rank) < m.n_kf
        cam_fixed = (rank < 2) | ~win_exists

    obs_lm = torch.where(win_exists[:, None], m.kf_lm_idx[win_idx], -1)
    obs_lm = torch.where(m.kf_kp_valid[win_idx], obs_lm, -1)

    # compress the point axis to the window's own landmarks (in index order)
    Pw = min(P, max(_next_pow2(window * N // 2), 1024))
    flat = obs_lm.reshape(-1)
    member = torch.zeros((P,), dtype=torch.int32, device=dev).scatter_reduce_(
        0, torch.clamp(flat, min=0).to(torch.int64), (flat >= 0).to(torch.int32),
        reduce="amax",
    ) > 0
    pos = torch.cumsum(member.to(torch.int32), 0) - 1
    inv = torch.where(member, pos, -1)
    inv = torch.where(inv < Pw, inv, -1)
    sel = scatter_drop(
        torch.zeros((Pw,), dtype=torch.int64, device=dev),
        torch.where(inv >= 0, inv, Pw),
        torch.arange(P, device=dev),
    )
    sel_member = torch.arange(Pw, device=dev) < torch.clamp(pos[-1] + 1, max=Pw)
    obs_lm_c = torch.where(
        obs_lm >= 0, inv[torch.clamp(obs_lm, min=0).to(torch.int64)], -1
    )
    prob = BAProblem(
        cam_R=m.kf_R[win_idx],
        cam_t=m.kf_t[win_idx],
        points=m.lm_pos[sel],
        obs_lm=obs_lm_c,
        obs_uv=m.kf_uv[win_idx],
        obs_sigma2=torch.ones(obs_lm.shape, dtype=torch.float32, device=dev),
        cam_fixed=cam_fixed,
        point_valid=m.lm_valid[sel] & sel_member,
        point_fixed=m.lm_valid[sel] & (m.lm_n_obs[sel] <= 1),
    )
    res = bundle_adjust(prob, cam, iters=iters)

    lm_pos = scatter_drop(m.lm_pos, torch.where(sel_member, sel, P), res.points)
    scatter_idx = torch.where(win_exists, win_idx, K)
    kf_R = scatter_drop(m.kf_R, scatter_idx, res.cam_R)
    kf_t = scatter_drop(m.kf_t, scatter_idx, res.cam_t)
    return m._replace(kf_R=kf_R, kf_t=kf_t, lm_pos=lm_pos), res


def global_ba(m, cam: PinholeCamera, iters: int = 10):
    """Full-map bundle adjustment, the post-loop global BA: ``local_ba``
    with the window set to the whole keyframe capacity (temporal window,
    first two keyframes fixed as the gauge). At the operating point
    (K=128, N=1200, M=24576) C*N*P exceeds 2**25, so ``bundle_adjust``
    routes it to ``bundle_adjust_cg``. Returns (updated MapStore, BAResult)."""
    return _local_ba_impl(m, cam, m.kf_R.shape[0], iters)
