"""Pose-only optimization (port of lpslam_tpu/frontend/pose_opt.py): a
fixed-iteration Gauss-Newton solve with an annealed chi2 gate and Huber
weights; the JAX ``lax.scan`` over the annealing schedule is a loop here."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera, project_pinhole
from ..geometry.se3 import SE3, se3_compose, se3_exp
from ..geometry.so3 import hat
from ..kernels.linalg import inv6x6_spd, solve_spd_6x6

CHI2_2D = 5.991


class PoseOptResult(NamedTuple):
    pose: SE3
    inlier: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor  # () int32
    final_cost: torch.Tensor
    sigma_pos: torch.Tensor = None  # (3,) world-frame camera-centre std-dev
    sigma_rot: torch.Tensor = None  # () rotation std-dev [rad]


def _residuals_jac(pose: SE3, cam: PinholeCamera, p_w, uv):
    p_c = p_w @ pose.R.T + pose.t
    z = torch.clamp(p_c[:, 2], min=1e-6)
    r = project_pinhole(cam, p_c) - uv
    x, y = p_c[:, 0], p_c[:, 1]
    zinv = 1.0 / z
    zinv2 = zinv * zinv
    zero = torch.zeros_like(z)
    Jproj = torch.stack(
        [
            torch.stack([cam.fx * zinv, zero, -cam.fx * x * zinv2], -1),
            torch.stack([zero, cam.fy * zinv, -cam.fy * y * zinv2], -1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    eye = torch.eye(3, dtype=p_w.dtype, device=p_w.device).expand(p_w.shape[0], 3, 3)
    Jse3 = torch.cat([eye, -hat(p_c)], dim=-1)  # (N, 3, 6)
    return r, Jproj @ Jse3, p_c[:, 2] <= 0.05


def pose_only_optimize(pose0: SE3, cam: PinholeCamera, p_w, uv, valid,
                       sigma2=None, iters: int = 10,
                       damping: float = 1e-3) -> PoseOptResult:
    """Optimize Tcw given N landmark positions p_w observed at pixels uv."""
    n = p_w.shape[0]
    dev = p_w.device
    if sigma2 is None:
        sigma2 = torch.ones((n,), dtype=p_w.dtype, device=dev)
    anneal = torch.cat([
        torch.logspace(3.0, 0.0, max(iters - 3, 1), dtype=torch.float32, device=dev),
        torch.ones((min(3, iters),), dtype=torch.float32, device=dev),
    ])[:iters]
    eye6 = torch.eye(6, dtype=p_w.dtype, device=dev)
    delta = CHI2_2D ** 0.5

    pose = pose0
    for it in range(iters):
        r, J, behind = _residuals_jac(pose, cam, p_w, uv)
        chi2 = torch.sum(r * r, dim=-1) / sigma2
        ok = valid & ~behind & (chi2 <= CHI2_2D * anneal[it])
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = torch.where(rn <= delta, 1.0, delta / rn) / sigma2
        w = torch.where(ok, w, 0.0)
        Jw = J * w[:, None, None]
        H = torch.einsum("nik,nil->kl", Jw, J) + damping * eye6
        b = torch.einsum("nik,ni->k", Jw, r)
        pose = se3_compose(se3_exp(-solve_spd_6x6(H, b)), pose)

    r, J, behind = _residuals_jac(pose, cam, p_w, uv)
    chi2 = torch.sum(r * r, dim=-1) / sigma2
    inlier = valid & ~behind & (chi2 <= CHI2_2D)
    n_in = torch.sum(inlier).to(torch.int32)
    cost = torch.sum(torch.where(inlier, chi2, 0.0))

    # pose covariance s^2 (J^T W J)^-1 at the final inliers
    w_in = torch.where(inlier, 1.0 / sigma2, 0.0)
    H = torch.einsum("nik,nil->kl", J * w_in[:, None, None], J) + 1e-6 * eye6
    s2 = cost / torch.clamp(2.0 * n_in.to(r.dtype) - 6.0, min=1.0)
    Cov = inv6x6_spd(H) * torch.clamp(s2, min=1e-12)
    C_tt = pose.R.T @ Cov[:3, :3] @ pose.R
    sigma_pos = torch.sqrt(torch.clamp(torch.diagonal(C_tt), min=0.0))
    sigma_rot = torch.sqrt(torch.clamp(torch.trace(Cov[3:, 3:]) / 3.0, min=0.0))
    bad = n_in < 6
    return PoseOptResult(
        pose=pose,
        inlier=inlier,
        n_inliers=n_in,
        final_cost=cost,
        sigma_pos=torch.where(bad, 0.0, sigma_pos),
        sigma_rot=torch.where(bad, 0.0, sigma_rot),
    )
