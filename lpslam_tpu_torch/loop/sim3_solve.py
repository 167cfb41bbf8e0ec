"""Sim3 estimation from 3D-3D landmark correspondences (port of
lpslam_tpu/loop/sim3_solve.py): weighted Umeyama in closed form (one 3x3
SVD) with IRLS re-weighting, fixed iterations.

The SVD's singular vectors may differ from JAX's in sign; R = U S Vt with
the determinant fix, s and t do not depend on those signs.
"""
from __future__ import annotations

import torch

from ..geometry.sim3 import Sim3


def umeyama_sim3(src, dst, w=None) -> Sim3:
    """Weighted least-squares Sim3: dst ≈ s R src + t. src, dst: (N, 3);
    w: (N,) weights."""
    if w is None:
        w = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    mu_s = torch.sum(src * w[:, None], 0) / wsum
    mu_d = torch.sum(dst * w[:, None], 0) / wsum
    xs = src - mu_s
    xd = dst - mu_d
    cov = (xd * w[:, None]).T @ xs / wsum
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    diag = torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)])
    R = U @ torch.diag(diag) @ Vt
    var_s = torch.sum(torch.sum(xs * xs, -1) * w) / wsum
    s = torch.sum(D * diag) / torch.clamp(var_s, min=1e-12)
    t = mu_d - s * (R @ mu_s)
    return Sim3(R=R, t=t, s=s)


def robust_sim3_from_matches(src, dst, valid, iters: int = 6, sigma: float = 0.1):
    """IRLS Sim3 with Geman-McClure-style weights; returns (Sim3, inlier
    mask). sigma: expected inlier residual scale in map units."""
    vf = valid.to(src.dtype)
    w = vf
    for _ in range(iters):
        S = umeyama_sim3(src, dst, w)
        r2 = torch.sum((S.s * (src @ S.R.T) + S.t - dst) ** 2, -1)
        w = vf * (sigma * sigma) / (sigma * sigma + r2)
    S = umeyama_sim3(src, dst, w)
    r2 = torch.sum((S.s * (src @ S.R.T) + S.t - dst) ** 2, -1)
    return S, valid & (r2 < (3.0 * sigma) ** 2)
