"""Relocalization: 2D-3D matches against a candidate keyframe -> robust PnP
-> pose refinement -> inlier gate (port of lpslam_tpu/frontend/relocalize.py).

The candidate loop is the caller's; an attempt is fixed-shape tensor code:
a batched sweep of random 8-point DLT hypotheses scored by reprojection
inliers (the RANSAC stand-in), an IRLS-weighted DLT polish on the winning
consensus set, then ``pose_only_optimize``.

The hypothesis draw is ``torch.multinomial`` with an explicit generator,
seeded 0 on every call by default as JAX uses ``PRNGKey(0)``. The two
generators draw different samples, so the packages agree on outcomes (pose,
inlier count), not on the samples.

One deliberate departure: ``pnp_irls`` solves its DLTs on points centred on
their weighted mean and moves the translation back afterwards. The JAX code
solves on raw map coordinates; once landmarks lie 40-115 map units from the
origin, its fp32 12x12 normal matrix is so ill-conditioned that the smallest
eigenvector is garbage and the attempt verifies no inlier (measured on the
600-frame room's map, where centring recovers 107-585 inliers at the same
candidates). With exact correspondences both forms give the same pose.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera, project_pinhole
from ..geometry.se3 import SE3
from ..kernels.match import match_mutual_nn
from ..mapstore.store import MapStore
from .pose_opt import pose_only_optimize


def pnp_dlt(p_w, uv_n, w) -> SE3:
    """Weighted DLT PnP: λ[R|t] from 3D points and normalized image
    coordinates, returned as an orthonormalized SE3.

    p_w: (N, 3) world points; uv_n: (N, 2) normalized coordinates;
    w: (..., N) nonnegative weights (0 = ignore), one solve per leading
    index. Needs >= 6 effective points.
    """
    n = p_w.shape[0]
    Xh = torch.cat([p_w, torch.ones_like(p_w[:, :1])], -1)           # (N, 4)
    zero4 = torch.zeros((n, 4), dtype=p_w.dtype, device=p_w.device)
    x, y = uv_n[:, 0:1], uv_n[:, 1:2]
    A = torch.cat([
        torch.cat([Xh, zero4, -x * Xh], -1),
        torch.cat([zero4, Xh, -y * Xh], -1),
    ], 0)                                                             # (2N, 12)
    ww = torch.cat([w, w], -1)
    AtA = torch.einsum("ni,...n,nj->...ij", A, ww, A)
    v = torch.linalg.eigh(AtA)[1][..., :, 0]                          # smallest
    P = v.reshape(*v.shape[:-1], 3, 4)

    # λ may have either sign; det(M3) = λ³ det(R), so making the determinant
    # positive fixes it (and with it the eigenvector's sign) before the SVD
    s = torch.sign(torch.linalg.det(P[..., :3]))
    P = P * torch.where(s == 0, 1.0, s)[..., None, None]
    U, S, Vt = torch.linalg.svd(P[..., :3])
    d = torch.linalg.det(U @ Vt)
    one = torch.ones_like(d)
    R = U @ torch.diag_embed(torch.stack([one, one, d], -1)) @ Vt
    lam = torch.mean(S, -1)
    return SE3(R, P[..., 3] / torch.clamp(lam, min=1e-12)[..., None])


def pnp_irls(p_w, uv, valid, cam: PinholeCamera, iters: int = 6,
             huber_px: float = 4.0, n_hypotheses: int = 64,
             inlier_px: float = 6.0, generator=None) -> SE3:
    """Robust PnP: `n_hypotheses` random 8-point DLT solves in one batch,
    scored by reprojection inliers, then IRLS-weighted DLT on the winner's
    consensus set. generator: a torch.Generator on p_w's device (default:
    a fresh one seeded 0)."""
    dev = p_w.device
    uv_n = torch.stack([(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1)
    w_valid = valid.to(torch.float32)
    n = p_w.shape[0]
    # DLT on centred points (see the module docstring); R (p - mu) + t_c
    # = R p + (t_c - R mu)
    mu = torch.sum(p_w * w_valid[:, None], 0) / torch.clamp(torch.sum(w_valid), min=1.0)
    p_w = p_w - mu
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    # hypothesis sweep: 8 valid indices per hypothesis, drawn with
    # replacement (uniform when nothing is valid: the result is unused then)
    total = torch.sum(w_valid)
    p = torch.where(total > 0, w_valid / torch.clamp(total, min=1.0), 1.0 / n)
    idx = torch.multinomial(p, n_hypotheses * 8, replacement=True,
                            generator=generator).reshape(n_hypotheses, 8)
    w_h = torch.zeros((n_hypotheses, n), dtype=torch.float32, device=dev)
    w_h.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    hyps = pnp_dlt(p_w, uv_n, w_h)

    def reproject(T):
        """(in front of the camera, reprojection error in px) per point."""
        p_c = torch.einsum("...ij,nj->...ni", T.R, p_w) + T.t[..., None, :]
        rn = torch.linalg.norm(project_pinhole(cam, p_c) - uv, dim=-1)
        return p_c[..., 2] > 1e-3, rn

    front, rn = reproject(hyps)
    inl = valid & front & (rn < inlier_px)
    best = torch.argmax(torch.sum(inl, -1))
    w = w_valid * inl[best].to(torch.float32)
    # no consensus anywhere: fall back to every valid point (the refinement
    # stage's chi2 gate still protects)
    w = torch.where(torch.sum(w) >= 6, w, w_valid)

    for _ in range(iters):
        front, rn = reproject(pnp_dlt(p_w, uv_n, w))
        w = w_valid * torch.clamp(huber_px / torch.clamp(rn, min=1e-6), max=1.0)
        w = torch.where((rn < 2.0 * inlier_px) & front, w, 0.0)
    T = pnp_dlt(p_w, uv_n, w)
    return SE3(T.R, T.t - T.R @ mu)


class RelocResult(NamedTuple):
    pose: SE3
    n_inliers: torch.Tensor  # () int32
    ok: torch.Tensor         # () bool


def relocalize_attempt(m: MapStore, cam: PinholeCamera, desc, xy, kp_valid,
                       kf_id: int, min_inliers: int = 20, generator=None) -> RelocResult:
    """One attempt against candidate keyframe `kf_id`: mutual-NN matches to
    its landmark-bearing keypoints -> robust PnP -> chi2-gated pose
    refinement -> inlier gate."""
    kf_lm = m.kf_lm_idx[kf_id]
    lm_c = torch.clamp(kf_lm, min=0).to(torch.int64)
    kf_ok = m.kf_kp_valid[kf_id] & (kf_lm >= 0) & m.lm_valid[lm_c]
    idx, ok = match_mutual_nn(desc, m.kf_desc[kf_id], kp_valid, kf_ok,
                              max_distance=64, ratio=0.85)
    lm = kf_lm[idx]
    ok = ok & (lm >= 0)
    p_w = m.lm_pos[torch.clamp(lm, min=0).to(torch.int64)]
    pose0 = pnp_irls(p_w, xy, ok, cam, generator=generator)
    res = pose_only_optimize(pose0, cam, p_w, xy, ok, sigma2=torch.ones_like(xy[:, 0]),
                             iters=8)
    return RelocResult(pose=res.pose, n_inliers=res.n_inliers,
                       ok=res.n_inliers >= min_inliers)
