"""Two-view monocular initialization via homography
(port of lpslam_tpu/frontend/init2v.py): IRLS-weighted DLT, Faugeras-Lustman
decomposition into 8 candidates, cheirality/parallax/reprojection scoring."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera, project_pinhole, unproject_pinhole
from ..geometry.se3 import SE3
from .triangulate import triangulate_midpoint


def homography_dlt(x1, x2, w=None):
    """Weighted, Hartley-normalized DLT: x2 ~ H x1 for (N,2) points."""
    n = x1.shape[0]
    if w is None:
        w = torch.ones((n,), dtype=x1.dtype, device=x1.device)
    wsum = torch.clamp(torch.sum(w), min=1e-9)

    def normalize(x):
        mean = torch.sum(x * w[:, None], 0) / wsum
        d = torch.sqrt(torch.sum((x - mean) ** 2, -1))
        scale = (2.0 ** 0.5) / torch.clamp(torch.sum(d * w) / wsum, min=1e-9)
        T = torch.eye(3, dtype=x.dtype, device=x.device)
        T = torch.stack([
            torch.stack([scale, T[0, 1], -scale * mean[0]]),
            torch.stack([T[1, 0], scale, -scale * mean[1]]),
            T[2],
        ])
        return (x - mean) * scale, T

    p1, T1 = normalize(x1)
    p2, T2 = normalize(x2)
    zeros = torch.zeros((n, 3), dtype=x1.dtype, device=x1.device)
    ones = torch.ones((n,), dtype=x1.dtype, device=x1.device)
    h1 = torch.stack([p1[:, 0], p1[:, 1], ones], -1)
    r1 = torch.cat([zeros, -h1, p2[:, 1:2] * h1], -1)
    r2 = torch.cat([h1, zeros, -p2[:, 0:1] * h1], -1)
    sw = torch.sqrt(w)[:, None]
    A = torch.cat([r1 * sw, r2 * sw], 0)
    # the right singular vectors of the tall (2N, 9) system; the thin SVD has
    # the same Vh as the full one
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    Hn = Vh[-1].reshape(3, 3)
    H = torch.linalg.solve(T2, Hn @ T1)
    return H / H[2, 2]


def homography_irls(x1, x2, valid, iters: int = 6, tau: float = 5e-3):
    """IRLS homography re-weighted by transfer error. Returns (H, w)."""
    vf = valid.to(x1.dtype)
    w = vf
    ones = torch.ones((x1.shape[0], 1), dtype=x1.dtype, device=x1.device)
    p1h = torch.cat([x1, ones], -1)
    H = None
    for _ in range(iters):
        H = homography_dlt(x1, x2, w)
        q = p1h @ H.T
        e = q[:, :2] / torch.clamp(torch.abs(q[:, 2:3]), min=1e-9) \
            * torch.sign(q[:, 2:3]) - x2
        w = vf * (tau * tau) / (tau * tau + torch.sum(e * e, -1))
    return H, w


def decompose_homography(H):
    """All 8 Faugeras-Lustman solutions (R (8,3,3), t (8,3), n (8,3)) of a
    calibrated homography, t scaled to plane distance 1."""
    U, D, Vh = torch.linalg.svd(H)
    d1, d2, d3 = D[0], D[1], D[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    V = Vh.T
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1a = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3a = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    zero = torch.zeros_like(d1)
    one = torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            x1 = e1 * x1a
            x3 = e3 * x3a
            # case d' = +d2
            sin_t = (d1 - d3) * x1 * x3 / d2
            cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2
            Rp = mat([[cos_t, zero, -sin_t], [zero, one, zero], [sin_t, zero, cos_t]])
            tp = (d1 - d3) * torch.stack([x1, zero, -x3])
            np_ = torch.stack([x1, zero, x3])
            Rs.append(s * U @ Rp @ Vh)
            ts.append(U @ tp)
            ns.append(V @ np_)
            # case d' = -d2
            sin_p = (d1 + d3) * x1 * x3 / d2
            cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2
            Rn = mat([[cos_p, zero, sin_p], [zero, -one, zero], [sin_p, zero, -cos_p]])
            tn = (d1 + d3) * torch.stack([x1, zero, x3])
            Rs.append(s * U @ Rn @ Vh)
            ts.append(U @ tn)
            ns.append(V @ np_)
    return torch.stack(Rs), torch.stack(ts), torch.stack(ns)


class TwoViewInit(NamedTuple):
    ok: torch.Tensor        # () bool
    T2cw: torch.Tensor      # (12,) R (row-major) then t, |t| = 1
    points: torch.Tensor    # (N, 3)
    point_ok: torch.Tensor  # (N,) bool
    n_good: torch.Tensor    # () int32


def two_view_init_homography(cam: PinholeCamera, uv1, uv2, valid,
                             min_parallax_cos: float = 0.99995,
                             max_reproj_px: float = 4.0) -> TwoViewInit:
    """H-IRLS -> decompose -> score the 8 candidates -> triangulate with the
    winner. The first camera is the world origin."""
    x1 = unproject_pinhole(cam, uv1)[:, :2]
    x2 = unproject_pinhole(cam, uv2)[:, :2]
    H, w_fit = homography_irls(x1, x2, valid)
    ones = torch.ones((x1.shape[0], 1), dtype=x1.dtype, device=x1.device)
    p1h = torch.cat([x1, ones], -1)
    p2h = torch.cat([x2, ones], -1)
    H = H * torch.sign(torch.sum(torch.sum(p2h * (p1h @ H.T), -1) * w_fit))

    Rs, ts, _ = decompose_homography(H)
    dev = uv1.device
    T1 = SE3(torch.eye(3, device=dev), torch.zeros(3, device=dev))
    n_goods, all_pts, all_good = [], [], []
    for R, t in zip(Rs, ts):
        T2 = SE3(R, t / torch.clamp(torch.linalg.norm(t), min=1e-9))
        pts, info = triangulate_midpoint(T1, T2, cam, uv1, uv2)
        e1 = torch.sum((project_pinhole(cam, pts) - uv1) ** 2, -1)
        e2 = torch.sum((project_pinhole(cam, pts @ T2.R.T + T2.t) - uv2) ** 2, -1)
        good = (
            valid
            & (info["z1"] > 0.0)
            & (info["z2"] > 0.0)
            & (info["cos_parallax"] < min_parallax_cos)
            & (e1 < max_reproj_px**2)
            & (e2 < max_reproj_px**2)
        )
        n_goods.append(torch.sum(good))
        all_pts.append(pts)
        all_good.append(good)
    n_goods = torch.stack(n_goods)
    best = torch.argmax(n_goods)
    t = ts[best]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-9)
    n_best = n_goods[best]
    ok = (n_best > 50) & (n_best > 0.5 * torch.sum(valid))
    return TwoViewInit(
        ok=ok,
        T2cw=torch.cat([Rs[best].reshape(-1), t]),
        points=torch.stack(all_pts)[best],
        point_ok=torch.stack(all_good)[best],
        n_good=n_best.to(torch.int32),
    )
