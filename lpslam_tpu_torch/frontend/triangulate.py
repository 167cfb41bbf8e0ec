"""Batched two-view midpoint triangulation
(port of lpslam_tpu/frontend/triangulate.py)."""
from __future__ import annotations

import torch

from ..geometry.camera import PinholeCamera, unproject_pinhole
from ..geometry.se3 import SE3


def triangulate_rays(o1, d1, o2, d2):
    """Midpoint of the common perpendicular of two ray bundles (N,3).
    Returns (p (N,3), s1, s2); a negative s is a point behind its camera."""
    a = torch.sum(d1 * d1, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d2 * d2, -1)
    w0 = o1 - o2
    d = torch.sum(d1 * w0, -1)
    e = torch.sum(d2 * w0, -1)
    denom = a * c - b * b
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    s1 = (b * e - c * d) / denom
    s2 = (a * e - b * d) / denom
    p1 = o1 + s1[:, None] * d1
    p2 = o2 + s2[:, None] * d2
    return 0.5 * (p1 + p2), s1, s2


def triangulate_midpoint(T1cw: SE3, T2cw: SE3, cam: PinholeCamera, uv1, uv2):
    """Triangulate pixel correspondences between two calibrated views.
    Returns (p_w (N,3), {"z1", "z2", "cos_parallax"})."""
    R1t = T1cw.R.T
    R2t = T2cw.R.T
    o1 = -R1t @ T1cw.t
    o2 = -R2t @ T2cw.t
    d1 = unproject_pinhole(cam, uv1) @ R1t.T
    d2 = unproject_pinhole(cam, uv2) @ R2t.T
    p, _, _ = triangulate_rays(o1.expand(d1.shape), d1, o2.expand(d2.shape), d2)
    z1 = (p @ T1cw.R.T)[:, 2] + T1cw.t[2]
    z2 = (p @ T2cw.R.T)[:, 2] + T2cw.t[2]
    d1n = d1 / torch.linalg.norm(d1, dim=-1, keepdim=True)
    d2n = d2 / torch.linalg.norm(d2, dim=-1, keepdim=True)
    cos_par = torch.sum(d1n * d2n, dim=-1)
    return p, {"z1": z1, "z2": z2, "cos_parallax": cos_par}
