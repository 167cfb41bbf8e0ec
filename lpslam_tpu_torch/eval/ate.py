"""Trajectory evaluation: ATE with Sim3 (Umeyama) alignment and RPE, numpy
only (a copy of lpslam_tpu/eval/ate.py, which the port cannot import)."""
from __future__ import annotations

import numpy as np


def align_umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform: dst ≈ s * R @ src + t for (N, 3)
    point sets. Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, with_scale=True):
    """Absolute trajectory error RMSE after Sim3 (or SE3) alignment.
    Returns (rmse, aligned estimate)."""
    s, R, t = align_umeyama(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=1)
    return float(np.sqrt(np.mean(err**2))), aligned


def rpe_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, delta: int = 1):
    """Relative translation error RMSE over `delta`-frame steps, the steps
    scale-aligned first (the mono gauge)."""
    de = est_positions[delta:] - est_positions[:-delta]
    dg = gt_positions[delta:] - gt_positions[:-delta]
    s = (de * dg).sum() / max((de * de).sum(), 1e-12)
    err = np.linalg.norm(s * de - dg, axis=1)
    return float(np.sqrt(np.mean(err**2)))
