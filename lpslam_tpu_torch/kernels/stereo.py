"""Rectified stereo keypoint matching and disparity refinement (port of
lpslam_tpu/kernels/stereo.py).

A dense masked Hamming matrix (kernels/match.py::hamming_matrix, the CUDA
kernel on the card) between the left and right keypoint sets,
with the row and disparity constraints as masks, then mutual-best argmins.
Both argmins take the lowest index on ties, as ``jnp.argmin`` does.
"""
from __future__ import annotations

import torch

from .match import BIG, hamming_matrix


def match_stereo(desc_l, uv_l, valid_l, desc_r, uv_r, valid_r,
                 y_margin: float = 2.0, min_disparity: float = 0.5,
                 max_disparity: float = 256.0, max_hamming: int = 60):
    """For each left keypoint, its right partner on the same rectified row.

    Returns (disparity (Nl,) = u_l - u_r, idx_r (Nl,) int32, ok (Nl,))."""
    D = hamming_matrix(desc_l, desc_r).to(torch.float32)
    dy = torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    feas = (
        (dy <= y_margin)
        & (disp >= min_disparity)
        & (disp <= max_disparity)
        & valid_l[:, None]
        & valid_r[None, :]
    )
    D = torch.where(feas, D, BIG)
    idx = torch.argmin(D, dim=1)
    rows = torch.arange(desc_l.shape[0], device=D.device)
    best = D[rows, idx]
    # mutual best on the same matrix: the right keypoint must claim it back
    idx_back = torch.argmin(D, dim=0)
    mutual = idx_back[idx] == rows
    ok = (best <= max_hamming) & valid_l & mutual
    disparity = uv_l[:, 0] - uv_r[idx, 0]
    return disparity, idx.to(torch.int32), ok


def depth_from_disparity(disparity, focal_x_baseline: float):
    """z = fx * b / d. Callers mask with the `ok` flag of match_stereo."""
    return focal_x_baseline / torch.clamp(disparity, min=1e-6)


def refine_disparity_subpixel(img_l, img_r, uv_l, uv_r, ok,
                              half_win: int = 4, search: int = 2):
    """Sub-pixel disparity by a SAD parabola fit: a (2*half_win+1)^2 patch of
    the left image slides over the right image at the matched column +-
    `search` px. img_l / img_r: (H, W) float32; uv_l / uv_r: (N, 2) matched
    coordinates. Returns the refined disparity (N,), or the raw one where
    the match is not ok or the SAD curve is flat."""
    h, w = img_l.shape
    dev = img_l.device
    off = torch.arange(-half_win, half_win + 1, device=dev)
    dy = off[:, None].expand(-1, off.shape[0]).reshape(-1)
    dx = off[None, :].expand(off.shape[0], -1).reshape(-1)
    flat_l = img_l.reshape(-1)
    flat_r = img_r.reshape(-1)

    def patch(flat, cx, cy, off_x):
        px = torch.clamp(cx[:, None] + dx[None, :] + off_x, 0, w - 1)
        py = torch.clamp(cy[:, None] + dy[None, :], 0, h - 1)
        return flat[py * w + px]                                  # (N, win*win)

    # torch.round is half-to-even, as jnp.round
    xl = torch.round(uv_l[:, 0]).to(torch.int64)
    yl = torch.round(uv_l[:, 1]).to(torch.int64)
    xr = torch.round(uv_r[:, 0]).to(torch.int64)
    yr = torch.round(uv_r[:, 1]).to(torch.int64)

    ref = patch(flat_l, xl, yl, 0)
    offsets = range(-search, search + 1)
    sads = torch.stack(
        [torch.sum(torch.abs(patch(flat_r, xr, yr, e) - ref), dim=-1) for e in offsets],
        dim=-1,
    )                                                             # (N, 2*search+1)

    best = torch.argmin(sads, dim=-1)
    best_in = torch.clamp(best, 1, len(offsets) - 2)
    s0 = torch.gather(sads, 1, (best_in - 1)[:, None])[:, 0]
    s1 = torch.gather(sads, 1, best_in[:, None])[:, 0]
    s2 = torch.gather(sads, 1, (best_in + 1)[:, None])[:, 0]
    denom = s0 - 2.0 * s1 + s2
    delta = torch.where(
        torch.abs(denom) > 1e-6, 0.5 * (s0 - s2) / torch.clamp(denom, min=1e-6), 0.0
    )
    delta = torch.clamp(delta, -1.0, 1.0)
    e_best = (best_in - search).to(torch.float32) + delta

    disp0 = uv_l[:, 0] - uv_r[:, 0]
    refined = uv_l[:, 0] - (xr.to(torch.float32) + e_best)
    flat = torch.abs(denom) <= 1e-6
    return torch.where(ok & ~flat, refined, disp0)
