"""Binary-descriptor matching (port of lpslam_tpu/kernels/match.py).

The Hamming matrix is the JAX package's ±1 product: d = (256 - a·b) / 2 over
unpacked {-1, +1} descriptors. It runs as an fp32 matmul, which is exact
because every partial sum is an integer of magnitude <= 256. Row/column
argmins pick the lowest index on ties, as jnp.argmin does.
"""
from __future__ import annotations

import numpy as np
import torch

from .fast import topk_stable

BITS = 256
WORDS = 8
BIG = 1e9


def _unpack_pm1(desc):
    """(..., N, 8) int32 bit patterns -> (..., N, 256) float32 in {-1, +1}."""
    words = desc.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], BITS).to(torch.float32) * 2.0 - 1.0


def hamming_matrix_mxu(desc_a, desc_b):
    """(Na, 8) x (Nb, 8) descriptors -> (Na, Nb) float32 Hamming distances."""
    dot = _unpack_pm1(desc_a) @ _unpack_pm1(desc_b).transpose(-1, -2)
    return (BITS - dot) * 0.5


def match_mutual_nn(desc_a, desc_b, valid_a, valid_b,
                    max_distance: int = 50, ratio: float = 0.9):
    """Mutual nearest neighbours with Lowe-ratio and distance gates.
    Returns (idx_b (Na,) int64, ok (Na,) bool)."""
    D = hamming_matrix_mxu(desc_a, desc_b)
    D = torch.where(valid_a[:, None] & valid_b[None, :], D, BIG)
    best_b = torch.argmin(D, dim=1)
    rows = torch.arange(D.shape[0], device=D.device)
    d1 = D[rows, best_b]
    D2 = D.clone()
    D2[rows, best_b] = BIG
    d2 = torch.amin(D2, dim=1)
    best_a_of_b = torch.argmin(D, dim=0)
    mutual = best_a_of_b[best_b] == rows
    ok = mutual & (d1 <= max_distance) & (d1 <= ratio * d2) & valid_a
    return best_b, ok


def match_projected(desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp,
                    radius, max_distance: int = 80):
    """Match queries (projected landmarks) against frame keypoints inside a
    pixel window. Returns (idx (Nq,) int64, ok (Nq,) bool)."""
    D = hamming_matrix_mxu(desc_q, desc_kp)
    d2px = torch.sum((uv_q[:, None, :] - uv_kp[None, :, :]) ** 2, dim=-1)
    in_window = d2px <= radius * radius
    D = torch.where(in_window & valid_q[:, None] & valid_kp[None, :], D, BIG)
    best = torch.argmin(D, dim=1)
    d1 = torch.gather(D, 1, best[:, None])[:, 0]
    ok = (d1 <= max_distance) & valid_q
    return best, ok


def orientation_consistency(angle_a, angle_b, idx, ok, bins: int = 30,
                            keep_top: int = 3):
    """Keep matches whose angle difference falls into the `keep_top` most
    populated of `bins` histogram bins (ties: lowest bin first)."""
    diff = angle_a - angle_b[idx]
    diff = torch.remainder(diff + np.pi, 2 * np.pi) - np.pi
    bin_idx = torch.clamp(
        ((diff + np.pi) * (bins / (2 * np.pi))).to(torch.int64), 0, bins - 1
    )
    hist = torch.zeros(bins, dtype=torch.int64, device=ok.device)
    hist.index_add_(0, bin_idx, ok.to(torch.int64))
    _, top_bins = topk_stable(hist, keep_top)
    in_top = torch.any(bin_idx[:, None] == top_bins[None, :], dim=1)
    return ok & in_top
