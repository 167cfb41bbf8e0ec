"""The yardstick of the kernels' roofline shares: the card's published
peaks, and the bytes and operations each hand kernel needs for the inputs
it was given (copies of the counts in the port's chip_smoke.py: bound_of,
fast_operations, the fused matcher's projected_bound). Each input byte is
counted read once and each output byte written once; the least time is the
larger of bytes over bandwidth and operations over the operation rate.
"""
from __future__ import annotations

import torch

from .reference.orb import _interior, fast_score

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12          # 67 TFLOP/s with an FMA counted as two operations
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9              # the published maximum boost clock
INT_PER_CLOCK = 64 * SM_COUNT     # 32-bit integer operations per clock
POPC_PER_CLOCK = 16 * SM_COUNT    # population counts per clock


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def fast_operations(img, thr_hi: float = 20.0, thr_lo: float = 7.0) -> int:
    """Operations the FAST score kernel needs on these (B, H, W) images:
    every pixel 12 (blend, 3x3 maximum, select); an interior pixel 20 for
    the compass test; a pixel with two bright or two dark compass taps at
    thr_lo 98; a thr_lo corner 19 for its sum plus 82 for the thr_hi masks
    and run tests; a thr_hi corner 19 for its sum."""
    b, h, w = img.shape
    d = [torch.roll(img, (-dy, -dx), (-2, -1)) - img
         for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
    nb = sum((x > thr_lo).int() for x in d)
    nd = sum((x < -thr_lo).int() for x in d)
    interior = _interior(h, w, 3, img.device)
    n_int = b * int(interior.sum())
    n_cand = int((((nb >= 2) | (nd >= 2)) & interior).sum())
    n_lo = int(fast_score(img, thr_lo)[1].sum())
    n_hi = int(fast_score(img, thr_hi)[1].sum())
    return 12 * b * h * w + 20 * n_int + 98 * n_cand + 19 * n_lo + 82 * n_lo + 19 * n_hi


def fast_score_bound_s(img, thr_hi: float, thr_lo: float) -> float:
    """One launch of the score kernel: read the images and one ceiling per
    frame, write the scores."""
    return bound_s(8 * img.numel() + 4 * img.shape[0],
                   fast_operations(img.float(), thr_hi, thr_lo))


def match_projected_bound_s(desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp, radius) -> float:
    """One launch of the fused projected matcher: each input read once and
    the outputs written once, against the bit counting of the pairs inside
    the window (15 integer operations and 8 population counts a pair)."""
    nq, nk = desc_q.shape[0], desc_kp.shape[0]
    n_bytes = (nq + nk) * (32 + 8 + 1) + nq * (8 + 1)
    d2 = ((uv_q[:, None, :] - uv_kp[None, :, :]) ** 2).sum(-1)
    inside = int(((d2 <= float(radius) ** 2) & valid_q[:, None] & valid_kp[None, :]).sum())
    t_ops = max(15 * inside / (INT_PER_CLOCK * SM_CLOCK_HZ),
                8 * inside / (POPC_PER_CLOCK * SM_CLOCK_HZ))
    return max(t_ops, n_bytes / HBM_BYTES_PER_S)
