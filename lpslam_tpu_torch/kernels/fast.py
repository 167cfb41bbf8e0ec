"""FAST-9/16 corner detection, 3x3 NMS and grid top-K selection, batched over
frames (port of lpslam_tpu/kernels/fast.py).

The circle test's bitmask arithmetic runs in int64: the unrolled 32-bit mask
``m | (m << 16)`` is shifted right, and torch's int32 ``>>`` sign-extends.
Top-k breaks ties by the lowest index, as ``jax.lax.top_k`` does, through a
stable descending sort (``torch.topk`` gives no such order).
"""
from __future__ import annotations

import torch

# 16 (dx, dy) offsets on the radius-3 Bresenham circle, in circular order.
CIRCLE16 = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def _shift(img, dx: int, dy: int):
    """shifted[..., y, x] = img[..., y + dy, x + dx] (wrapping)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _interior(h: int, w: int, margin: int, device):
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)


def _has_run9(m16):
    m = m16 | (m16 << 16)
    r = m & (m >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)
    r = r & (m >> 8)
    return (r & 0xFFFF) != 0


def fast_score(img, threshold: float):
    """FAST-9/16 response of a (..., H, W) float32 image.

    Returns (score, is_corner) with the JAX semantics: score is the larger of
    the bright and dark sums of |tap - center| - t over the taps beyond the
    threshold, 0 where the 9-contiguous arc test fails; a 3-px border is 0.
    """
    c = img
    t = torch.tensor(threshold, dtype=torch.float32, device=img.device)
    bright_bits = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    dark_bits = torch.zeros_like(bright_bits)
    bright_sum = torch.zeros_like(img)
    dark_sum = torch.zeros_like(img)
    for i, (dx, dy) in enumerate(CIRCLE16):
        d = _shift(img, dx, dy) - c
        is_b = d > t
        is_d = d < -t
        bright_bits = bright_bits | (is_b.to(torch.int64) << i)
        dark_bits = dark_bits | (is_d.to(torch.int64) << i)
        bright_sum = bright_sum + torch.where(is_b, d - t, 0.0)
        dark_sum = dark_sum + torch.where(is_d, -d - t, 0.0)
    is_corner = _has_run9(bright_bits) | _has_run9(dark_bits)
    score = torch.where(is_corner, torch.maximum(bright_sum, dark_sum), 0.0)
    h, w = img.shape[-2:]
    interior = _interior(h, w, 3, img.device)
    return torch.where(interior, score, 0.0), is_corner & interior


def nms3x3(score):
    """Zero pixels with a strictly greater 3x3 neighbour; plateaus survive."""
    m = score
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            m = torch.where(_shift(score, dx, dy) > score, 0.0, m)
    return m


def topk_stable(x, k: int):
    """Top-k along the last dim, ties broken by lowest index (the
    ``jax.lax.top_k`` order). Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_grid(score, k: int, cell: int = 0, border: int = 16):
    """Top-k pixels of a (B, H, W) score map, per-cell pre-selection when
    cell > 0 (each cell offers at most m = min(2k // n_cells + 1, cell^2)
    candidates, then a global top-k). Returns (xy (B,k,2) float32,
    scores (B,k), valid (B,k) bool); an (H, W) map gives unbatched results.
    """
    squeeze = score.dim() == 2
    s = score[None] if squeeze else score
    b, h, w = s.shape
    s = torch.where(_interior(h, w, border, s.device), s, 0.0)

    if cell and cell > 0:
        ch = cell
        nby, nbx = h // ch, w // ch
        m = max(1, min((2 * k) // max(nby * nbx, 1) + 1, ch * ch))
        cells = (
            s[:, : nby * ch, : nbx * ch]
            .reshape(b, nby, ch, nbx, ch)
            .permute(0, 1, 3, 2, 4)
            .reshape(b, nby * nbx, ch * ch)
        )
        cs, ci = topk_stable(cells, m)                      # (B, n_cells, m)
        cell_id = torch.arange(nby * nbx, device=s.device)[:, None]
        cand_y = ((cell_id // nbx) * ch + ci // ch).reshape(b, -1)
        cand_x = ((cell_id % nbx) * ch + ci % ch).reshape(b, -1)
        cand_s = cs.reshape(b, -1)
        top_s, top_i = topk_stable(cand_s, min(k, cand_s.shape[1]))
        sel_y = torch.gather(cand_y, 1, top_i)
        sel_x = torch.gather(cand_x, 1, top_i)
    else:
        top_s, top_i = topk_stable(s.reshape(b, -1), k)
        sel_y = top_i // w
        sel_x = top_i % w

    if top_s.shape[1] < k:  # the cell path may offer fewer candidates
        pad = k - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad))
        sel_y = torch.nn.functional.pad(sel_y, (0, pad))
        sel_x = torch.nn.functional.pad(sel_x, (0, pad))

    valid = top_s > 0.0
    xy = torch.stack([sel_x, sel_y], dim=-1).to(torch.float32)
    if squeeze:
        return xy[0], top_s[0], valid[0]
    return xy, top_s, valid
