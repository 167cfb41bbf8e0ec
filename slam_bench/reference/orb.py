"""The plain reference's ORB extraction: FAST-9/16 at two thresholds,
blended and non-max suppressed, grid top-k, a 7-tap Gaussian blur, the
disc-moment angle and the 256-bit polar-derotation BRIEF, per pyramid level.

Frozen copies of the port's plain versions (kernels/pyramid.py, fast.py,
fast_nms.py's fast_nms_score_reference with the per-frame ceiling,
patch.py's extract_patches_reference, orb.py's polar path and tables), in
float32 torch, with no kernel and no dispatch. Imports nothing of the
program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

EDGE_MARGIN = 16
PATCH_RADIUS = 15
N_ANGLE_BINS = 30
_PB = 16
_PATCH = 2 * _PB
_T_POLAR = 60
_R_POLAR = 14
_K_FREQ = _T_POLAR // 2 + 1


class Orb(NamedTuple):
    num_keypoints: int = 1200
    num_levels: int = 3
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    cell: int = 16


class Features(NamedTuple):
    xy: torch.Tensor      # (N, 2) level-0 pixels
    level: torch.Tensor   # (N,)
    angle: torch.Tensor   # (N,)
    desc: torch.Tensor    # (N, 8) int32 bit patterns
    valid: torch.Tensor   # (N,) bool



def pyramid_shapes(h: int, w: int, num_levels: int, scale_factor: float):
    """Per-level (h, w) as python ints."""
    shapes = []
    for lvl in range(num_levels):
        s = scale_factor**lvl
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def gaussian_kernel1d(sigma: float, radius: int, device=None):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img, sigma: float = 2.0, radius: int = 3):
    """Separable Gaussian blur with edge-replicate padding: rows first, then
    columns, each a shift-and-add over the 2r+1 taps in the JAX order."""
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    k = gaussian_kernel1d(sigma, radius, device=x.device)
    h, w = x.shape[-2:]
    xpad = F.pad(x[:, None], (0, 0, radius, radius), mode="replicate")[:, 0]
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + k[i] * xpad[:, i:i + h, :]
    ypad = F.pad(out[:, None], (radius, radius, 0, 0), mode="replicate")[:, 0]
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + k[i] * ypad[:, :, i:i + w]
    return out[0] if squeeze else out


def build_pyramid(img, num_levels: int = 3, scale_factor: float = 1.2):
    """(B, H, W) or (H, W) float32 -> tuple of per-level images.

    Each level is an antialiased bilinear resize of the previous one, as
    ``jax.image.resize(method="linear")`` does when it shrinks."""
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    h, w = x.shape[-2:]
    shapes = pyramid_shapes(h, w, num_levels, scale_factor)
    levels = [x]
    for lvl in range(1, num_levels):
        levels.append(
            F.interpolate(
                levels[-1][:, None], size=shapes[lvl], mode="bilinear",
                align_corners=False, antialias=True,
            )[:, 0]
        )
    return tuple(lv[0] for lv in levels) if squeeze else tuple(levels)


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


def frame_lo_ceiling(max_lo):
    return torch.full_like(max_lo, 1e-3) / (1.0 + max_lo)


def fast_nms_score(img, thr_hi: float, thr_lo: float):
    """(B, H, W) -> blended, non-max-suppressed FAST scores, the low
    threshold's ceiling from each frame's largest low-threshold score."""
    s_hi, _ = fast_score(img, thr_hi)
    s_lo, _ = fast_score(img, thr_lo)
    ceiling = frame_lo_ceiling(torch.amax(s_lo, dim=(-2, -1), keepdim=True))
    return nms3x3(torch.where(s_hi > 0, 1.0 + s_hi, s_lo * ceiling))


def _corners(xy, h: int, w: int):
    x0 = torch.clamp(torch.round(xy[..., 0]).to(torch.int64) - _PB, 0, w - _PATCH)
    y0 = torch.clamp(torch.round(xy[..., 1]).to(torch.int64) - _PB, 0, h - _PATCH)
    return x0, y0


def extract_patches(blurred, xy):
    """(B, H, W) images, (B, N, 2) keypoints -> (B, N, 1024) patches."""
    b, h, w = blurred.shape
    x0, y0 = _corners(xy, h, w)
    off = torch.arange(_PATCH, device=blurred.device)
    rows = y0[..., None, None] + off[:, None]
    cols = x0[..., None, None] + off[None, :]
    flat_idx = (rows * w + cols).reshape(b, -1)
    out = torch.gather(blurred.reshape(b, -1), 1, flat_idx)
    return out.reshape(b, xy.shape[1], _PATCH * _PATCH)


def _make_pattern(n_pairs: int = 256, radius: float = 13.0, seed: int = 7):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, radius / 2.0, size=(n_pairs, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, radius / np.maximum(norm, 1e-9))
    return (pts * scale).astype(np.float32)


def _polar_tables():
    """(POLAR_SEL (1024, R*T), DFT_C (T, K), DFT_S (T, K), ITAP (2*R*K, 512),
    POLAR_REF_IDX (30, 512)) as numpy arrays."""
    pat = _make_pattern()
    pts = np.concatenate([pat[:, 0, :], pat[:, 1, :]], 0)
    r = np.linalg.norm(pts, axis=1)
    th = np.arctan2(pts[:, 1], pts[:, 0])
    ring = np.clip(np.round(r).astype(int), 0, _R_POLAR - 1)
    jq = np.round((th + np.pi) / (2 * np.pi / _T_POLAR)).astype(int) % _T_POLAR

    sel = np.zeros((_PATCH * _PATCH, _R_POLAR * _T_POLAR), np.float32)
    for i in range(_R_POLAR):
        for j in range(_T_POLAR):
            thj = j * 2 * np.pi / _T_POLAR - np.pi
            px = int(np.clip(np.round(i * np.cos(thj)), -_PB, _PB - 1))
            py = int(np.clip(np.round(i * np.sin(thj)), -_PB, _PB - 1))
            sel[(py + _PB) * _PATCH + (px + _PB), i * _T_POLAR + j] = 1.0

    jj = np.arange(_T_POLAR)[:, None]
    kk = np.arange(_K_FREQ)[None, :]
    C = np.cos(2 * np.pi * jj * kk / _T_POLAR).astype(np.float32)
    S = np.sin(2 * np.pi * jj * kk / _T_POLAR).astype(np.float32)

    w = np.full(_K_FREQ, 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    itap = np.zeros((2 * _R_POLAR * _K_FREQ, 512), np.float32)
    for q in range(512):
        kq = np.arange(_K_FREQ)
        base = ring[q] * _K_FREQ
        ang = 2 * np.pi * kq * jq[q] / _T_POLAR
        itap[base + kq, q] = (w / _T_POLAR) * np.cos(ang)
        itap[_R_POLAR * _K_FREQ + base + kq, q] = (w / _T_POLAR) * np.sin(ang)

    shift = 2 * np.arange(N_ANGLE_BINS) - N_ANGLE_BINS
    jrot = (jq[None, :] + shift[:, None]) % _T_POLAR
    flat_ref = ring[None, :] * _T_POLAR + jrot
    return sel, C, S, itap, flat_ref.astype(np.int32)


def _mom_weights():
    dxg, dyg = np.meshgrid(np.arange(-_PB, _PB), np.arange(-_PB, _PB))
    disc = (dxg**2 + dyg**2) <= PATCH_RADIUS**2
    return np.stack(
        [(dxg * disc).reshape(-1), (dyg * disc).reshape(-1)], 1
    ).astype(np.float32)


BRIEF_PATTERN = _make_pattern()
_POLAR_SEL, _DFT_C, _DFT_S, _ITAP, _POLAR_REF_IDX = _polar_tables()
_POLAR_PIX = np.argmax(_POLAR_SEL, axis=0).astype(np.int64)
_TABLES = {
    "pix": torch.from_numpy(_POLAR_PIX), "C": torch.from_numpy(_DFT_C),
    "S": torch.from_numpy(_DFT_S), "itap": torch.from_numpy(_ITAP),
    "mom": torch.from_numpy(_mom_weights()),
}


def patch_orientation(patches):
    m = patches @ _TABLES["mom"]
    return torch.atan2(m[..., 1], m[..., 0])


def _bin_of(angle):
    return torch.remainder(
        torch.round((angle + np.pi) * (N_ANGLE_BINS / (2 * np.pi))).to(torch.int64),
        N_ANGLE_BINS,
    )


def polar_coeffs(patches):
    """Ring-wise real-DFT coefficients (a, b), each (..., R, K), of the
    polar-resampled (..., 1024) patches."""
    tb = _TABLES
    pol = patches[..., tb["pix"]].reshape(*patches.shape[:-1], _R_POLAR, _T_POLAR)
    return pol @ tb["C"], pol @ tb["S"]


def pack_bits(bits):
    """(..., 256) bool -> (..., 8) int32 bit patterns of the uint32 words
    (bit i of word j is pair 32*j + i)."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(
        bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64) << shifts, dim=-1
    )
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def polar_brief_from_patches(patches, angle):
    """256-bit steered BRIEF via polar derotation of (..., 1024) patches."""
    tb = _TABLES
    a, b = polar_coeffs(patches)
    s = (2 * _bin_of(angle) - N_ANGLE_BINS).to(torch.float32)
    k = torch.arange(_K_FREQ, dtype=torch.float32, device=patches.device)
    phi = (2 * np.pi / _T_POLAR) * s[..., None] * k
    cphi = torch.cos(phi)[..., None, :]
    sphi = torch.sin(phi)[..., None, :]
    a2 = a * cphi + b * sphi
    b2 = b * cphi - a * sphi
    lead = patches.shape[:-1]
    coef = torch.cat([a2.reshape(*lead, -1), b2.reshape(*lead, -1)], dim=-1)
    vals = coef @ tb["itap"]
    return pack_bits(vals[..., :256] < vals[..., 256:])


def _level_budgets(n: int, num_levels: int, scale: float):
    wts = np.array([1.0 / scale**l for l in range(num_levels)])
    wts = wts / wts.sum()
    ks = [int(round(n * w)) for w in wts]
    ks[0] += n - sum(ks)
    return ks


def extract_orb(img, params: Orb) -> Features:
    """(H, W) float32 [0, 255] image -> Features with params.num_keypoints
    slots, level by level as the program lays them out."""
    levels = build_pyramid(img[None], params.num_levels, params.scale_factor)
    budgets = _level_budgets(params.num_keypoints, params.num_levels, params.scale_factor)
    parts = []
    for lvl, (level_img, k_lvl) in enumerate(zip(levels, budgets)):
        if k_lvl <= 0:
            continue
        score = fast_nms_score(level_img, params.fast_threshold, params.fast_min_threshold)
        xy, _, valid = select_topk_grid(score, k_lvl, cell=params.cell, border=EDGE_MARGIN)
        blurred = gaussian_blur(level_img, sigma=2.0, radius=3)
        patches = extract_patches(blurred, xy)
        angle = patch_orientation(patches)
        desc = polar_brief_from_patches(patches, angle)
        scale_l = torch.tensor(params.scale_factor ** lvl, dtype=torch.float32)
        parts.append((xy[0] * scale_l, torch.full((k_lvl,), lvl, dtype=torch.int32),
                      angle[0], desc[0], valid[0]))
    return Features(*(torch.cat(p, 0) for p in zip(*parts)))
