"""ORB feature extraction, polar-BRIEF path, batched over frames
(port of lpslam_tpu/kernels/orb.py).

Per pyramid level: two FAST score maps blended and non-max suppressed, grid
top-k keypoints, a 7-tap Gaussian blur, one 32x32 patch per keypoint
(kernels/patch.py — the CUDA kernel on the GPU), the disc-moment orientation
and the 256-bit polar-derotation BRIEF. The tables come from copies of the
JAX package's numpy builders and are bit-equal to its tables.

Only ``brief_mode="polar"`` is ported; the binned/gather/exact modes and the
fused FAST kernel stay in the reference. Descriptors are (N, 8) 32-bit words
stored as int32 bit patterns.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fast import fast_score, nms3x3, select_topk_grid
from .patch import extract_patches
from .pyramid import build_pyramid, gaussian_blur

EDGE_MARGIN = 16
PATCH_RADIUS = 15
N_ANGLE_BINS = 30
_PB = 16
_PATCH = 2 * _PB
_T_POLAR = 60
_R_POLAR = 14
_K_FREQ = _T_POLAR // 2 + 1


class OrbParams(NamedTuple):
    num_keypoints: int = 1024
    num_levels: int = 3
    scale_factor: float = 1.2
    fast_threshold: float = 20.0
    fast_min_threshold: float = 7.0
    cell: int = 16


class OrbFeatures(NamedTuple):
    """Fixed-capacity keypoint set (level-0 pixel coordinates); a leading
    frame axis when extracted from a (B, H, W) batch."""

    xy: torch.Tensor      # (..., N, 2) float32
    level: torch.Tensor   # (..., N) int32
    angle: torch.Tensor   # (..., N) float32 radians
    score: torch.Tensor   # (..., N) float32
    desc: torch.Tensor    # (..., N, 8) int32 bit patterns of the uint32 words
    valid: torch.Tensor   # (..., N) bool


# ---------------------------------------------------------------------------
# Tables (numpy builders copied from the JAX package)
# ---------------------------------------------------------------------------


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
_MOM_W = _mom_weights()
_BIT_WEIGHTS = (1 << np.arange(32)).astype(np.uint32)
# POLAR_SEL is one-hot per column: the patch pixel each polar sample reads.
# Gathering it gives exactly the fp32 one-hot product of the JAX package.
_POLAR_PIX = np.argmax(_POLAR_SEL, axis=0).astype(np.int64)

_DEVICE_TABLES: dict = {}


def _tables(device):
    key = str(device)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = {
            name: torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            for name, arr in (
                ("pix", _POLAR_PIX), ("C", _DFT_C), ("S", _DFT_S),
                ("itap", _ITAP), ("mom", _MOM_W),
            )
        }
    return _DEVICE_TABLES[key]


# ---------------------------------------------------------------------------
# Descriptor path
# ---------------------------------------------------------------------------


def patch_orientation(patches):
    """Intensity-centroid angle from (..., 1024) patches (radius-15 disc)."""
    m = patches @ _tables(patches.device)["mom"]
    return torch.atan2(m[..., 1], m[..., 0])


def _bin_of(angle):
    return torch.remainder(
        torch.round((angle + np.pi) * (N_ANGLE_BINS / (2 * np.pi))).to(torch.int64),
        N_ANGLE_BINS,
    )


def polar_coeffs(patches):
    """Ring-wise real-DFT coefficients (a, b), each (..., R, K), of the
    polar-resampled (..., 1024) patches."""
    tb = _tables(patches.device)
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
    tb = _tables(patches.device)
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


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------


def _level_budgets(n: int, num_levels: int, scale: float):
    wts = np.array([1.0 / scale**l for l in range(num_levels)])
    wts = wts / wts.sum()
    ks = [int(round(n * w)) for w in wts]
    ks[0] += n - sum(ks)
    return ks


def extract_orb(img, params: OrbParams = OrbParams()) -> OrbFeatures:
    """(H, W) or (B, H, W) float32 [0, 255] images -> OrbFeatures with
    N = params.num_keypoints slots per frame (leading B axis when batched).
    Runs on the device the images lie on."""
    if img.dim() == 2:
        return OrbFeatures(*(f[0] for f in extract_orb(img[None], params)))
    levels = build_pyramid(img, params.num_levels, params.scale_factor)
    budgets = _level_budgets(
        params.num_keypoints, params.num_levels, params.scale_factor
    )
    b = img.shape[0]
    feats = []
    for lvl, (level_img, k_lvl) in enumerate(zip(levels, budgets)):
        if k_lvl <= 0:
            continue
        score_hi, _ = fast_score(level_img, params.fast_threshold)
        score_lo, _ = fast_score(level_img, params.fast_min_threshold)
        # high-threshold corners dominate, low-threshold ones fill in
        lo_ceiling = 1e-3 / (1.0 + torch.amax(score_lo, dim=(-2, -1), keepdim=True))
        score = torch.where(score_hi > 0, 1.0 + score_hi, score_lo * lo_ceiling)
        score = nms3x3(score)
        xy, sc, valid = select_topk_grid(
            score, k_lvl, cell=params.cell, border=EDGE_MARGIN
        )
        blurred = gaussian_blur(level_img, sigma=2.0, radius=3)
        patches = extract_patches(blurred, xy)
        angle = patch_orientation(patches)
        desc = polar_brief_from_patches(patches, angle)
        scale_l = torch.tensor(
            params.scale_factor**lvl, dtype=torch.float32, device=img.device
        )
        feats.append(
            OrbFeatures(
                xy=xy * scale_l,
                level=torch.full((b, k_lvl), lvl, dtype=torch.int32, device=img.device),
                angle=angle,
                score=sc,
                desc=desc,
                valid=valid,
            )
        )
    return OrbFeatures(*(torch.cat(parts, dim=1) for parts in zip(*feats)))
