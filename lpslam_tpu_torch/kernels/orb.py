"""ORB feature extraction, batched over frames (port of
lpslam_tpu/kernels/orb.py).

Per pyramid level: two FAST score maps blended and non-max suppressed, grid
top-k keypoints, a 7-tap Gaussian blur, then the descriptor path of
``OrbParams.brief_mode``:
- "polar" (default): one 32x32 patch per keypoint (kernels/patch.py — the
  CUDA kernel on the GPU), the disc-moment orientation and the 256-bit
  polar-derotation BRIEF;
- "binned", "gather", "exact": the angle from whole-image moment maps
  (``orientation_maps``) read at the truncated keypoint, then the 12-degree
  binned pattern sampled from the keypoint's patch (binned, the patch kernel
  again) or from the image (gather), or the pattern rotated by the exact
  angle (exact).
``OrbParams.pallas_patches`` is "auto" or "on": both take the CUDA patch
kernel on the card and its plain version on the CPU, where "on" raises.
There is no "off": nothing routes card tensors to the plain gather. The
tables come from copies of the JAX package's numpy builders and are
bit-equal to its tables.

The FAST score (kernels/fast_nms.py — the CUDA kernels on the GPU) has the
JAX package's two forms. By default it is the composite's (``fast_score``
x2, a blend whose low-threshold ceiling follows the frame's max score,
``nms3x3``). ``OrbParams(use_pallas=True)`` takes the fused kernel's form
instead, whose ceiling is fixed; the depth trackers run it.

Descriptors are (N, 8) 32-bit words stored as int32 bit patterns.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .fast import select_topk_grid
from .fast_nms import fast_nms_score
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
    use_pallas: bool = False  # the fused FAST+NMS form (fixed ceiling)
    brief_mode: str = "polar"  # "polar" | "binned" | "gather" | "exact"
    pallas_patches: str = "auto"  # "auto" | "on": see the module docstring


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


def _disc_half_heights(radius: int = PATCH_RADIUS):
    """For each column offset dx of the disc, the max |dy| inside the circle."""
    dxs = np.arange(-radius, radius + 1)
    rys = np.floor(np.sqrt(np.maximum(radius * radius - dxs * dxs, 0))).astype(int)
    return list(zip(dxs.tolist(), rys.tolist()))


def _binned_sample_matrices():
    """(BINS, 1024, 512) one-hot selection: patch pixels -> 512 sample values
    (first 256 columns = point p of each pair, last 256 = point q). The JAX
    package's table; the port keeps only its argmax per column (_BIN_PIX)."""
    mats = np.zeros((N_ANGLE_BINS, _PATCH * _PATCH, 512), np.float32)
    pat = BRIEF_PATTERN
    for b in range(N_ANGLE_BINS):
        th = b * 2 * np.pi / N_ANGLE_BINS - np.pi
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        rot = pat @ R.T
        ix = np.clip(np.round(rot[..., 0]).astype(int), -_PB, _PB - 1) + _PB
        iy = np.clip(np.round(rot[..., 1]).astype(int), -_PB, _PB - 1) + _PB
        flat = iy * _PATCH + ix
        for pair in range(256):
            mats[b, flat[pair, 0], pair] = 1.0
            mats[b, flat[pair, 1], 256 + pair] = 1.0
    return mats


def _binned_offset_table():
    """(BINS, 512, 2) int32 (dy, dx) tap offsets of the quantized rotated
    pattern (first 256 = point p, last 256 = point q)."""
    pat = BRIEF_PATTERN
    offs = np.zeros((N_ANGLE_BINS, 512, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        th = b * 2 * np.pi / N_ANGLE_BINS - np.pi
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        rot = pat @ R.T
        ix = np.clip(np.round(rot[..., 0]).astype(int), -_PB, _PB - 1)
        iy = np.clip(np.round(rot[..., 1]).astype(int), -_PB, _PB - 1)
        offs[b, :256, 0] = iy[:, 0]
        offs[b, :256, 1] = ix[:, 0]
        offs[b, 256:, 0] = iy[:, 1]
        offs[b, 256:, 1] = ix[:, 1]
    return offs


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
_DISC_COLS = _disc_half_heights()
_OFFSET_TABLE = _binned_offset_table()
# the binned one-hot matrices (63 MB) as the patch pixel each of a bin's 512
# samples reads: the argmax of each column, (BINS, 512), built from the
# offsets the matrices are built from. Gathering it gives exactly the JAX
# package's fp32 one-hot product, without the (N, 30, 512) intermediate.
_BIN_PIX = ((_OFFSET_TABLE[..., 0] + _PB) * _PATCH + _OFFSET_TABLE[..., 1] + _PB).astype(np.int64)

_DEVICE_TABLES: dict = {}


def _tables(device):
    key = str(device)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = {
            name: torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            for name, arr in (
                ("pix", _POLAR_PIX), ("C", _DFT_C), ("S", _DFT_S),
                ("itap", _ITAP), ("mom", _MOM_W), ("bin_pix", _BIN_PIX),
                ("offsets", _OFFSET_TABLE.astype(np.int64)), ("pattern", BRIEF_PATTERN),
                ("ref_idx", _POLAR_REF_IDX.astype(np.int64)),
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


def steered_brief_polar(blurred, xy, angle):
    """Polar-derotation BRIEF from (B, H, W) level images, (B, N, 2)
    keypoints and (B, N) angles."""
    return polar_brief_from_patches(extract_patches(blurred, xy), angle)


def polar_tap_values_reference(patches, angle):
    """Exact-shift tap values of the polar descriptor (tests only): (..., 512)
    samples of the polar grid, taps [0:256] point p and [256:512] point q of
    each pair, the polar path's semantics without the DFT round trip."""
    tb = _tables(patches.device)
    pol = patches[..., tb["pix"]]
    return torch.gather(pol, -1, tb["ref_idx"][_bin_of(angle)])


def polar_brief_reference(patches, angle):
    """Exact-shift reference descriptor (tests only). Pairs whose two taps are
    exactly equal give an arbitrary bit here, where the DFT path decides them
    by ~1e-5 reconstruction noise: compare with a tie mask."""
    vals = polar_tap_values_reference(patches, angle)
    return pack_bits(vals[..., :256] < vals[..., 256:])


# ---------------------------------------------------------------------------
# The moment-map descriptor paths (brief_mode binned / gather / exact)
# ---------------------------------------------------------------------------


def orientation_maps(img):
    """Whole-image intensity-centroid moments (m10, m01) per pixel of
    (..., H, W) images, over the radius-15 disc as a stack of columns: each
    column sum is a vertical box filter (a cumulative sum read at two
    clamped rows), so
        m10 = sum_dx dx * roll_x(vbox_{ry(dx)}(I), -dx)
        m01 = sum_dy dy * roll_y(hbox_{rx(dy)}(I), -dy)
    with the JAX package's wrap-around rolls and clamped box edges, summed in
    its order."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    cv = torch.cat([img.new_zeros((*lead, 1, w)), torch.cumsum(img, dim=-2)], dim=-2)
    ch = torch.cat([img.new_zeros((*lead, h, 1)), torch.cumsum(img, dim=-1)], dim=-1)
    ys = torch.arange(h, device=img.device)
    xs = torch.arange(w, device=img.device)

    def vbox(r):
        top = torch.clamp(ys - r, 0, h)
        bot = torch.clamp(ys + r + 1, 0, h)
        return cv[..., bot, :] - cv[..., top, :]

    def hbox(r):
        left = torch.clamp(xs - r, 0, w)
        right = torch.clamp(xs + r + 1, 0, w)
        return ch[..., right] - ch[..., left]

    m10 = torch.zeros_like(img)
    m01 = torch.zeros_like(img)
    vcache, hcache = {}, {}
    for dx, ry in _DISC_COLS:
        if dx == 0:
            continue
        if ry not in vcache:
            vcache[ry] = vbox(ry)
        m10 = m10 + dx * torch.roll(vcache[ry], -dx, dims=-1)
    for dy, rx in _DISC_COLS:  # the circle is symmetric: the same table
        if dy == 0:
            continue
        if rx not in hcache:
            hcache[rx] = hbox(rx)
        m01 = m01 + dy * torch.roll(hcache[rx], -dy, dims=-2)
    return m10, m01


def _map_angle(m10_map, m01_map, xy):
    """Angles of (B, N, 2) keypoints from (B, H, W) moment maps, read at the
    truncated (not rounded) pixel, the flat index clamped as a JAX gather
    clamps it."""
    b, h, w = m10_map.shape
    idx = xy[..., 1].to(torch.int64) * w + xy[..., 0].to(torch.int64)
    idx = torch.clamp(idx, 0, h * w - 1)
    m10 = torch.gather(m10_map.reshape(b, -1), 1, idx)
    m01 = torch.gather(m01_map.reshape(b, -1), 1, idx)
    return torch.atan2(m01, m10)


def _binned_from_patches(patches, angle):
    vals = torch.gather(patches, -1, _tables(patches.device)["bin_pix"][_bin_of(angle)])
    return pack_bits(vals[..., :256] < vals[..., 256:])


def steered_brief_binned(blurred, xy, angle):
    """Angle-binned steered BRIEF (12-degree bins, the classic ORB trick):
    the 32x32 patch of each keypoint (kernels/patch.py: rounded centre,
    corner clamped to the level), sampled at its bin's 512 pattern pixels.
    (B, H, W), (B, N, 2), (B, N) -> (B, N, 8)."""
    return _binned_from_patches(extract_patches(blurred, xy), angle)


def steered_brief_gather(blurred, xy, angle):
    """The binned pattern sampled straight from the image: one flat 512-tap
    gather per keypoint around its rounded centre, clamped to
    [16, size - 17]. (B, H, W), (B, N, 2), (B, N) -> (B, N, 8)."""
    b, h, w = blurred.shape
    n = xy.shape[1]
    offs = _tables(blurred.device)["offsets"][_bin_of(angle)]      # (B, N, 512, 2)
    cx = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), _PB, w - _PB - 1)
    cy = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), _PB, h - _PB - 1)
    flat = (cy[..., None] + offs[..., 0]) * w + cx[..., None] + offs[..., 1]
    vals = torch.gather(blurred.reshape(b, -1), 1, flat.reshape(b, -1)).reshape(b, n, 512)
    return pack_bits(vals[..., :256] < vals[..., 256:])


def steered_brief(blurred, xy, angle):
    """Steered BRIEF at the exact angle: the pattern rotated per keypoint,
    each tap rounded and clamped to the image. (B, H, W), (B, N, 2), (B, N)
    -> (B, N, 8)."""
    b, h, w = blurred.shape
    n = xy.shape[1]
    ca, sa = torch.cos(angle), torch.sin(angle)
    R = torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], dim=-2)
    rotated = torch.einsum("bnij,pqj->bnpqi", R, _tables(blurred.device)["pattern"])
    pos = xy[:, :, None, None, :] + rotated                         # (B, N, 256, 2, 2)
    px = torch.clamp(torch.round(pos[..., 0]).to(torch.int64), 0, w - 1)
    py = torch.clamp(torch.round(pos[..., 1]).to(torch.int64), 0, h - 1)
    vals = torch.gather(blurred.reshape(b, -1), 1, (py * w + px).reshape(b, -1))
    vals = vals.reshape(b, n, 256, 2)
    return pack_bits(vals[..., 0] < vals[..., 1])


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------

BRIEF_MODES = ("polar", "binned", "gather", "exact")


def _patches(blurred, xy, pallas_patches: str):
    """The keypoints' patches by OrbParams.pallas_patches: "auto" dispatches
    on the device, "on" needs the CUDA kernel."""
    if pallas_patches not in ("auto", "on"):
        raise ValueError(f"unknown pallas_patches {pallas_patches!r}")
    if pallas_patches == "on" and blurred.device.type != "cuda":
        raise ValueError("pallas_patches='on' runs the CUDA patch kernel: needs CUDA tensors")
    return extract_patches(blurred, xy)


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
    if params.brief_mode not in BRIEF_MODES:
        raise ValueError(f"unknown brief_mode {params.brief_mode!r}")
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
        score = fast_nms_score(
            level_img, params.fast_threshold, params.fast_min_threshold,
            frame_ceiling=not params.use_pallas,
        )
        xy, sc, valid = select_topk_grid(
            score, k_lvl, cell=params.cell, border=EDGE_MARGIN
        )
        blurred = gaussian_blur(level_img, sigma=2.0, radius=3)
        if params.brief_mode == "polar":
            # one patch per keypoint feeds the disc-moment angle and the
            # polar descriptor
            patches = _patches(blurred, xy, params.pallas_patches)
            angle = patch_orientation(patches)
            desc = polar_brief_from_patches(patches, angle)
        else:
            angle = _map_angle(*orientation_maps(blurred), xy)
            if params.brief_mode == "binned":
                desc = _binned_from_patches(_patches(blurred, xy, params.pallas_patches), angle)
            elif params.brief_mode == "gather":
                desc = steered_brief_gather(blurred, xy, angle)
            else:
                desc = steered_brief(blurred, xy, angle)
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
