"""Port parity, the descriptor modes of ``OrbParams.brief_mode`` (binned,
gather, exact) and their orientation maps: lpslam_tpu_torch.kernels.orb
against lpslam_tpu.kernels.orb on the CPU.

Tolerances, with their reasons:
- The tables (pattern offsets, the one-hot sample matrices, the disc) are
  bit-equal; the port keeps the (30, 1024, 512) matrices as their argmax per
  column, which must be JAX's argmax.
- ``orientation_maps``: the two packages' fp32 cumulative sums add in other
  orders, so the moment maps agree within 2e-6 of the largest moment (seen:
  at most 1.04e-6 on these textures) and the angle atan2(m01, m10) within
  5e-4 rad where the centroid is strong (|m| > 1e3, the JAX package's own
  test's bar): an error of 2e-6 x max|m| < 0.8 over |m| > 1e3 turns the
  angle by < 8e-4, and 1.04e-4 rad was the most seen.
- The three descriptor functions fed the same numpy angles: bit-equal (they
  round, clamp and compare the same floats).
- ``extract_orb``: level-0 keypoints bit-equal, every level's set overlaps
  >= 0.97 (the pyramid's resize rounds differently, as in
  tests/test_torch_orb.py). All slots are compared, valid or not (invalid
  slots sit at the border). Angles agree within 5e-4 rad at strong
  centroids. A descriptor bit may differ only where the angle is weak
  (|m| <= 1e3: its bin is noise), where the JAX angle lies within 5e-4 rad
  of a 12-degree bin edge (binned, gather) or a rotated tap within 1e-2 px
  of a rounding edge (exact), or where the pair's two taps nearly tie
  (< 1e-3 apart): the textures are piecewise constant, and the JAX package
  decides such pairs differently jitted and eagerly (its fused blur rounds
  otherwise). Those exceptions are counted and must stay below the ties,
  and the ties under 30% of the bits (11.6-20.4% on these textures).
- ``polar_brief_reference`` against ``polar_brief_from_patches``: equal
  outside the JAX package's tie mask, in both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lpslam_tpu.io.synthetic import make_texture
from lpslam_tpu.kernels import orb as jorb
from lpslam_tpu.kernels.pyramid import build_pyramid, gaussian_blur

from lpslam_tpu_torch.kernels import orb as torb

torch.set_num_threads(1)

MODES = ("binned", "gather", "exact")
STRONG = 1e3          # |m| of a strong centroid
ANGLE_TOL = 5e-4      # rad, at strong centroids
TIE = 1e-3            # taps closer than this decide their bit by rounding
BIN = 2 * np.pi / jorb.N_ANGLE_BINS


def _bits(desc):
    return np.unpackbits(
        np.ascontiguousarray(desc).view(np.uint8), axis=-1, bitorder="little"
    ).astype(bool)


def _blurred(h=120, w=160, seed=11):
    img = make_texture(h, w, seed=seed)
    return np.asarray(gaussian_blur(jnp.asarray(img), sigma=2.0, radius=3))


def test_binned_tables_bit_equal():
    assert torb._disc_half_heights() == jorb._disc_half_heights()
    assert torb._DISC_COLS == jorb._DISC_COLS
    np.testing.assert_array_equal(torb._OFFSET_TABLE, np.asarray(jorb._OFFSET_TABLE))
    ref = np.asarray(jorb._SAMPLE_MATS)
    ours = torb._binned_sample_matrices()
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(torb._BIN_PIX, np.argmax(ref, axis=1))
    assert (ref.sum(axis=1) == 1).all()          # one-hot: a gather is the product


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_orientation_maps_match_jax(seed):
    bl = _blurred(seed=seed)
    jm = [np.asarray(x) for x in jax.jit(jorb.orientation_maps)(jnp.asarray(bl))]
    batch = torch.from_numpy(np.stack([bl, _blurred(seed=seed + 10)]))
    tm = [x.numpy() for x in torb.orientation_maps(batch)]
    one = [x[0].numpy() for x in torb.orientation_maps(batch[:1])]
    scale = max(np.abs(jm[0]).max(), np.abs(jm[1]).max())
    for j, t, o in zip(jm, tm, one):
        np.testing.assert_array_equal(t[0], o)           # batched rows = single frames
        assert np.abs(t[0] - j).max() <= 2e-6 * scale
    strong = np.hypot(*jm) > STRONG
    assert strong.mean() > 0.9
    da = np.angle(np.exp(1j * (np.arctan2(jm[1], jm[0]) - np.arctan2(tm[1][0], tm[0][0]))))
    assert np.abs(da[strong]).max() <= ANGLE_TOL


def _keypoints(n, h, w, seed=0):
    """Keypoints anywhere in the level (invalid slots sit at the border):
    the corners, exact .5 centres and points outside the image too."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform([0, 0], [w, h], (n, 2)).astype(np.float32)
    xy[:8] = [[0, 0], [w - 0.1, h - 0.1], [16.5, 16.5], [w - 16.5, h - 16.5],
              [15.5, 20.0], [w - 17.5, 30.5], [-3.0, h + 5.0], [w + 2.0, -1.0]]
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang[:3] = [np.pi, -np.pi, 0.0]
    return xy, ang


@pytest.mark.parametrize("name", ["steered_brief_binned", "steered_brief_gather",
                                  "steered_brief", "steered_brief_polar"])
def test_descriptors_fed_the_same_angles_bit_equal(name):
    bl = _blurred()
    xy, ang = _keypoints(300, *bl.shape)
    ref = np.asarray(jax.jit(getattr(jorb, name))(
        jnp.asarray(bl), jnp.asarray(xy), jnp.asarray(ang)))
    ours = getattr(torb, name)(torch.from_numpy(bl)[None], torch.from_numpy(xy)[None],
                               torch.from_numpy(ang)[None])[0].numpy()
    assert ours.dtype == np.int32 and ours.shape == (300, 8)
    if name == "steered_brief_polar":     # DFT reconstruction: ties are decided by noise
        patches = jorb.extract_patches(jnp.asarray(bl), jnp.asarray(xy))
        vals = np.asarray(jorb.polar_tap_values_reference(patches, jnp.asarray(ang)))
        tie = np.abs(vals[:, :256] - vals[:, 256:]) < TIE
        assert not ((_bits(ours) != _bits(ref)) & ~tie).any()
    else:
        np.testing.assert_array_equal(ours.view(np.uint32), ref)


def test_polar_reference_helpers_match_jax():
    bl = _blurred(seed=12)
    xy, ang = _keypoints(200, *bl.shape, seed=3)
    jp = jorb.extract_patches(jnp.asarray(bl), jnp.asarray(xy))
    tp = torb.extract_patches(torch.from_numpy(bl)[None], torch.from_numpy(xy)[None])
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))   # orb re-exports it
    ta = torch.from_numpy(ang)[None]
    jvals = np.asarray(jorb.polar_tap_values_reference(jp, jnp.asarray(ang)))
    tvals = torb.polar_tap_values_reference(tp, ta)[0].numpy()
    np.testing.assert_array_equal(tvals, jvals)         # a one-hot product is a gather
    np.testing.assert_array_equal(
        torb.polar_brief_reference(tp, ta)[0].numpy().view(np.uint32),
        np.asarray(jorb.polar_brief_reference(jp, jnp.asarray(ang))))
    # the reference against the DFT path, outside JAX's tie mask, in both packages
    tie = np.abs(jvals[:, :256] - jvals[:, 256:]) < TIE
    for ref, dft in ((jorb.polar_brief_reference(jp, jnp.asarray(ang)),
                      jorb.polar_brief_from_patches(jp, jnp.asarray(ang))),
                     (torb.polar_brief_reference(tp, ta)[0].numpy(),
                      torb.polar_brief_from_patches(tp, ta)[0].numpy())):
        differ = _bits(np.asarray(ref)) != _bits(np.asarray(dft))
        assert not (differ & ~tie).any()
    assert tie.mean() < 0.3          # the piecewise-constant texture ties ~a fifth of the pairs


def _tap_values(mode, bl, xy, ang):
    """The two taps of every pair, (N, 256, 2), as the mode samples them from
    the blurred level (numpy), and per pair its distance from an edge that a
    small change of angle moves it across: the bin edge (binned, gather) or
    the rounding edge of either rotated tap (exact), in rad and px."""
    h, w = bl.shape
    if mode == "exact":
        ca, sa = np.cos(ang.astype(np.float64)), np.sin(ang.astype(np.float64))
        pat = torb.BRIEF_PATTERN.astype(np.float64)                      # (256, 2, 2)
        rx = ca[:, None, None] * pat[..., 0] - sa[:, None, None] * pat[..., 1]
        ry = sa[:, None, None] * pat[..., 0] + ca[:, None, None] * pat[..., 1]
        px, py = xy[:, None, None, 0] + rx, xy[:, None, None, 1] + ry
        edge = np.minimum(np.abs(px - np.floor(px) - 0.5), np.abs(py - np.floor(py) - 0.5))
        px = np.clip(np.round(px).astype(int), 0, w - 1)
        py = np.clip(np.round(py).astype(int), 0, h - 1)
        return bl[py, px], edge.min(-1), 1e-2
    pos = (ang.astype(np.float64) + np.pi) / BIN
    edge = np.abs(pos - np.floor(pos) - 0.5) * BIN
    bins = np.mod(np.round((ang + np.float32(np.pi)) * np.float32(jorb.N_ANGLE_BINS / (2 * np.pi)))
                  .astype(int), jorb.N_ANGLE_BINS)
    offs = torb._OFFSET_TABLE[bins]                                       # (N, 512, 2)
    if mode == "gather":
        cx = np.clip(np.round(xy[:, 0]).astype(int), 16, w - 17)
        cy = np.clip(np.round(xy[:, 1]).astype(int), 16, h - 17)
    else:
        cx = np.clip(np.round(xy[:, 0]).astype(int) - 16, 0, w - 32) + 16
        cy = np.clip(np.round(xy[:, 1]).astype(int) - 16, 0, h - 32) + 16
    v = bl[cy[:, None] + offs[..., 0], cx[:, None] + offs[..., 1]]
    return np.stack([v[:, :256], v[:, 256:]], -1), np.repeat(edge[:, None], 256, 1), ANGLE_TOL


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("h,w,n,levels", [(120, 160, 256, 2), (240, 320, 512, 3)])
def test_extract_orb_brief_mode_parity(mode, h, w, n, levels):
    img = make_texture(h, w, seed=11)
    fj = [np.asarray(x) for x in
          jorb.extract_orb(jnp.asarray(img), jorb.OrbParams(n, levels, brief_mode=mode))]
    ft_b = torb.extract_orb(torch.from_numpy(np.stack([img, img])),
                            torb.OrbParams(n, levels, brief_mode=mode))
    ft = [x[0].numpy() for x in ft_b]
    np.testing.assert_array_equal(ft_b.desc[1].numpy(), ft[4])
    np.testing.assert_array_equal(ft[1], fj[1])

    pyr = build_pyramid(jnp.asarray(img), levels, 1.2)
    off = 0
    n_exc = n_ties = n_cmp = 0
    for lvl, k in enumerate(jorb._level_budgets(n, levels, 1.2)):
        sl = slice(off, off + k)
        off += k
        xy_j, xy_t = fj[0][sl], ft[0][sl]
        v_j, v_t = fj[5][sl], ft[5][sl]
        if lvl == 0:
            np.testing.assert_array_equal(xy_t, xy_j)
            np.testing.assert_array_equal(v_t, v_j)
        set_j = {tuple(p) for p in xy_j[v_j]}
        assert len(set_j) > 20
        assert len(set_j & {tuple(p) for p in xy_t[v_t]}) / len(set_j) >= 0.97, lvl
        same = (xy_j == xy_t).all(1)                     # every slot, valid or not
        blurred = np.asarray(gaussian_blur(pyr[lvl], sigma=2.0, radius=3))
        xy_l = xy_j[same] / np.float32(1.2 ** lvl)
        m10, m01 = [np.asarray(x) for x in jax.jit(jorb.orientation_maps)(jnp.asarray(blurred))]
        xi, yi = np.round(xy_l).astype(int).T          # integer pixels, up to the 1.2**l scaling
        strong = np.hypot(m10[yi, xi], m01[yi, xi]) > STRONG
        a_j, a_t = fj[2][sl][same], ft[2][sl][same]
        assert np.abs(np.angle(np.exp(1j * (a_j - a_t))))[strong].max() <= ANGLE_TOL
        taps, edge, margin = _tap_values(mode, blurred, xy_l, a_j)
        tie = np.abs(taps[..., 0] - taps[..., 1]) < TIE
        excused = tie | ~strong[:, None] | (edge < margin)
        mismatch = _bits(ft[4][sl][same]) != _bits(fj[4][sl][same])
        assert not (mismatch & ~excused).any(), (lvl, np.argwhere(mismatch & ~excused)[:5])
        n_exc += int((mismatch & ~tie).sum())
        n_ties += int(tie.sum())
        n_cmp += mismatch.size
    assert n_exc <= n_ties < 0.3 * n_cmp, (n_exc, n_ties, n_cmp)


def test_unknown_modes_raise():
    img = make_texture(120, 160, seed=11)
    with pytest.raises(ValueError, match="brief_mode"):
        jorb.extract_orb(jnp.asarray(img), jorb.OrbParams(64, 1, brief_mode="nope"))
    with pytest.raises(ValueError, match="brief_mode"):
        torb.extract_orb(torch.from_numpy(img), torb.OrbParams(64, 1, brief_mode="nope"))
    # patch extraction: "on" asks for the CUDA kernel, so CPU tensors raise;
    # there is no "off" (it would send card tensors to the plain gather)
    for mode in ("polar", "binned"):
        for p in ("on", "off", "x"):
            with pytest.raises(ValueError, match="pallas_patches"):
                torb.extract_orb(torch.from_numpy(img),
                                 torb.OrbParams(64, 1, brief_mode=mode, pallas_patches=p))
