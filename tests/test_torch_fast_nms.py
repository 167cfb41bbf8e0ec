"""Port parity, the fused FAST+NMS score: lpslam_tpu_torch.kernels.fast_nms
vs lpslam_tpu.kernels.pallas_fast.fast_nms_score_pallas.

- The plain version against the Pallas kernel run in interpret mode, on the
  band path (160x128) and the small-level branch (48x96): within atol 1e-4,
  the bar of tests/test_pallas_kernels.py; and exactly equal to the JAX
  fixed-ceiling composite (fast_score x2 + blend + nms3x3).
- ``extract_orb(OrbParams(256, 2, use_pallas=True))`` against JAX with the
  Pallas kernel in interpret mode: level-0 keypoints and validity bit-equal,
  level 1 overlapping >= 0.97 (the pyramid's resize rounds differently).
- The frame-ceiling form (``frame_ceiling=True``, what ``extract_orb`` runs
  by default) against the JAX composite of lpslam_tpu/kernels/orb.py:520-525
  (fast_score x2, a blend whose ceiling is 1e-3 / (1 + the frame's max
  low-threshold score), nms3x3), frame by frame: bit-equal, on textures at
  several contrasts (the ceiling is one float32 division; torch's
  ``1e-3 / tensor`` rounds twice and was one ulp off on 3 of 12 such
  frames), on a batch with a flat frame, and on a many-ties fixture; the
  plain max pass equals each frame's jnp.max.
- The dispatcher: a batch equals its frames one by one in both forms, a
  device other than the CPU or a CUDA card raises, and the ``*_cuda``
  entry points refuse CPU tensors.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.io.synthetic import make_texture
from lpslam_tpu.kernels import orb as jorb
from lpslam_tpu.kernels import pallas_fast
from lpslam_tpu.kernels.fast import fast_score, nms3x3

from lpslam_tpu_torch.kernels import fast_nms
from lpslam_tpu_torch.kernels import orb as torb

torch.set_num_threads(1)


def _jax_composite(img, thr_hi=20.0, thr_lo=7.0):
    s_hi, _ = fast_score(img, thr_hi)
    s_lo, _ = fast_score(img, thr_lo)
    return nms3x3(jnp.where(s_hi > 0, 1.0 + s_hi, s_lo * (1e-3 / (1.0 + 255.0 * 16.0))))


@pytest.mark.parametrize("h,w,seed", [(160, 128, 4), (48, 96, 5)])
def test_reference_matches_pallas(h, w, seed):
    img = make_texture(h, w, seed=seed)
    ours = fast_nms.fast_nms_score(torch.from_numpy(img)[None])[0].numpy()
    interp = np.asarray(pallas_fast.fast_nms_score_pallas(jnp.asarray(img), interpret=True))
    np.testing.assert_allclose(ours, interp, atol=1e-4)
    np.testing.assert_array_equal(ours, np.asarray(_jax_composite(jnp.asarray(img))))
    assert (ours > 1.0).sum() > 20  # high-threshold corners are present


def _jax_frame_composite(img, thr_hi=20.0, thr_lo=7.0):
    """lpslam_tpu/kernels/orb.py:520-525 on one (H, W) frame."""
    s_hi, _ = fast_score(img, thr_hi)
    s_lo, _ = fast_score(img, thr_lo)
    lo_ceiling = 1e-3 / (1.0 + jnp.max(s_lo))
    return nms3x3(jnp.where(s_hi > 0, 1.0 + s_hi, s_lo * lo_ceiling)), jnp.max(s_lo)


def _ties_image(h=64, w=80):
    """Identical corners on a grid: equal scores everywhere, plateaus kept."""
    img = np.full((h, w), 100.0, np.float32)
    for y in range(8, h - 8, 12):
        for x in range(8, w - 8, 12):
            img[y:y + 5, x:x + 5] = 160.0       # thr_hi corners
            img[y + 6:y + 9, x + 6:x + 9] = 110.0  # thr_lo-only corners
    return img


@pytest.mark.parametrize("case", ["contrasts", "flat_frame", "ties"])
def test_frame_ceiling_reference_matches_jax_composite(case):
    torch.set_num_threads(1)
    if case == "contrasts":
        frames = [make_texture(96, 128, seed=s) * np.float32(0.3 + 0.07 * s) for s in range(12)]
    elif case == "flat_frame":
        frames = [make_texture(72, 88, seed=3), np.full((72, 88), 37.0, np.float32),
                  make_texture(72, 88, seed=4) * np.float32(0.25)]
    else:
        frames = [_ties_image(), _ties_image() * np.float32(0.5)]
    batch = torch.from_numpy(np.stack(frames))
    ours = fast_nms.fast_nms_score(batch, 20.0, 7.0, frame_ceiling=True).numpy()
    maxima = fast_nms.fast_lo_max_reference(batch, 7.0).numpy()
    for i, f in enumerate(frames):
        want, want_max = _jax_frame_composite(jnp.asarray(f))
        np.testing.assert_array_equal(ours[i], np.asarray(want), err_msg=f"frame {i}")
        assert maxima[i] == np.float32(want_max)
    if case == "flat_frame":
        assert maxima[1] == 0.0 and not ours[1].any()
        assert (ours[0] > 0).sum() > 20 and (ours[2] > 0).sum() > 5
    if case == "ties":
        vals, counts = np.unique(ours[0][ours[0] > 0], return_counts=True)
        assert counts.max() >= 10                       # many equal scores
        assert ((ours[0] > 0) & (ours[0] < 1e-3)).any()   # low-threshold fill-ins
        assert (ours[0] > 1.0).any()
    # the two forms differ only in the ceiling: same corners, other low scores
    fixed = fast_nms.fast_nms_score(batch, 20.0, 7.0).numpy()
    np.testing.assert_array_equal(ours >= 1.0, fixed >= 1.0)
    np.testing.assert_array_equal(ours[ours >= 1.0], fixed[fixed >= 1.0])


def test_extract_orb_use_pallas_matches_jax(monkeypatch):
    # 128x176: a shape no other test extracts with use_pallas=True, so the
    # JAX trace cache cannot hand back another test's kernel stand-in
    monkeypatch.setattr(
        pallas_fast, "fast_nms_score_pallas",
        functools.partial(pallas_fast.fast_nms_score_pallas, interpret=True),
    )
    img = make_texture(128, 176, seed=12)
    params_j = jorb.OrbParams(256, 2, use_pallas=True)
    fj = [np.asarray(x) for x in jorb.extract_orb(jnp.asarray(img), params_j)]
    params_t = torb.OrbParams(256, 2, use_pallas=True)
    ft = [x.numpy() for x in torb.extract_orb(torch.from_numpy(img), params_t)]
    k0 = torb._level_budgets(256, 2, 1.2)[0]
    np.testing.assert_array_equal(ft[0][:k0], fj[0][:k0])
    np.testing.assert_array_equal(ft[5][:k0], fj[5][:k0])
    assert ft[5][:k0].sum() > 50
    set_j = {tuple(p) for p in fj[0][k0:][fj[5][k0:]]}
    set_t = {tuple(p) for p in ft[0][k0:][ft[5][k0:]]}
    assert len(set_j & set_t) / len(set_j) >= 0.97
    # the fixed ceiling changes the selection against the default composite
    fd = torb.extract_orb(torch.from_numpy(img), torb.OrbParams(256, 2))
    assert not np.array_equal(fd.score.numpy(), ft[3])


def test_dispatch_batches_and_refuses_other_devices():
    imgs = np.stack([make_texture(40, 56, seed=s) for s in (1, 2, 3)])
    for frame_ceiling in (False, True):
        batch = fast_nms.fast_nms_score(torch.from_numpy(imgs), 20.0, 7.0, frame_ceiling)
        for i in range(3):
            one = fast_nms.fast_nms_score_reference(
                torch.from_numpy(imgs[i:i + 1]), 20.0, 7.0, frame_ceiling)
            assert torch.equal(batch[i:i + 1], one)
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score(torch.zeros((1, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score_cuda(torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score_cuda(torch.zeros((1, 8, 8)), frame_ceiling=True)
    with pytest.raises(ValueError):
        fast_nms.fast_lo_max_cuda(torch.zeros((1, 8, 8)))
