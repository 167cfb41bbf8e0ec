"""Port parity, the fused FAST+NMS score: lpslam_tpu_torch.kernels.fast_nms
vs lpslam_tpu.kernels.pallas_fast.fast_nms_score_pallas.

- The plain version against the Pallas kernel run in interpret mode, on the
  band path (160x128) and the small-level branch (48x96): within atol 1e-4,
  the bar of tests/test_pallas_kernels.py; and exactly equal to the JAX
  fixed-ceiling composite (fast_score x2 + blend + nms3x3).
- ``extract_orb(OrbParams(256, 2, use_pallas=True))`` against JAX with the
  Pallas kernel in interpret mode: level-0 keypoints and validity bit-equal,
  level 1 overlapping >= 0.97 (the pyramid's resize rounds differently).
- The dispatcher: a batch equals its frames one by one, and a device other
  than the CPU or a CUDA card raises.
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
    batch = fast_nms.fast_nms_score(torch.from_numpy(imgs), 20.0, 7.0)
    for i in range(3):
        one = fast_nms.fast_nms_score_reference(torch.from_numpy(imgs[i:i + 1]), 20.0, 7.0)
        assert torch.equal(batch[i:i + 1], one)
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score(torch.zeros((1, 8, 8), device="meta"))
    with pytest.raises(ValueError):
        fast_nms.fast_nms_score_cuda(torch.zeros((1, 8, 8)))
