"""The port's hand-written CUDA kernels on the card (no JAX: the machine with
the card has none). Every test here needs an NVIDIA card and skips without
one; run them there with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

- The patch kernel must be bit-equal to its plain PyTorch version on the
  border, half-to-even and tail cases, and count exactly one launch.
- The FAST+NMS kernel must be bit-equal to its plain version at the
  operating point's level shapes, a level under 80 rows, an odd size and a
  level barely over the 7 rows FAST needs, and count one launch per call.
- ``extract_orb`` on the card must launch the patch kernel (and, with
  ``use_pallas=True``, the FAST+NMS kernel) once per pyramid level and agree
  with the same extraction on the CPU. Matmuls sum in another order there,
  and descriptor pairs whose two taps nearly tie are decided by that
  rounding, so level-0 keypoints must overlap >= 0.97, angles agree within
  1e-4 rad and < 2% of the matched keypoints' descriptor bits differ. With
  ``use_pallas=True`` the level-0 score map is the kernel's, bit-equal to
  the CPU's, so level-0 keypoints must be equal. Readings on an H100 80GB
  HBM3 at 700 W (torch 2.11, CUDA 12.8), ten 240x320 textures (seeds
  11-20): the composite gave overlap 1.0, angle differences up to 2.9e-5 rad
  and 0.60-0.86% of the bits differing; ``use_pallas=True`` gave equal
  level-0 keypoints on all ten, angle differences up to 2.9e-5 rad and
  0.25-0.36% of the bits differing (at most 7 on one keypoint).
"""
import numpy as np
import pytest
import torch

from lpslam_tpu_torch.io.synthetic import make_texture
from lpslam_tpu_torch.kernels import fast_nms, orb, patch

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def test_patch_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(9)
    imgs = np.stack([make_texture(240, 320, seed=6), make_texture(240, 320, seed=7)])
    extra = np.array([[0, 0], [319, 239], [16, 16], [303, 223],
                      [20.5, 21.5], [-3, 400]], np.float32)
    xy = np.stack([
        np.concatenate([rng.uniform(0, [320, 240], (67, 2)).astype(np.float32), extra])
        for _ in range(2)
    ])
    img_d = torch.from_numpy(imgs).to(cuda_device)
    xy_d = torch.from_numpy(xy).to(cuda_device)
    before = patch.LAUNCHES
    got = patch.extract_patches(img_d, xy_d)
    torch.cuda.synchronize()
    assert patch.LAUNCHES == before + 1
    assert got.shape == (2, 73, 1024)
    assert torch.equal(got, patch.extract_patches_reference(img_d, xy_d))


@pytest.mark.parametrize("b,h,w", [(2, 480, 640), (16, 400, 533), (16, 333, 444),
                                   (3, 79, 97), (1, 37, 45), (2, 8, 8), (1, 10, 33)])
def test_fast_nms_kernel_matches_plain(cuda_device, b, h, w):
    rng = np.random.default_rng(h * w)
    x = (rng.random((b, h, w)) * 255).astype(np.float32)
    x[:, :, :4] = rng.choice([0.0, 255.0], (b, h, min(4, w)))  # border corners
    tex = np.stack([make_texture(max(h, 20), max(w, 20), seed=i)[:h, :w] for i in range(b)])
    for arr in (x, np.ascontiguousarray(tex)):
        img = torch.from_numpy(arr).to(cuda_device)
        before = fast_nms.LAUNCHES
        got = fast_nms.fast_nms_score(img, 20.0, 7.0)
        torch.cuda.synchronize()
        assert fast_nms.LAUNCHES == before + 1
        assert torch.equal(got, fast_nms.fast_nms_score_reference(img, 20.0, 7.0))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_extract_orb_on_card_matches_cpu(cuda_device, use_pallas):
    img = torch.from_numpy(np.stack([make_texture(240, 320, seed=s) for s in (11, 12)]))
    params = orb.OrbParams(512, 3, use_pallas=use_pallas)
    before, before_fast = patch.LAUNCHES, fast_nms.LAUNCHES
    got = orb.extract_orb(img.to(cuda_device), params)
    torch.cuda.synchronize()
    assert patch.LAUNCHES == before + params.num_levels
    assert fast_nms.LAUNCHES == before_fast + (params.num_levels if use_pallas else 0)
    want = orb.extract_orb(img, params)
    k0 = orb._level_budgets(512, 3, 1.2)[0]
    for b in range(2):
        xy_g, xy_c = got.xy[b, :k0].cpu().numpy(), want.xy[b, :k0].numpy()
        v_g, v_c = got.valid[b, :k0].cpu().numpy(), want.valid[b, :k0].numpy()
        if use_pallas:
            np.testing.assert_array_equal(xy_g, xy_c)
        set_c = {tuple(p) for p in xy_c[v_c]}
        set_g = {tuple(p) for p in xy_g[v_g]}
        assert len(set_c) > 50
        overlap = len(set_c & set_g) / len(set_c)
        assert overlap >= 0.97, overlap
        m = (xy_g == xy_c).all(1) & v_g & v_c
        np.testing.assert_allclose(got.angle[b, :k0].cpu().numpy()[m],
                                   want.angle[b, :k0].numpy()[m], atol=1e-4)
        bits = np.unpackbits(
            (got.desc[b, :k0].cpu().numpy()[m] ^ want.desc[b, :k0].numpy()[m]).view(np.uint8)
        )
        assert bits.mean() < 0.02, bits.mean()
