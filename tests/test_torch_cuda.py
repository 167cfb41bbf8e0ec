"""The port's hand-written CUDA kernels on the card (no JAX: the machine with
the card has none). Every test here needs an NVIDIA card and skips without
one; run them there with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

- The patch kernel must be bit-equal to its plain PyTorch version on the
  border, half-to-even and tail cases, and count exactly one launch.
- ``extract_orb`` on the card must launch the patch kernel once per pyramid
  level and agree with the same extraction on the CPU. Matmuls sum in
  another order there, and descriptor pairs whose two taps nearly tie are
  decided by that rounding, so level-0 keypoints must overlap >= 0.97,
  angles agree within 1e-4 rad and < 2% of the matched keypoints'
  descriptor bits differ. On an H100 (torch 2.11, CUDA 12.8), ten 240x320
  textures (seeds 11-20) gave overlap 1.0, angle differences up to
  2.9e-5 rad and 0.60-0.86% of the bits differing.
"""
import numpy as np
import pytest
import torch

from lpslam_tpu_torch.io.synthetic import make_texture
from lpslam_tpu_torch.kernels import orb, patch

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


def test_extract_orb_on_card_matches_cpu(cuda_device):
    img = torch.from_numpy(np.stack([make_texture(240, 320, seed=s) for s in (11, 12)]))
    params = orb.OrbParams(512, 3)
    before = patch.LAUNCHES
    got = orb.extract_orb(img.to(cuda_device), params)
    torch.cuda.synchronize()
    assert patch.LAUNCHES == before + params.num_levels
    want = orb.extract_orb(img, params)
    k0 = orb._level_budgets(512, 3, 1.2)[0]
    for b in range(2):
        xy_g, xy_c = got.xy[b, :k0].cpu().numpy(), want.xy[b, :k0].numpy()
        v_g, v_c = got.valid[b, :k0].cpu().numpy(), want.valid[b, :k0].numpy()
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
