"""Port parity, image kernels: lpslam_tpu_torch.kernels vs lpslam_tpu.kernels.

The same numpy inputs go through JAX on the CPU and through torch on the CPU
(the plain versions). Integer and selection work must be bit-equal; the
blur, remap and pyramid are held to stated float tolerances. The CUDA patch
kernel itself is tested on the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.io.synthetic import make_texture
from lpslam_tpu.kernels import fast as jfast
from lpslam_tpu.kernels import orb as jorb
from lpslam_tpu.kernels import pyramid as jpyr
from lpslam_tpu.kernels.pallas_patch import extract_patches_pallas
from lpslam_tpu.kernels.remap import remap_bilinear as j_remap

from lpslam_tpu_torch.kernels import fast as tfast
from lpslam_tpu_torch.kernels import patch as tpatch
from lpslam_tpu_torch.kernels import pyramid as tpyr
from lpslam_tpu_torch.kernels.remap import remap_bilinear as t_remap

torch.set_num_threads(1)


def _images():
    """Two textures plus a ties fixture: intensities quantized to 4 levels,
    so FAST scores form large exact plateaus."""
    a = make_texture(120, 160, seed=3)
    b = make_texture(120, 160, seed=4)
    q = (np.round(make_texture(120, 160, seed=5) / 64.0) * 64.0).astype(np.float32)
    return np.stack([a, b, q])


def _patch_case():
    rng = np.random.default_rng(9)
    imgs = np.stack([make_texture(240, 320, seed=6), make_texture(240, 320, seed=7)])
    # border-clamp cases, exact .5 centres (round half to even) and a
    # keypoint count that is no multiple of any block size
    extra = np.array([[0, 0], [319, 239], [16, 16], [303, 223],
                      [20.5, 21.5], [-3, 400]], np.float32)
    xy = np.stack([
        np.concatenate([rng.uniform(0, [320, 240], (68, 2)).astype(np.float32), extra])
        for _ in range(2)
    ])
    return imgs, xy


def test_patches_reference_bit_equal_to_jax_and_pallas():
    imgs, xy = _patch_case()
    ours = tpatch.extract_patches(torch.from_numpy(imgs), torch.from_numpy(xy)).numpy()
    assert ours.shape == (2, 74, 1024)
    for b in range(2):
        ref = np.asarray(jorb.extract_patches(jnp.asarray(imgs[b]), jnp.asarray(xy[b])))
        pal = np.asarray(
            extract_patches_pallas(jnp.asarray(imgs[b]), jnp.asarray(xy[b]), interpret=True)
        )
        np.testing.assert_array_equal(ours[b], ref)
        np.testing.assert_array_equal(ours[b], pal)


def test_patch_dispatch_rejects_unknown_device():
    imgs, xy = _patch_case()
    with pytest.raises(ValueError):
        tpatch.extract_patches(
            torch.from_numpy(imgs).to("meta"), torch.from_numpy(xy).to("meta")
        )


def test_patch_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA wrapper checks its inputs before it builds or launches
    anything, so CPU tensors raise here and no launch is counted."""
    imgs, xy = _patch_case()
    before = tpatch.LAUNCHES
    with pytest.raises(ValueError):
        tpatch.extract_patches_cuda(torch.from_numpy(imgs), torch.from_numpy(xy))
    assert tpatch.LAUNCHES == before


@pytest.mark.parametrize("thr", [20.0, 7.0])
def test_fast_score_and_nms_bit_equal(thr):
    imgs = _images()
    s_t, c_t = tfast.fast_score(torch.from_numpy(imgs), thr)
    n_t = tfast.nms3x3(s_t).numpy()
    for b in range(len(imgs)):
        s_j, c_j = jfast.fast_score(jnp.asarray(imgs[b]), thr)
        np.testing.assert_array_equal(s_t[b].numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(c_t[b].numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(n_t[b], np.asarray(jfast.nms3x3(s_j)))


@pytest.mark.parametrize("cell", [0, 16])
def test_select_topk_grid_bit_equal_with_ties(cell):
    imgs = _images()
    s_t, _ = tfast.fast_score(torch.from_numpy(imgs), 7.0)
    score = tfast.nms3x3(s_t)
    # many exact ties: the quantized frame's plateau count
    plateau = np.unique(score[2].numpy()[score[2].numpy() > 0], return_counts=True)[1]
    assert plateau.max() >= 10
    xy_t, sc_t, v_t = tfast.select_topk_grid(score, 150, cell=cell, border=16)
    for b in range(len(imgs)):
        xy_j, sc_j, v_j = jfast.select_topk_grid(
            jnp.asarray(score[b].numpy()), 150, cell=cell, border=16
        )
        np.testing.assert_array_equal(xy_t[b].numpy(), np.asarray(xy_j))
        np.testing.assert_array_equal(sc_t[b].numpy(), np.asarray(sc_j))
        np.testing.assert_array_equal(v_t[b].numpy(), np.asarray(v_j))


def test_blur_remap_pyramid_within_tolerance():
    imgs = np.stack([make_texture(240, 320, seed=s) for s in (1, 2)])
    bl_t = tpyr.gaussian_blur(torch.from_numpy(imgs)).numpy()
    lv_t = tpyr.build_pyramid(torch.from_numpy(imgs), 3, 1.2)
    rng = np.random.default_rng(0)
    grid = np.stack(np.meshgrid(np.arange(320.0), np.arange(240.0)), -1)
    grid = (grid + rng.uniform(-3, 3, grid.shape)).astype(np.float32)
    rm_t = t_remap(torch.from_numpy(imgs), torch.from_numpy(grid)).numpy()
    for b in range(2):
        img = jnp.asarray(imgs[b])
        np.testing.assert_allclose(bl_t[b], np.asarray(jpyr.gaussian_blur(img)), atol=1e-4)
        lv_j = jpyr.build_pyramid(img, 3, 1.2)
        for lt, lj in zip(lv_t, lv_j):
            assert lt[b].shape == lj.shape
            np.testing.assert_allclose(lt[b].numpy(), np.asarray(lj), atol=1e-2)
        np.testing.assert_allclose(
            rm_t[b], np.asarray(j_remap(img, jnp.asarray(grid))), atol=1e-3
        )

