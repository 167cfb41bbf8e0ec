"""Port parity, the RGB-D slice: host initialization, then the chunked
tracking loop; and the host path after initialization, in lpslam_tpu and
lpslam_tpu_torch on the same frames (a 120x160 orbit over a textured plane
with exact depth maps, ``OrbParams(256, 2)`` with the default composite
FAST, ``MapConfig(16, 2048, 256)``, chunks of 8). The runner and the margins
are those of tests/test_torch_stereo_slice.py: the same initialization
frame, at least JAX's tracked count - 1 (the host path: the same statuses),
keyframes within +-1, landmarks within +-15%, and an ATE without scale
alignment <= max(1.5 x JAX, JAX + 0.02 m).
"""
import pytest
import torch

from lpslam_tpu.io.synthetic import make_sequence

from test_torch_stereo_slice import (
    assert_host_close, assert_slice_close, run_depth_host, run_depth_slice,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rgbd_seq():
    return make_sequence(num_frames=33, h=120, w=160, seed=1, motion="orbit", fx=115.0,
                         with_depth=True)


def test_rgbd_slice_matches_jax(rgbd_seq):
    ref = run_depth_slice("jax", "rgbd", rgbd_seq)
    ours = run_depth_slice("torch", "rgbd", rgbd_seq)
    assert_slice_close(ours, ref, 32)


def test_rgbd_host_path_matches_jax(rgbd_seq):
    ref = run_depth_host("jax", "rgbd", rgbd_seq, 14)
    ours = run_depth_host("torch", "rgbd", rgbd_seq, 14)
    assert_host_close(ours, ref)
