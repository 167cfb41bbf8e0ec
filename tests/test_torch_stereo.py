"""Port parity, the depth modes' modules: lpslam_tpu_torch.kernels.stereo,
frontend/stereo.py and geometry.camera.rectify_maps_stereo vs lpslam_tpu.

Tolerances:
- ``match_stereo``: indices, ``ok`` and disparities bit-equal (Hamming
  distances are exact integers in both; argmins take the lowest index on
  ties, which the fixture plants).
- ``refine_disparity_subpixel``, ``depth_from_disparity``: within 1e-5 on
  integer-valued images (the SAD sums are then exact in float32; the
  parabola's division rounds once in each package).
- Stereo and RGB-D keypoint depths (``StereoTracker._depths``,
  ``RGBDTracker._depths``, the functions the chunk loop's keyframe branch
  runs): ``ok`` bit-equal, depths within 1e-5 relative.
- ``insert_keyframe_depth`` on a map carried over from JAX with
  ``convert.map_from_numpy``: every integer and boolean field bit-equal,
  positions within 1e-4 m. The squared-distance matrix of the duplicate
  test rounds differently in the two matmuls, so the fixture keeps every
  candidate-landmark distance at least 20% away from its threshold (checked
  in float64); slot counts are then exact.
- ``rectify_maps_stereo`` (numpy) against the JAX package's cv2 path at the
  room's rig (R = I, t = [-0.11, 0, 0], 640x480): K_new and fx*b within
  1e-4 relative, maps within 1e-2 px. A rotated rig with another right
  camera: 2e-4 relative, 0.05 px. Measured on both: equal, maps bit-equal,
  since the port samples OpenCV 5.0's 9x9 grid over the pixel centres
  0..w-1, 0..h-1 in double (until then 1.8e-7 / 8.0e-5 relative).
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.frontend import TrackerConfig as JCfg
from lpslam_tpu.frontend import stereo as jfs
from lpslam_tpu.geometry import camera as jcam
from lpslam_tpu.geometry.se3 import SE3 as JSE3
from lpslam_tpu.io.synthetic import make_texture
from lpslam_tpu.kernels import orb as jorb
from lpslam_tpu.kernels import stereo as jst
from lpslam_tpu.mapstore import store as jstore

from lpslam_tpu_torch import convert
from lpslam_tpu_torch.frontend import TrackerConfig as TCfg
from lpslam_tpu_torch.frontend import stereo as tfs
from lpslam_tpu_torch.geometry import camera as tcam
from lpslam_tpu_torch.geometry.se3 import SE3 as TSE3
from lpslam_tpu_torch.kernels import orb as torb
from lpslam_tpu_torch.kernels import stereo as tst

torch.set_num_threads(1)

FX, CX, CY = 115.0, 80.0, 60.0


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _descs(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_match_stereo_matches_jax():
    rng = np.random.default_rng(3)
    nl, nr = 200, 230
    uv_l = np.stack([rng.uniform(20, 300, nl), rng.uniform(5, 230, nl)], 1).astype(np.float32)
    desc_l = _descs(rng, nl)
    perm = rng.permutation(nr)[:nl]
    uv_r = rng.uniform(0, 320, (nr, 2)).astype(np.float32)
    desc_r = _descs(rng, nr)
    uv_r[perm] = uv_l + np.stack([-rng.uniform(0.5, 30, nl), rng.uniform(-2.5, 2.5, nl)], 1)
    flip = rng.integers(0, 32, (nl, 2))
    desc_r[perm] = desc_l ^ (np.uint32(1) << flip[:, :1].astype(np.uint32))
    # planted ties: a second right keypoint with the same descriptor and row
    desc_r[perm[:20]] = desc_l[:20]
    twins = perm[20:40]
    uv_r[twins] = uv_r[perm[:20]] + np.float32(-1.0)
    desc_r[twins] = desc_l[:20]
    valid_l = rng.random(nl) > 0.05
    valid_r = rng.random(nr) > 0.05
    ref = [np.asarray(x) for x in jst.match_stereo(
        jnp.asarray(desc_l), jnp.asarray(uv_l), jnp.asarray(valid_l),
        jnp.asarray(desc_r), jnp.asarray(uv_r), jnp.asarray(valid_r))]
    ours = [x.numpy() for x in tst.match_stereo(
        _t(desc_l.view(np.int32)), _t(uv_l), _t(valid_l),
        _t(desc_r.view(np.int32)), _t(uv_r), _t(valid_r))]
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert 50 < ref[2].sum() < nl


def test_refine_disparity_and_depth_match_jax():
    rng = np.random.default_rng(5)
    h, w, n = 120, 160, 300
    img_l = np.round(make_texture(h, w, seed=7))
    img_r = np.round(np.roll(img_l, -3, axis=1) + rng.normal(0, 3, (h, w))).clip(0, 255)
    img_l, img_r = img_l.astype(np.float32), img_r.astype(np.float32)
    uv_l = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], 1).astype(np.float32)
    uv_l[:10] = np.floor(uv_l[:10]) + 0.5          # half-to-even rounding
    uv_l[10:14] = [[0, 0], [w - 1, h - 1], [2.5, 118.5], [158, 1]]
    uv_r = uv_l - np.array([3.0, 0.0], np.float32) + rng.normal(0, 0.4, (n, 2)).astype(np.float32)
    ok = rng.random(n) > 0.2
    ref = np.asarray(jst.refine_disparity_subpixel(
        jnp.asarray(img_l), jnp.asarray(img_r), jnp.asarray(uv_l), jnp.asarray(uv_r),
        jnp.asarray(ok)))
    ours = tst.refine_disparity_subpixel(_t(img_l), _t(img_r), _t(uv_l), _t(uv_r), _t(ok)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert np.abs(ref - (uv_l[:, 0] - uv_r[:, 0]))[ok].max() > 0.1  # it refined
    np.testing.assert_allclose(
        tst.depth_from_disparity(_t(ref), 11.5).numpy(),
        np.asarray(jst.depth_from_disparity(jnp.asarray(ref), 11.5)), rtol=1e-5)


def _cams():
    return (jcam.PinholeCamera.make(FX, FX, CX, CY),
            tcam.PinholeCamera.make(FX, FX, CX, CY, device="cpu"))


def test_stereo_keypoint_depths_match_jax():
    """StereoTracker._depths with the same left and right features in both
    packages (the stacked two-eye features, as the host path has them)."""
    left = make_texture(120, 160, seed=21)
    right = np.roll(left, -4, axis=1).astype(np.float32)
    params = jorb.OrbParams(256, 2)
    fl, fr = (jorb.extract_orb(jnp.asarray(x), params) for x in (left, right))
    jcam_, tcam_ = _cams()
    jt = jfs.StereoTracker(jcam_, FX * 0.1, JCfg(orb=params), depth_threshold=80.0)
    jt._last_left = jnp.asarray(left)
    jt._feats_lr = jax.tree.map(lambda a, b: jnp.stack([a, b]), fl, fr)
    z_j, ok_j = (np.asarray(x) for x in jt._depths(fl, right))

    def port(f):
        return convert.feats_from_numpy({k: np.asarray(v) for k, v in f._asdict().items()}, "cpu")

    tt = tfs.StereoTracker(tcam_, FX * 0.1, TCfg(orb=torb.OrbParams(256, 2)),
                           depth_threshold=80.0, device="cpu")
    tt._last_left = _t(left)
    pl, pr = port(fl), port(fr)
    tt._feats_lr = torb.OrbFeatures(*(torch.stack([a, b]) for a, b in zip(pl, pr)))
    z_t, ok_t = (x.numpy() for x in tt._depths(pl, right))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.sum() > 60
    np.testing.assert_allclose(z_t[ok_j], z_j[ok_j], rtol=1e-5)


def test_rgbd_keypoint_depths_match_jax():
    rng = np.random.default_rng(8)
    h, w, n = 120, 160, 400
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (2.0 + 0.01 * xs + 0.004 * ys).astype(np.float32)
    depth[:, 90:] = 6.0                              # a depth edge
    depth[100:, :20] = 0.05                          # below min_depth
    depth[:10, :] = 13.0                             # beyond max_depth
    xy = np.stack([rng.uniform(-2, w + 2, n), rng.uniform(-2, h + 2, n)], 1).astype(np.float32)
    valid = rng.random(n) > 0.1
    feats = {"xy": xy, "level": np.zeros(n, np.int32), "angle": np.zeros(n, np.float32),
             "score": np.ones(n, np.float32), "desc": _descs(rng, n), "valid": valid}
    jcam_, tcam_ = _cams()
    jt = jfs.RGBDTracker(jcam_, JCfg(), max_depth=12.0)
    z_j, ok_j = (np.asarray(x) for x in jt._depths(
        jorb.OrbFeatures(**{k: jnp.asarray(v) for k, v in feats.items()}), depth))
    tt = tfs.RGBDTracker(tcam_, TCfg(), max_depth=12.0, device="cpu")
    z_t, ok_t = (x.numpy() for x in tt._depths(convert.feats_from_numpy(feats, "cpu"), depth))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert 100 < ok_j.sum() < n - 50
    np.testing.assert_allclose(z_t, z_j, rtol=1e-5)


def _depth_insert_case(seed, near_capacity):
    rng = np.random.default_rng(seed)
    M, K, N = 512, 8, 64
    d = {k: np.array(v) for k, v in jstore.empty_map(jstore.MapConfig(K, M, N))._asdict().items()}
    n_lm = M - 6 if near_capacity else 120
    lm = np.concatenate([rng.uniform(-4, 4, (n_lm, 2)), rng.uniform(1, 6, (n_lm, 1))], 1)
    d["lm_valid"][:n_lm] = rng.random(n_lm) > 0.05
    d["lm_n_visible"][:n_lm] = rng.integers(0, 16, n_lm)
    d["lm_n_found"][:n_lm] = (d["lm_n_visible"][:n_lm] * rng.uniform(0, 1, n_lm)).astype(np.int32)
    d["lm_n_obs"][:n_lm] = rng.integers(1, 4, n_lm)
    d["lm_first_kf"][:n_lm] = rng.integers(0, 2, n_lm)
    d["lm_desc"][:n_lm] = _descs(rng, n_lm)
    d["n_lm"] = np.int32(n_lm)
    d["kf_valid"][:2] = True
    d["kf_frame_id"][:2] = [0, 3]
    d["n_kf"] = np.int32(2)

    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    t = np.array([0.1, -0.05, 0.2], np.float32)
    xy = np.stack([rng.uniform(0, 160, N), rng.uniform(0, 120, N)], 1).astype(np.float32)
    depth = rng.uniform(1.0, 5.0, N).astype(np.float32)
    depth_ok = rng.random(N) > 0.15
    valid = rng.random(N) > 0.05
    kp_lm = np.where(rng.random(N) < 0.25, rng.integers(0, n_lm, N), -1).astype(np.int32)
    # world points of the candidates (float64) and planted duplicates: an
    # existing landmark on top of 12 candidates, two of them poor (culled
    # first, so their candidates are made after all)
    rays = np.stack([(xy[:, 0] - CX) / FX, (xy[:, 1] - CY) / FX, np.ones(N)], 1) * depth[:, None]
    pts = (rays - t) @ R
    cand = np.flatnonzero(valid & depth_ok & (kp_lm < 0))[:12]
    slots = rng.choice(n_lm, 12, replace=False)
    lm[slots] = pts[cand] + rng.normal(0, 1e-3, (12, 3))
    d["lm_valid"][slots] = True
    d["lm_n_visible"][slots] = 4
    d["lm_n_visible"][slots[:2]] = 10
    d["lm_n_found"][slots] = 1
    d["lm_pos"][:n_lm] = lm.astype(np.float32)
    # every candidate-landmark distance is >= 20% away from its threshold
    d2 = ((pts[:, None, :] - d["lm_pos"][None, :n_lm].astype(np.float64)) ** 2).sum(-1)
    r2 = (0.02 * np.maximum(depth, 0.5).astype(np.float64)) ** 2
    ratio = d2 / r2[:, None]
    assert not ((ratio > 0.8) & (ratio < 1.2)).any()
    feats = {"xy": xy, "level": np.zeros(N, np.int32), "angle": np.zeros(N, np.float32),
             "score": np.ones(N, np.float32), "desc": _descs(rng, N), "valid": valid}
    return d, R, t, feats, kp_lm, depth, depth_ok


@pytest.mark.parametrize("near_capacity", [False, True])
def test_insert_keyframe_depth_matches_jax(near_capacity):
    d, R, t, feats, kp_lm, depth, depth_ok = _depth_insert_case(2, near_capacity)
    jcam_, tcam_ = _cams()
    m_j = jfs.insert_keyframe_depth(
        jstore.MapStore(**{k: jnp.asarray(v) for k, v in d.items()}),
        JSE3(jnp.asarray(R), jnp.asarray(t)), jcam_,
        jorb.OrbFeatures(**{k: jnp.asarray(v) for k, v in feats.items()}),
        jnp.asarray(kp_lm), jnp.asarray(depth), jnp.asarray(depth_ok), jnp.int32(9),
    )
    m_t = tfs.insert_keyframe_depth(
        convert.map_from_numpy(d, "cpu"), TSE3(_t(R), _t(t)), tcam_,
        convert.feats_from_numpy(feats, "cpu"), _t(kp_lm), _t(depth), _t(depth_ok),
        torch.tensor(9, dtype=torch.int32),
    )
    ours = convert.map_to_numpy(m_t)
    for k, ref in ((k, np.asarray(v)) for k, v in m_j._asdict().items()):
        assert ours[k].dtype == ref.dtype, k
        if ref.dtype == np.float32:
            np.testing.assert_allclose(ours[k], ref, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(ours[k], ref, err_msg=k)
    made = int(m_j.n_lm) - int(d["n_lm"])
    if near_capacity:
        assert int(m_j.n_lm) == d["lm_pos"].shape[0]   # the rest dropped
    else:
        assert made > 20
    assert int(m_j.n_kf) == 3


@pytest.mark.parametrize("rig", ["room", "rotated"])
def test_rectify_maps_stereo_matches_cv2(rig):
    K = np.array([[380.0, 0, 320], [0, 380, 240], [0, 0, 1]])
    dist = np.array([-0.28, 0.07, 1e-4, -1e-4, 0.0])
    if rig == "room":
        K_r, dist_r, R, t, rel, px = K, dist, np.eye(3), np.array([-0.11, 0.0, 0.0]), 1e-4, 1e-2
    else:
        import cv2

        K_r = np.array([[384.0, 0, 318], [0, 383, 243], [0, 0, 1]])
        dist_r = np.array([-0.25, 0.06, -1e-4, 2e-4, 1e-3])
        R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
        t, rel, px = np.array([-0.11, 0.003, 0.002]), 2e-4, 5e-2
    ref = jcam.rectify_maps_stereo(K, dist, K_r, dist_r, R, t, (480, 640))
    ours = tcam.rectify_maps_stereo(K, dist, K_r, dist_r, R, t, (480, 640))
    f = float(ref["K_new"][0, 0])
    assert np.abs(ours["K_new"] - ref["K_new"]).max() <= rel * f
    assert abs(ours["focal_x_baseline"] - ref["focal_x_baseline"]) <= rel * ref["focal_x_baseline"]
    for k in ("map_l", "map_r"):
        assert ours[k].shape == (480, 640, 2) and ours[k].dtype == np.float32
        assert np.abs(ours[k] - ref[k]).max() <= px, k


def test_benchmark_depth_channels_match_reference():
    """The port's numpy room renderer against the JAX package's, with the
    right eye and the depth maps: images within 1 gray level (the ray grids
    are undistorted in numpy vs JAX float32), depths within 1e-3 m."""
    from lpslam_tpu.io import benchmark as jbench
    from lpslam_tpu_torch.io import benchmark as tbench

    kw = dict(num_frames=3, h=96, w=128, seed=2, turns=0.1)
    for extra in (dict(stereo=True), dict(with_depth=True)):
        ref = list(jbench.SyntheticBenchmark(**kw, **extra))
        ours = list(tbench.SyntheticBenchmark(**kw, **extra))
        for a, b in zip(ours, ref):
            assert np.abs(a.image - b.image).max() <= 1.0
            if "stereo" in extra:
                assert a.depth is None and b.depth is None
                assert np.abs(a.image_right - b.image_right).max() <= 1.0
            else:
                assert a.image_right is None and b.image_right is None
                assert a.depth.dtype == b.depth.dtype == np.float32
                np.testing.assert_allclose(a.depth, b.depth, atol=1e-3)
                assert (b.depth > 0).all()
