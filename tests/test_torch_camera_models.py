"""Port parity, the lens models and their remap grids: the fisheye and omni
functions of lpslam_tpu_torch/geometry/camera.py against lpslam_tpu's, the
numpy grids against OpenCV 5.0, and pipeline/rectify.py's RectifyProcessor
against the JAX one, on the CPU.

Tolerances:
- distort_fisheye / undistort_points_fisheye / project_omni: 2e-6 absolute
  in normalized coordinates (float32 atan / tan / norm of two libraries).
- omni_undistort_maps: 1e-3 px. The JAX package projects its float64 rays
  as float32 jax arrays (x64 is off), so both grids are float32 arithmetic.
- The fisheye grid of cv2.fisheye.initUndistortRectifyMap (CV_32F, its two
  maps stacked), with R = I and P = K, with a rotation that puts rays
  behind the camera (+-inf there, as OpenCV writes), and both eyes of
  cv2.fisheye.stereoRectify: bit-equal. R1, R2, P1, P2 within 1e-9; on the
  ZED rig of examples/zed_live_record.json, P1 = P2 = 600.57326876 and
  P2[0, 3] = -72.06879225.
- The rational 8-coefficient radtan model (and 5 coefficients, a rotated
  rig): grids bit-equal to cv2.initUndistortRectifyMap; R and P of
  cv2.stereoRectify(alpha=0) within 1e-9 relative.
- RectifyProcessor for omni and rational against the JAX processor: grids
  within 1e-3 px, frames within 1e-3 gray levels (rational; its grids are
  equal) or 0.05 (omni, float32 grids: a 1e-3 px shift moves a 50-levels/px
  edge by 0.05). Fisheye: OpenCV 5.0's cv2.fisheye.initUndistortRectifyMap
  rejects the CV_32FC2 map type the JAX package asks for, so the JAX
  processor is built with that one call shimmed to CV_32F (stacked) inside
  the test; the port's grids equal cv2's and the frames equal JAX's within
  1e-3.
- Behaviours of the reference, copied and pinned: a config-built stereo
  session hands the tracker the raw intrinsics and the config's
  focal_x_baseline (not the rectified ones), and a stereo entry with one
  camera configured has only its left eye undistorted.
"""
import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.geometry import camera as jcam
from lpslam_tpu_torch.geometry import camera as tcam

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZED_K = np.array([[700.0, 0, 640.0], [0, 700.0, 360.0], [0, 0, 1]])
ZED_D = np.array([-0.17, 0.023, 0.0, 0.0])


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_fisheye_points_match_jax():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1.2, 1.2, (500, 2)).astype(np.float32)
    for d in ([-0.17, 0.023, 0.0, 0.0], [0.05, -0.01, 0.002, -0.0005]):
        d = np.asarray(d, np.float32)
        a = tcam.distort_fisheye(_t(xy), _t(d)).numpy()
        b = np.asarray(jcam.distort_fisheye(jnp.asarray(xy), jnp.asarray(d)))
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
        a = tcam.undistort_points_fisheye(_t(xy * 0.8), _t(d)).numpy()
        b = np.asarray(jcam.undistort_points_fisheye(jnp.asarray(xy * 0.8), jnp.asarray(d)))
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
        # inside the model's monotonic range the Newton inverse undoes it
        inner = np.linalg.norm(xy * 0.8, axis=1) < 0.9
        back = tcam.distort_fisheye(_t(a[inner]), _t(d)).numpy()
        np.testing.assert_allclose(back, xy[inner] * 0.8, atol=2e-5, rtol=0)


def test_omni_matches_jax():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(400, 3)).astype(np.float32)
    p[:, 2] = np.abs(p[:, 2]) + 0.1
    d4 = np.array([-0.2, 0.05, 1e-3, -2e-3], np.float32)
    a = tcam.project_omni(_t(p), 0.9, _t(d4)).numpy()
    b = np.asarray(jcam.project_omni(jnp.asarray(p), 0.9, jnp.asarray(d4)))
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
    K = np.array([[250.0, 0, 161.0], [0, 252.0, 119.0], [0, 0, 1]])
    d5 = np.array([0.9, -0.2, 0.05, 1e-3, -2e-3])
    R = cv2.Rodrigues(np.array([0.02, -0.01, 0.03]))[0]
    for kw in (dict(), dict(R=R, K_new=np.array([[150.0, 0, 160], [0, 150.0, 120], [0, 0, 1]]))):
        ga, ka = tcam.omni_undistort_maps(K, d5, (240, 320), **kw)
        gb, kb = jcam.omni_undistort_maps(K, d5, (240, 320), **kw)
        np.testing.assert_allclose(ga, gb, atol=1e-3, rtol=0)
        np.testing.assert_array_equal(ka, kb)


def _cv_fisheye_map(K, D, R, P, size):
    mx, my = cv2.fisheye.initUndistortRectifyMap(K, D.reshape(-1, 1), R, P,
                                                 (size[1], size[0]), cv2.CV_32F)
    return np.stack([mx, my], axis=-1)


@pytest.mark.parametrize("rot", [(0.0, 0.0, 0.0), (0.0, 1.6, 0.0)], ids=["identity", "behind"])
def test_fisheye_mono_grid_equals_cv2(rot):
    K = np.array([[300.0, 0, 160.0], [0, 310.0, 120.0], [0, 0, 1]])
    D = np.array([-0.17, 0.023, 0.001, -0.002])
    R = cv2.Rodrigues(np.asarray(rot))[0]
    want = _cv_fisheye_map(K, D, R, K, (240, 320))
    got = tcam.undistort_map_fisheye(K, D, (240, 320), R=R, P=K)
    np.testing.assert_array_equal(got, want)
    assert np.isinf(want).any() == (rot[1] > 0)
    np.testing.assert_array_equal(tcam.undistort_map_fisheye(K, D, (240, 320)),
                                  _cv_fisheye_map(K, D, np.eye(3), K, (240, 320)))


@pytest.mark.parametrize("rig", ["zed", "rotated"])
def test_fisheye_stereo_equals_cv2(rig):
    size = (720, 1280)
    if rig == "zed":
        K2, D2, R, T = ZED_K, ZED_D, np.eye(3), np.array([-0.12, 0.0, 0.0])
    else:
        K2 = np.array([[690.0, 0, 630.0], [0, 695.0, 355.0], [0, 0, 1]])
        D2 = np.array([-0.15, 0.02, 0.001, -0.0005])
        R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
        T = np.array([-0.12, 0.003, 0.002])
    R1, R2, P1, P2, _ = cv2.fisheye.stereoRectify(
        ZED_K, ZED_D.reshape(-1, 1), K2, D2.reshape(-1, 1), (size[1], size[0]), R,
        T.reshape(3, 1), flags=cv2.CALIB_ZERO_DISPARITY)
    res = tcam.rectify_maps_stereo(ZED_K, ZED_D, K2, D2, R, T, size, model="fisheye")
    Rs, Ps = tcam._stereo_rectify_fisheye([ZED_K, K2], [ZED_D, D2], R, T, size)
    for a, b in zip(Rs + Ps, (R1, R2, P1, P2)):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    np.testing.assert_array_equal(res["K_new"], P1[:3, :3].astype(np.float32))
    np.testing.assert_array_equal(res["map_l"], _cv_fisheye_map(ZED_K, ZED_D, R1, P1, size))
    np.testing.assert_array_equal(res["map_r"], _cv_fisheye_map(K2, D2, R2, P2, size))
    assert res["focal_x_baseline"] == pytest.approx(-P2[0, 3], abs=1e-9)
    if rig == "zed":
        assert res["K_new"][0, 0] == pytest.approx(600.57326876, abs=1e-4)
        assert P2[0, 3] == pytest.approx(-72.06879225, abs=1e-8)
        assert res["focal_x_baseline"] == pytest.approx(72.06879225, abs=1e-8)


RATIONAL = np.array([0.3, -0.1, 0.001, -0.0005, 0.02, 0.25, -0.05, 0.01])


@pytest.mark.parametrize("dist", [RATIONAL, RATIONAL[:5]], ids=["rational", "five"])
def test_radtan_grids_equal_cv2(dist):
    K = np.array([[300.0, 0, 160.0], [0, 310.0, 120.0], [0, 0, 1]])
    K2 = np.array([[305.0, 0, 158.0], [0, 306.0, 122.0], [0, 0, 1]])
    want = cv2.initUndistortRectifyMap(K, dist, np.eye(3), K, (320, 240), cv2.CV_32FC2)[0]
    np.testing.assert_array_equal(tcam.undistort_map_radtan(K, dist, (240, 320)), want)
    R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
    for T in (np.array([-0.12, 0.0, 0.0]), np.array([-0.12, 0.003, 0.002])):
        R1, R2, P1, P2, *_ = cv2.stereoRectify(K, dist, K2, dist * 0.9, (320, 240), R,
                                               T.reshape(3, 1),
                                               flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)
        res = tcam.rectify_maps_stereo(K, dist, K2, dist * 0.9, R, T, (240, 320))
        Rs, Ps = tcam._stereo_rectify_radtan(
            [K, K2], [tcam._dist8(dist), tcam._dist8(dist * 0.9)], R, T, (240, 320))
        for a, b in zip(Rs + Ps, (R1, R2, P1, P2)):
            np.testing.assert_allclose(a, b, atol=1e-9 * np.abs(b).max(), rtol=0)
        assert res["focal_x_baseline"] == pytest.approx(-P2[0, 3], rel=1e-12)
        for got, KK, d, RR, PP in ((res["map_l"], K, dist, R1, P1),
                                   (res["map_r"], K2, dist * 0.9, R2, P2)):
            np.testing.assert_array_equal(
                got, cv2.initUndistortRectifyMap(KK, d, RR, PP, (320, 240), cv2.CV_32FC2)[0])


def _fisheye_32f(K, D, R, P, size, m1type):
    """OpenCV 4.x's CV_32FC2 answer from OpenCV 5.0: CV_32F, stacked."""
    mx, my = _ORIG_FISHEYE_MAP(K, D, R, P, size, cv2.CV_32F)
    return np.stack([mx, my], axis=-1), None


_ORIG_FISHEYE_MAP = cv2.fisheye.initUndistortRectifyMap


@pytest.fixture
def fisheye_shim(monkeypatch):
    monkeypatch.setattr(cv2.fisheye, "initUndistortRectifyMap", _fisheye_32f)


def _configs(model, dist, stereo, size=(120, 160)):
    from lpslam_tpu.pipeline.config import CameraConfig as JCC
    from lpslam_tpu_torch.pipeline.config import CameraConfig as TCC

    h, w = size
    out = []
    for cls in (TCC, JCC):
        kw = dict(model=model, fx=150.0, fy=152.0, cx=w / 2 + 1, cy=h / 2 - 1,
                  distortion=np.asarray(dist, np.float32), width=w, height=h)
        left = cls(number=0, rotation=cv2.Rodrigues(np.array([0.0, 0.01, 0.0]))[0]
                   if stereo else None,
                   translation=np.array([-0.12, 0.0, 0.0]) if stereo else None, **kw)
        right = cls(number=1, **dict(kw, fx=149.0)) if stereo else None
        out.append((left, right))
    return out


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    img = 128 + 60 * np.sin(xs / 5.0 + rng.uniform(0, 6)) * np.cos(ys / 7.0 + rng.uniform(0, 6))
    return img.astype(np.float32)


@pytest.mark.parametrize("model,dist,stereo,tol", [
    ("omni", [0.9, -0.2, 0.05, 1e-3, -2e-3], False, 0.05),
    ("omni", [0.9, -0.2, 0.05, 1e-3, -2e-3], True, 0.05),
    ("perspective", RATIONAL * 0.5, False, 1e-3),
    ("perspective", RATIONAL * 0.5, True, 1e-3),
    ("fisheye", [-0.17, 0.023, 0.001, -0.002], False, 1e-3),
    ("fisheye", [-0.17, 0.023, 0.001, -0.002], True, 1e-3),
], ids=["omni-mono", "omni-stereo", "rational-mono", "rational-stereo", "fisheye-mono",
        "fisheye-stereo"])
def test_rectify_processor_matches_jax(fisheye_shim, model, dist, stereo, tol):
    from lpslam_tpu.pipeline.queues import CameraQueueEntry as JEntry
    from lpslam_tpu.pipeline.rectify import RectifyProcessor as JRect
    from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
    from lpslam_tpu_torch.pipeline.rectify import RectifyProcessor

    (tl, tr), (jl, jr) = _configs(model, dist, stereo)
    ours = RectifyProcessor(camera=tl, camera_right=tr, device="cpu")
    ref = JRect(camera=jl, camera_right=jr)
    np.testing.assert_allclose(ours.K_new, ref.K_new, rtol=1e-9)
    assert ours.focal_x_baseline == pytest.approx(ref.focal_x_baseline, rel=1e-9)
    for ga, gb in zip(ours._maps, ref._maps):
        assert (ga is None) == (gb is None)
        if ga is not None:
            if model == "omni":
                np.testing.assert_allclose(ga.numpy(), np.asarray(gb), atol=1e-3, rtol=0)
            else:
                np.testing.assert_array_equal(ga.numpy(), np.asarray(gb))
    left, right = _smooth(120, 160, 0), _smooth(120, 160, 1)
    a = ours.process_image(CameraQueueEntry(0.0, left.copy(), right.copy()))
    b = ref.process_image(JEntry(0.0, left.copy(), right.copy()))
    np.testing.assert_allclose(a.image, b.image, atol=tol, rtol=0)
    np.testing.assert_allclose(a.image_second, b.image_second, atol=tol, rtol=0)
    if not stereo:
        # one camera configured: only the left eye is undistorted
        np.testing.assert_array_equal(a.image_second, right)
    if model == "fisheye":
        m = ours._maps[0].numpy()
        np.testing.assert_array_equal(m, np.asarray(ref._maps[0]))


def test_jax_fisheye_processor_needs_the_shim_under_opencv5():
    from lpslam_tpu.pipeline.rectify import RectifyProcessor as JRect

    (_, _), (jl, _) = _configs("fisheye", [-0.17, 0.023, 0.0, 0.0], False)
    if int(cv2.__version__.split(".")[0]) >= 5:
        with pytest.raises(cv2.error):
            JRect(camera=jl)
    else:
        JRect(camera=jl)


def test_zed_session_hands_the_tracker_raw_intrinsics(fisheye_shim):
    from lpslam_tpu.pipeline import config as jc
    from lpslam_tpu.pipeline.manager import SlamManager as JManager
    from lpslam_tpu_torch.pipeline import config as tc
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    path = os.path.join(REPO, "examples", "zed_live_record.json")
    ours = SlamManager(dataclasses.replace(tc.load_config_file(path), datasources=[]),
                       device="cpu")
    ref = JManager(dataclasses.replace(jc.load_config_file(path), datasources=[]))
    for mgr in (ours, ref):
        proc, tracker = mgr.processors[0], mgr.trackers[0]
        # one camera in the config: the mono fisheye grid, K kept
        assert proc._maps[1] is None
        np.testing.assert_allclose(np.asarray(proc.K_new), ZED_K, rtol=1e-7)
        assert float(tracker.engine.cam.fx) == 700.0
        assert tracker.cfg["focal_x_baseline"] == 84.0
    np.testing.assert_array_equal(ours.processors[0]._maps[0].numpy(),
                                  np.asarray(ref.processors[0]._maps[0]))
    # a second, rotated camera makes a rectified pair, but the tracker still
    # gets the configured intrinsics, not the rectified 600.57
    right = dataclasses.replace(ours.cameras[0], number=1)
    ours.cameras[0] = dataclasses.replace(ours.cameras[0], rotation=np.eye(3),
                                          translation=np.array([-0.12, 0.0, 0.0]))
    ours.set_camera_configuration(right)
    proc = ours.add_processor_by_name("Rectify", {})
    assert proc._maps[1] is not None
    assert proc.K_new[0, 0] == pytest.approx(600.57326876, abs=1e-4)
    assert ours._camera_model(0).fx.item() == 700.0
