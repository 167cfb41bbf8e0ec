"""Port parity, the live sources and the calibration processor:
lpslam_tpu_torch/pipeline/{sources,zed_hid,processors}.py against
lpslam_tpu's on the CPU, with the camera doubles of tests/test_zed_source.py
and tests/test_zed_hid.py (no hardware).

- The same fake captures through both packages' OpenCVCameraSource,
  ZedOpenCaptureSource and ZedSdkSource give equal queue entries (images,
  timestamps' presence, ros_timestamp) and set equal gains; the mode table,
  the fps checks, fps_scaling and release on stop behave alike.
- YUYV -> grey, YUYV -> BGR and BGR -> grey are bit-equal to cv2.cvtColor on
  random frames.
- Without cv2 (sys.modules["cv2"] = None) start() and the calibration
  processor raise ImportError naming cv2; without pyzed ZedSdkSource raises
  RuntimeError as in JAX.
- The HID decoder, timestamp re-basing, IMU publication and keep-alive ping
  give the JAX module's values.
- CameraCalibrationProcessor on rendered chessboards accepts and rejects
  the same views as the JAX one (border margin, novelty): equal corners;
  the fits (OpenCV's in both) within 1e-6 relative, since OpenCV's solver
  gives run-to-run differences of ~1e-8 on the same input. The JAX fisheye
  fit cannot run under OpenCV 5.0: the fisheye flags moved out of
  cv2.fisheye (with other values), so it raises AttributeError, and
  fisheye.calibrate rejects its (N, 1, 3) point sets. The port reads the
  flags from whichever module has them and passes (1, N, 3) / (1, N, 2)
  sets; the test holds its fisheye fit to that call made directly.
"""
import sys
import time

import cv2
import numpy as np
import pytest
import torch

import test_zed_hid as hid_fx
import test_zed_source as src_fx
from lpslam_tpu.pipeline import processors as jproc
from lpslam_tpu.pipeline import queues as jq
from lpslam_tpu.pipeline import sources as jsrc
from lpslam_tpu.pipeline import zed_hid as jhid
from lpslam_tpu_torch.pipeline import processors as tproc
from lpslam_tpu_torch.pipeline import queues as tq
from lpslam_tpu_torch.pipeline import sources as tsrc
from lpslam_tpu_torch.pipeline import zed_hid as thid

torch.set_num_threads(1)


class _NoThread:
    """ManagedThread stand-in: start() runs nothing, the test steps _loop."""

    def __init__(self, fn, name=None):
        pass

    def start(self):
        pass

    def stop(self, join_timeout=None):
        pass


class _Frames:
    """A VideoCapture double that serves scripted frames, then (False, None)."""

    frames: list = []

    def __init__(self, device):
        self.props = {}
        self.gains = []
        self.released = False
        self._left = list(self.frames)

    def isOpened(self):
        return True

    def set(self, prop, val):
        self.props[prop] = val
        if prop == cv2.CAP_PROP_GAIN:
            self.gains.append(val)
        return True

    def read(self):
        if not self._left:
            return False, None
        return True, self._left.pop(0)

    def release(self):
        self.released = True


@pytest.fixture
def stepped(monkeypatch):
    monkeypatch.setattr(jsrc, "ManagedThread", _NoThread)
    monkeypatch.setattr(tsrc, "ManagedThread", _NoThread)


def _drain(q):
    out = []
    while not q.empty():
        out.append(q.pop(timeout=0.01))
    return out


def _run_both(cls_name, config, frames, monkeypatch, steps=None):
    """Start each package's source on the same frames, step its loop once
    per frame (plus one failed read), return (entries, capture) per package."""
    _Frames.frames = frames
    monkeypatch.setattr(cv2, "VideoCapture", _Frames)
    out = []
    for mod, queues in ((tsrc, tq), (jsrc, jq)):
        src = getattr(mod, cls_name)(config)
        q = queues.BoundedQueue(maxsize=len(frames) + 4)
        src.start(q)
        cap = src._cap
        for _ in range(steps or len(frames) + 1):
            src._loop(None)
        src.stop()
        assert cap.released
        out.append((_drain(q), cap))
    return out


def _yuyv_frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        y = np.clip(rng.normal(40 + 12 * i, 30, (h, w)), 0, 255).astype(np.uint8)
        c = rng.integers(0, 256, (h, w), dtype=np.uint8)
        frames.append(np.dstack([y, c]))
    return frames


def _assert_entries_equal(a, b):
    assert len(a) == len(b) > 0
    for ea, eb in zip(a, b):
        for f in ("image", "image_second"):
            x, y = getattr(ea, f), getattr(eb, f)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype == np.float32
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("config,packed", [
    ({"height": 376, "fps": 30, "auto_gain": True}, False),
    ({"auto_gain": True, "grayscale": False}, False),
    ({"auto_gain": True}, True),
], ids=["gray", "bgr", "packed"])
def test_zed_source_matches_jax(stepped, monkeypatch, config, packed):
    frames = _yuyv_frames(12, 24, 64)
    if packed:
        frames = [f.reshape(24, 128) for f in frames]
    (ours, cap_t), (ref, cap_j) = _run_both("ZedOpenCaptureSource", config, frames, monkeypatch)
    _assert_entries_equal(ours, ref)
    assert len(ours) == 12
    assert cap_t.gains == cap_j.gains and len(cap_t.gains) == 2
    assert cap_t.props == cap_j.props
    # the JAX test's own fixture: dark left eye, bright right eye, gain ~59
    (ours, cap_t), (ref, _) = _run_both("ZedOpenCaptureSource", {"auto_gain": True},
                                        [src_fx.FakeCap(0).frame] * 5, monkeypatch)
    _assert_entries_equal(ours, ref)
    assert ours[0].image.mean() < 100 < ours[0].image_second.mean()
    assert 50 <= cap_t.gains[0] <= 70


def test_zed_modes_fps_and_throttle(stepped, monkeypatch):
    monkeypatch.setattr(cv2, "VideoCapture", src_fx.FakeCap)
    for mod, queues in ((tsrc, tq), (jsrc, jq)):
        with pytest.raises(RuntimeError):
            mod.ZedOpenCaptureSource({"height": 999}).start(queues.BoundedQueue(2))
        with pytest.raises(RuntimeError):
            mod.ZedOpenCaptureSource({"fps": 45}).start(queues.BoundedQueue(2))
    props = []
    for mod, queues in ((tsrc, tq), (jsrc, jq)):
        src = mod.ZedOpenCaptureSource({"fps": 10, "fps_scaling": True, "height": 720,
                                        "exposure": 20})
        q = queues.BoundedQueue(16)
        src.start(q)
        props.append(dict(src._cap.props))
        for _ in range(5):          # five reads at once: the throttle keeps one
            src._loop(None)
        assert len(_drain(q)) == 1
        src.stop()
    assert props[0] == props[1]
    assert props[0][cv2.CAP_PROP_FRAME_WIDTH] == 2560


@pytest.mark.parametrize("split", ["none", "side_by_side", "top_bottom"])
def test_opencv_source_matches_jax(stepped, monkeypatch, split):
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8) for _ in range(3)]
    frames.append(rng.integers(0, 256, (24, 32), dtype=np.uint8))
    (ours, cap_t), (ref, cap_j) = _run_both(
        "OpenCVCameraSource", {"stereo_split": split, "width": 32, "height": 24, "fps": 5.0},
        frames, monkeypatch)
    _assert_entries_equal(ours, ref)
    assert cap_t.props == cap_j.props


def test_sdk_source_matches_jax(stepped, monkeypatch):
    import types

    pkg = types.ModuleType("pyzed")
    pkg.sl = src_fx._FakeSl
    monkeypatch.setitem(sys.modules, "pyzed", pkg)
    monkeypatch.setitem(sys.modules, "pyzed.sl", src_fx._FakeSl)
    out = []
    for mod, queues in ((tsrc, tq), (jsrc, jq)):
        src = mod.ZedSdkSource({"fps": 30, "exposure": 15, "gain": 50})
        q = queues.BoundedQueue(16)
        src.start(q)
        cam = src._cam
        cam.fail_first_grab = True
        for _ in range(6):
            src._loop(None)
        entries = _drain(q)
        src.stop()
        assert src._cam is None and cam.closed
        out.append((entries, cam.settings, cam.init.camera_resolution))
    (ours, set_t, res_t), (ref, set_j, res_j) = out
    _assert_entries_equal(ours, ref)
    assert len(ours) == 5 and [e.ros_timestamp for e in ours] == [e.ros_timestamp for e in ref]
    assert set_t == set_j and res_t == res_j
    for mod in (tsrc, jsrc):
        with pytest.raises(RuntimeError, match="unknown ZED resolution"):
            mod.ZedSdkSource({"resolution": "8K"}).start(None)


def test_sdk_source_needs_pyzed(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyzed", None)
    for mod in (tsrc, jsrc):
        with pytest.raises(RuntimeError, match="ZedOpenCaptureSource"):
            mod.ZedSdkSource()


def test_without_cv2_start_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    for cls in (tsrc.OpenCVCameraSource, tsrc.ZedOpenCaptureSource):
        with pytest.raises(ImportError, match="cv2"):
            cls({}).start(tq.BoundedQueue(2))
    proc = tproc.CameraCalibrationProcessor({})
    with pytest.raises(ImportError, match="cv2"):
        proc.process_image(tq.CameraQueueEntry(0.0, np.zeros((8, 8), np.float32)))


@pytest.mark.parametrize("shape", [(24, 64, 2), (7, 10, 2), (480, 1344, 2)])
def test_color_conversions_bit_equal_to_cv2(shape):
    rng = np.random.default_rng(shape[0])
    raw = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(tsrc.yuyv_to_gray(raw),
                                  cv2.cvtColor(raw, cv2.COLOR_YUV2GRAY_YUYV))
    np.testing.assert_array_equal(tsrc.yuyv_to_bgr(raw),
                                  cv2.cvtColor(raw, cv2.COLOR_YUV2BGR_YUYV))
    bgr = rng.integers(0, 256, shape[:2] + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(tsrc.bgr_to_gray(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


def test_hid_decode_and_capture_match_jax():
    for kw in (dict(mcu_ts=1000), dict(mcu_ts=5, imu_valid=False, frame_sync=1,
                                       frame_sync_count=7, temp_c=-120)):
        rep = hid_fx.make_report(**kw)
        assert thid.decode_report(rep) == jhid.decode_report(rep)
    assert thid.decode_report(b"\x20" + b"\x00" * 63) is None
    for name in ("ACC_SCALE", "GYRO_SCALE", "MAG_SCALE", "TS_SCALE_NS", "TEMP_SCALE",
                 "PRESS_SCALE", "HUMID_SCALE", "SL_USB_VENDOR"):
        assert getattr(thid, name) == getattr(jhid, name)

    step = int(round(2.5e6 / thid.TS_SCALE_NS))
    got = []
    for mod, queues in ((thid, tq), (jhid, jq)):
        reports = [hid_fx.make_report(mcu_ts=1_000_000 + i * step) for i in range(5)]
        samples = []
        q = queues.BoundedQueue(maxsize=32)
        cap = mod.ZedSensorCapture(device=hid_fx.FakeHid(reports), on_sample=samples.append)
        cap.attach(q)
        cap.start()
        deadline = time.time() + 5.0
        while cap.n_samples < 4 and time.time() < deadline:
            time.sleep(0.01)
        cap.stop()
        entries = _drain(q)
        assert cap.n_samples == 4 and len(entries) == 4
        got.append(([(e.acc.tolist(), e.gyro.tolist()) for e in entries],
                    np.diff([e.timestamp for e in entries]),
                    [(s.mag.tolist(), s.pressure, s.temp, s.humidity) for s in samples]))
    assert got[0][0] == got[1][0] and got[0][2] == got[1][2]
    np.testing.assert_allclose(got[0][1], got[1][1], rtol=1e-9)

    dev = hid_fx.FakeHid([hid_fx.make_report(mcu_ts=1000 + i) for i in range(3)])
    cap = thid.ZedSensorCapture(device=dev)
    cap._reads_since_ping = 400
    cap.start()
    deadline = time.time() + 5.0
    while not dev.writes and time.time() < deadline:
        time.sleep(0.01)
    cap.stop()
    assert dev.writes[0] == bytes([thid.REP_ID_REQUEST_SET, thid.RQ_CMD_PING])


def _board_views(n=10, h=480, w=640, seed=0):
    """Chessboards (9 x 6 inner corners) under random homographies; two
    views repeat an earlier one and one runs off the image edge."""
    sq = 30
    board = np.full((9 * sq, 12 * sq), 255, np.uint8)
    for r in range(7):
        for c in range(10):
            if (r + c) % 2 == 0:
                board[(r + 1) * sq:(r + 2) * sq, (c + 1) * sq:(c + 2) * sq] = 0
    rng = np.random.default_rng(seed)
    src = np.float32([[0, 0], [board.shape[1], 0], [board.shape[1], board.shape[0]],
                      [0, board.shape[0]]])
    views = []
    for i in range(n):
        cx, cy = rng.uniform(230, 410), rng.uniform(170, 310)
        s = rng.uniform(0.7, 1.0)
        half = np.array([board.shape[1], board.shape[0]]) * s / 2
        dst = np.float32([[cx - half[0], cy - half[1]], [cx + half[0], cy - half[1]],
                          [cx + half[0], cy + half[1]], [cx - half[0], cy + half[1]]])
        dst += rng.uniform(-25, 25, dst.shape).astype(np.float32)
        if i == n - 1:
            dst[:, 0] += 260                    # the board leaves the image
        H = cv2.getPerspectiveTransform(src, dst)
        views.append(cv2.warpPerspective(board, H, (w, h), borderValue=200)
                     .astype(np.float32))
    return views + [views[1], views[3]]


def _fisheye_fit(self):
    """The JAX processor's fisheye fit as OpenCV 5.0 accepts it."""
    objp = np.zeros((1, 54, 3), np.float64)
    objp[0, :, :2] = np.mgrid[0:9, 0:6].T.reshape(-1, 2) * self.cfg["square_size"]
    rms, K, D, _, _ = cv2.fisheye.calibrate(
        [objp] * len(self._img_points),
        [c.reshape(1, -1, 2).astype(np.float64) for c in self._img_points],
        self._image_size, np.eye(3), np.zeros((4, 1)),
        flags=cv2.CALIB_RECOMPUTE_EXTRINSIC + cv2.CALIB_FIX_SKEW)
    self.result = {"model": "fisheye", "K": K, "dist": D.ravel(), "rms": rms}


@pytest.mark.parametrize("model", ["fisheye", "perspective"])
def test_calibration_selection_matches_jax(monkeypatch, model):
    if model == "fisheye" and not hasattr(cv2.fisheye, "CALIB_FIX_SKEW"):
        with pytest.raises(AttributeError):
            jproc.CameraCalibrationProcessor({"min_views": 1})._fit()
        monkeypatch.setattr(jproc.CameraCalibrationProcessor, "_fit", _fisheye_fit)
    views = _board_views()
    cfg = {"model": model, "min_views": 6, "novelty_px": 15.0}
    ours, ref = tproc.CameraCalibrationProcessor(cfg), jproc.CameraCalibrationProcessor(cfg)
    accepted = []
    for img in views:
        for proc, entry in ((ours, tq.CameraQueueEntry), (ref, jq.CameraQueueEntry)):
            proc.process_image(entry(0.0, img.copy()))
        accepted.append((len(ours._img_points), len(ref._img_points)))
    assert [a for a, _ in accepted] == [b for _, b in accepted]
    n = accepted[-1][0]
    assert 6 <= n <= len(views) - 3, accepted      # duplicates and the edge view rejected
    for a, b in zip(ours._img_points, ref._img_points):
        np.testing.assert_array_equal(a, b)
    assert ours.result is not None and ours.result["model"] == ref.result["model"] == model
    np.testing.assert_allclose(ours.result["K"], ref.result["K"], rtol=1e-6)
    np.testing.assert_allclose(ours.result["dist"], ref.result["dist"], rtol=1e-6, atol=1e-9)
    assert ours.result["rms"] == pytest.approx(ref.result["rms"], rel=1e-6)
