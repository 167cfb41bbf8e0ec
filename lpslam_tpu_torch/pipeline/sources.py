"""Frame sources, the producers that feed the camera queue (port of
lpslam_tpu/pipeline/sources.py).

- FileImageSource reads mono or stereo image files (PNG, through
  io/png.py) at a fixed rate, optionally looping;
- SyntheticSource renders the planar-scene sequence and publishes each
  frame's ground-truth pose (plus optional noise) as a global state on the
  sensor queue, and optionally IMU samples;
- ReplaySource streams a recorded .pb session;
- OpenCVCameraSource (a UVC camera), ZedOpenCaptureSource (a ZED over UVC,
  with its HID sensor stream, zed_hid.py) and ZedSdkSource (a ZED through
  the StereoLabs SDK) capture live frames.

The live sources need a capture API: ``cv2.VideoCapture`` is imported in
``start()`` only (with its property constants), ``pyzed`` when a
ZedSdkSource is built. Everything done to a frame is numpy: YUYV to grey or
BGR and BGR to grey bit-equal to OpenCV 5.0's ``cvtColor``, the stereo
splits, the frame-rate throttle and the auto-gain servo.
"""
from __future__ import annotations

import glob
import os
import time
from typing import Optional

import numpy as np

from ..io.png import imread_gray
from .config import ConfigOptions
from .queues import CameraQueueEntry, ManagedThread, PyBoundedQueue, SensorQueueEntry

# BGR(A) -> gray weights of OpenCV's cvtColor on 8-bit data:
# (R*9798 + G*19235 + B*3735 + 2^14) >> 15
_GRAY_W15 = (3735, 19235, 9798)
# and on float data
_GRAY_F = (np.float32(0.114), np.float32(0.587), np.float32(0.299))
# OpenCV's fixed-point BT.601 YUV -> RGB (color_yuv: ITUR_BT_601_*, >> 20)
_YUV_CY, _YUV_CUB, _YUV_CUG, _YUV_CVG, _YUV_CVR = 1220542, 2116026, -409993, -852492, 1673527


def bgr_to_gray(buf: np.ndarray) -> np.ndarray:
    """(H, W, 3|4) B, G, R(, A) -> (H, W) gray of the same dtype, as
    ``cv2.cvtColor(buf, COLOR_BGR(A)2GRAY)``: bit-equal on uint8, float32
    within 1e-4 (OpenCV's vector code orders the float sum its own way)."""
    b, g, r = buf[..., 0], buf[..., 1], buf[..., 2]
    if buf.dtype == np.uint8:
        wb, wg, wr = _GRAY_W15
        v = (b.astype(np.int32) * wb + g.astype(np.int32) * wg
             + r.astype(np.int32) * wr + (1 << 14)) >> 15
        return v.astype(np.uint8)
    wb, wg, wr = _GRAY_F
    return (b * wb + g * wg + r * wr).astype(buf.dtype)


def yuyv_to_gray(raw: np.ndarray) -> np.ndarray:
    """(H, W, 2) packed YUYV uint8 -> (H, W) luma, as
    ``cv2.cvtColor(raw, COLOR_YUV2GRAY_YUYV)``."""
    return np.ascontiguousarray(raw[..., 0])


def yuyv_to_bgr(raw: np.ndarray) -> np.ndarray:
    """(H, W, 2) packed YUYV uint8 (Y0 U Y1 V per pixel pair) -> (H, W, 3)
    BGR uint8, OpenCV's fixed-point BT.601 with clamping, bit-equal to
    ``cv2.cvtColor(raw, COLOR_YUV2BGR_YUYV)``."""
    y = raw[..., 0].astype(np.int64)
    c = raw[..., 1].astype(np.int64) - 128
    u = np.repeat(c[:, 0::2], 2, axis=1)
    v = np.repeat(c[:, 1::2], 2, axis=1)
    half = 1 << 19
    yy = np.maximum(y - 16, 0) * _YUV_CY
    chans = [yy + half + _YUV_CUB * u,                       # B
             yy + half + _YUV_CVG * v + _YUV_CUG * u,        # G
             yy + half + _YUV_CVR * v]                       # R
    return np.stack([np.clip(ch >> 20, 0, 255) for ch in chans], axis=-1).astype(np.uint8)


def _open_capture(cv2, device: int, retries: int):
    """cv2.VideoCapture(device), tried `retries` times 0.5 s apart; raises
    RuntimeError when it never opens."""
    cap = None
    for _ in range(retries):
        cap = cv2.VideoCapture(device)
        if cap.isOpened():
            return cap
        time.sleep(0.5)
    raise RuntimeError(f"cannot open camera device {device}")


class ImageSourceBase:
    """Producer base: subclasses implement `_loop`, one step per call."""

    schema = ConfigOptions()

    def __init__(self, config: Optional[dict] = None):
        self.cfg = self.schema.parse(config)
        self._worker: Optional[ManagedThread] = None
        self.camera_queue: Optional[PyBoundedQueue] = None
        self.sensor_queue: Optional[PyBoundedQueue] = None

    def start(self, camera_queue: PyBoundedQueue):
        self.camera_queue = camera_queue
        self._worker = ManagedThread(self._loop, name=type(self).__name__)
        self._worker.start()

    def start_sensor(self, sensor_queue: PyBoundedQueue):
        self.sensor_queue = sensor_queue

    def stop(self):
        if self._worker is not None:
            self._worker.stop()
            self._worker = None

    def _loop(self, thread: ManagedThread):
        raise NotImplementedError


class FileImageSource(ImageSourceBase):
    """Mono or stereo image files read from disk at a fixed rate."""

    schema = (
        ConfigOptions()
        .optional("directory", str, "")
        .optional("pattern", str, "*.png")
        .optional("fps", float, 10.0)
        .optional("loop", bool, False)
        .optional("stereo_right_directory", str, "")
    )

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self._files: list = []
        self._right: list = []
        self._idx = 0
        if self.cfg["directory"]:
            self._files = sorted(
                glob.glob(os.path.join(self.cfg["directory"], self.cfg["pattern"]))
            )
        if self.cfg["stereo_right_directory"]:
            self._right = sorted(
                glob.glob(os.path.join(self.cfg["stereo_right_directory"], self.cfg["pattern"]))
            )

    def add_image(self, path: str):
        self._files.append(path)

    def add_stereo_image(self, left: str, right: str):
        self._files.append(left)
        self._right.append(right)

    def _loop(self, thread: ManagedThread):
        if self._idx >= len(self._files):
            if self.cfg["loop"] and self._files:
                self._idx = 0
            else:
                time.sleep(0.02)
                return
        img = imread_gray(self._files[self._idx])
        second = None
        if self._idx < len(self._right):
            second = imread_gray(self._right[self._idx])
            second = None if second is None else second.astype(np.float32)
        self._idx += 1
        if img is None:
            return
        self.camera_queue.push(
            CameraQueueEntry(timestamp=time.time(), image=img.astype(np.float32),
                             image_second=second)
        )
        time.sleep(1.0 / max(self.cfg["fps"], 1e-3))


class SyntheticSource(ImageSourceBase):
    """Simulation source with ground truth: frames to the camera queue,
    ground-truth global states (and IMU samples) to the sensor queue."""

    schema = (
        ConfigOptions()
        .optional("num_frames", int, 60)
        .optional("width", int, 320)
        .optional("height", int, 240)
        .optional("fps", float, 20.0)
        .optional("seed", int, 0)
        .optional("motion", str, "orbit")
        .optional("gt_noise_sigma", float, 0.0)
        .optional("stereo_baseline", float, 0.0)
        .optional("with_depth", bool, False)
        .optional("realtime", bool, False)
        .optional("publish_imu", bool, False)
        # [(x, y), ...] targets driven by PID control; overrides `motion`
        .optional("waypoints", list, None)
    )

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        from ..io.synthetic import imu_from_poses, make_sequence, waypoint_trajectory

        poses = None
        if self.cfg["waypoints"]:
            poses = waypoint_trajectory(self.cfg["waypoints"], self.cfg["num_frames"],
                                        fps=self.cfg["fps"])
        self.seq = make_sequence(
            num_frames=self.cfg["num_frames"], h=self.cfg["height"], w=self.cfg["width"],
            seed=self.cfg["seed"], motion=self.cfg["motion"],
            stereo_baseline=self.cfg["stereo_baseline"], with_depth=self.cfg["with_depth"],
            poses=poses,
        )
        self._imu = None
        if self.cfg["publish_imu"]:
            self._imu = imu_from_poses(self.seq.poses_wc, self.cfg["fps"])
        self._idx = 0
        self._rng = np.random.default_rng(self.cfg["seed"] + 99)

    @property
    def K(self):
        return self.seq.K

    def _loop(self, thread: ManagedThread):
        if self._idx >= len(self.seq.images):
            time.sleep(0.02)
            return
        t = self._idx
        self._idx += 1
        ts = t / max(self.cfg["fps"], 1e-3)
        entry = CameraQueueEntry(
            timestamp=ts,
            image=self.seq.images[t],
            image_second=None if self.seq.images_r is None else self.seq.images_r[t],
            aux=None if self.seq.depths is None else self.seq.depths[t],
        )
        if self.sensor_queue is not None:
            pose = self.seq.poses_wc[t]
            pos = np.asarray(pose.t, np.float64).copy()
            if self.cfg["gt_noise_sigma"] > 0:
                pos += self._rng.normal(0, self.cfg["gt_noise_sigma"], 3)
            self.sensor_queue.push(
                SensorQueueEntry(timestamp=ts, kind="global_state", state=(pos, pose.R))
            )
            if self._imu is not None:
                gyro, accel = self._imu
                self.sensor_queue.push(
                    SensorQueueEntry(timestamp=ts, kind="imu", acc=accel[t], gyro=gyro[t])
                )
        self.camera_queue.push(entry)
        if self.cfg["realtime"]:
            time.sleep(1.0 / max(self.cfg["fps"], 1e-3))

    @property
    def done(self) -> bool:
        return self._idx >= len(self.seq.images)


class OpenCVCameraSource(ImageSourceBase):
    """A UVC camera through cv2.VideoCapture: retries on open, grey frames,
    optionally split side by side or top and bottom into two eyes."""

    schema = (
        ConfigOptions()
        .optional("device", int, 0)
        .optional("width", int, 0)
        .optional("height", int, 0)
        .optional("fps", float, 0.0)
        .optional("stereo_split", str, "none")  # none | side_by_side | top_bottom
        .optional("open_retries", int, 5)
    )

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self._cap = None

    def start(self, camera_queue: PyBoundedQueue):
        import cv2

        self._cap = _open_capture(cv2, self.cfg["device"], self.cfg["open_retries"])
        if self.cfg["width"]:
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.cfg["width"])
        if self.cfg["height"]:
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.cfg["height"])
        if self.cfg["fps"]:
            self._cap.set(cv2.CAP_PROP_FPS, self.cfg["fps"])
        super().start(camera_queue)

    def _loop(self, thread: ManagedThread):
        ok, frame = self._cap.read()
        if not ok:
            time.sleep(0.01)
            return
        if frame.ndim == 3:
            frame = bgr_to_gray(frame)
        frame = frame.astype(np.float32)
        second = None
        split = self.cfg["stereo_split"]
        if split == "side_by_side":
            half = frame.shape[1] // 2
            frame, second = frame[:, :half], frame[:, half:]
        elif split == "top_bottom":
            half = frame.shape[0] // 2
            frame, second = frame[:half], frame[half:]
        self.camera_queue.push(
            CameraQueueEntry(timestamp=time.time(), image=frame, image_second=second))

    def stop(self):
        super().stop()
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class ZedOpenCaptureSource(ImageSourceBase):
    """A ZED-family stereo camera (ZED, ZED mini, ZED 2) over UVC: one
    double-width YUYV side-by-side frame per capture.

    - the mode table is keyed by the per-eye height: 376 = VGA, 720 = HD720,
      1080 = HD1080, 1242 = HD2K; fps in {15, 30, 60, 100} set on the
      driver, or 0 = its default;
    - fps_scaling: capture at the camera's own rate and drop frames until
      1/fps has passed since the last one kept;
    - YUYV to grey (or BGR) first, then the side-by-side eye split;
    - exposure > 0 sets a manual exposure, else auto;
    - auto_gain: every 5th frame, gain = 30 + (1 - mean/255) * 60, rounded;
    - sensors: the camera MCU's 400 Hz HID stream (zed_hid.py) publishes IMU
      samples on the sensor queue.
    """

    # per-eye height -> (per-eye width, full side-by-side width)
    MODES = {376: (672, 1344), 720: (1280, 2560), 1080: (1920, 3840),
             1242: (2208, 4416)}
    VALID_FPS = (0, 15, 30, 60, 100)

    schema = (
        ConfigOptions()
        .optional("camera_number", int, -1)   # -1 = first available
        .optional("grayscale", bool, True)
        .optional("width", int, 0)
        .optional("height", int, 0)
        .optional("fps", int, 0)
        .optional("exposure", int, 0)
        .optional("fps_scaling", bool, False)
        .optional("auto_gain", bool, False)
        .optional("open_retries", int, 5)
        .optional("baseline", float, 0.12)
        .optional("sensors", bool, False)
        .optional("sensors_hid_path", str, "")   # override /dev/hidrawN
    )

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        self._cap = None
        self._gain_prop = None
        self._last_ts = 0.0
        self._frame_number = 0
        self._sensors = None

    def start(self, camera_queue: PyBoundedQueue):
        import cv2

        h = self.cfg["height"]
        if h and h not in self.MODES:
            raise RuntimeError(f"resolution height {h} not supported by ZED camera")
        fps = self.cfg["fps"]
        if not self.cfg["fps_scaling"] and fps not in self.VALID_FPS:
            raise RuntimeError(f"FPS {fps} not supported by ZED camera")
        self._cap = _open_capture(cv2, max(self.cfg["camera_number"], 0),
                                  self.cfg["open_retries"])
        self._gain_prop = cv2.CAP_PROP_GAIN
        # raw YUYV off the UVC endpoint, without OpenCV's own conversion
        self._cap.set(cv2.CAP_PROP_FOURCC, cv2.VideoWriter_fourcc(*"YUYV"))
        self._cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        if h:
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.MODES[h][1])
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, h)
        if fps and not self.cfg["fps_scaling"]:
            self._cap.set(cv2.CAP_PROP_FPS, fps)
        if self.cfg["exposure"] > 0:
            self._cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, 1)  # manual (V4L2)
            self._cap.set(cv2.CAP_PROP_EXPOSURE, self.cfg["exposure"])
        super().start(camera_queue)

    def _loop(self, thread: ManagedThread):
        ok, raw = self._cap.read()
        if not ok or raw is None:
            time.sleep(0.05)          # an invalid frame: keep capturing
            return
        now = time.time()
        if self.cfg["fps_scaling"] and self.cfg["fps"] > 0:
            if now - self._last_ts < 1.0 / self.cfg["fps"]:
                return                # no new frame wanted yet
            self._last_ts = now
        self._frame_number += 1

        if raw.ndim == 2 and raw.shape[1] % 2 == 0 and raw.dtype == np.uint8:
            raw = raw.reshape(raw.shape[0], raw.shape[1] // 2, 2)   # packed YUYV
        if raw.ndim == 3 and raw.shape[2] == 2:
            frame = yuyv_to_gray(raw) if self.cfg["grayscale"] else yuyv_to_bgr(raw)
        elif raw.ndim == 3:
            frame = bgr_to_gray(raw) if self.cfg["grayscale"] else raw
        else:
            frame = raw

        if self.cfg["auto_gain"] and self._frame_number % 5 == 0:
            gain = 30.0 + (1.0 - float(frame.mean()) / 255.0) * 60.0
            self._cap.set(self._gain_prop, round(gain))

        gray = frame.astype(np.float32)
        half = gray.shape[1] // 2
        self.camera_queue.push(CameraQueueEntry(
            timestamp=now, image=gray[:, :half], image_second=gray[:, half:]))

    def start_sensor(self, sensor_queue: PyBoundedQueue):
        super().start_sensor(sensor_queue)
        if self.cfg["sensors"]:
            from .zed_hid import ZedSensorCapture

            self._sensors = ZedSensorCapture(path=self.cfg["sensors_hid_path"] or None)
            self._sensors.attach(sensor_queue)
            self._sensors.start()

    def stop(self):
        super().stop()
        if self._sensors is not None:
            self._sensors.stop()
            self._sensors = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None


class ZedSdkSource(ImageSourceBase):
    """A ZED stereo camera through the StereoLabs SDK (`pyzed.sl`).

    - opens at `resolution` / `fps` (HD720 at 15 by default), depth off,
      then sets a manual exposure and gain;
    - grab(), then the left and right unrectified grey views; a failure
      sleeps 50 ms and keeps the worker alive;
    - every 5th frame, gain = 30 + (1 - mean/255) * 60 from the left eye;
    - the camera's IMAGE timestamp (ns) rides on each entry as its
      ros_timestamp;
    - the 12 cm baseline is not stamped on the entry: the camera config's
      focal_x_baseline carries the stereo geometry.
    Building one without `pyzed` raises RuntimeError.
    """

    schema = (
        ConfigOptions()
        .optional("fps", int, 15)
        .optional("resolution", str, "HD720")  # VGA|HD720|HD1080|HD2K
        .optional("exposure", int, 15)
        .optional("gain", int, 50)
        .optional("auto_gain", bool, True)
        .optional("verbose", bool, False)
    )

    VALID_RESOLUTIONS = ("VGA", "HD720", "HD1080", "HD2K")

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        try:
            from pyzed import sl  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "ZedSdkSource needs the StereoLabs SDK python bindings "
                "(pyzed); without the SDK use the 'Zed' datasource "
                "(ZedOpenCaptureSource), which reads the same camera over "
                "plain UVC/V4L2"
            ) from e
        self._sl = sl
        self._cam = None
        self._frame_number = 0

    def start(self, camera_queue: PyBoundedQueue):
        sl = self._sl
        res_name = self.cfg["resolution"].upper()
        if res_name not in self.VALID_RESOLUTIONS:
            raise RuntimeError(
                f"unknown ZED resolution '{self.cfg['resolution']}'; "
                f"valid: {'|'.join(self.VALID_RESOLUTIONS)}")
        self._cam = sl.Camera()
        init = sl.InitParameters()
        init.camera_resolution = getattr(sl.RESOLUTION, res_name)
        init.depth_mode = sl.DEPTH_MODE.NONE
        init.sdk_verbose = self.cfg["verbose"]
        init.camera_fps = self.cfg["fps"]
        status = self._cam.open(init)
        if status != sl.ERROR_CODE.SUCCESS:
            self._cam = None
            raise RuntimeError(f"cannot open ZED camera via SDK: {status}")
        self._cam.set_camera_settings(sl.VIDEO_SETTINGS.EXPOSURE, self.cfg["exposure"])
        self._cam.set_camera_settings(sl.VIDEO_SETTINGS.GAIN, self.cfg["gain"])
        super().start(camera_queue)

    def _loop(self, thread: ManagedThread):
        sl = self._sl
        if self._cam.grab() != sl.ERROR_CODE.SUCCESS:
            time.sleep(0.05)          # maybe one failed frame: keep receiving
            return
        left, right = sl.Mat(), sl.Mat()
        if (self._cam.retrieve_image(left, sl.VIEW.LEFT_UNRECTIFIED_GRAY)
                != sl.ERROR_CODE.SUCCESS
                or self._cam.retrieve_image(right, sl.VIEW.RIGHT_UNRECTIFIED_GRAY)
                != sl.ERROR_CODE.SUCCESS):
            time.sleep(0.05)
            return
        img_l = np.asarray(left.get_data(), np.float32)
        img_r = np.asarray(right.get_data(), np.float32)
        self._frame_number += 1
        if self.cfg["auto_gain"] and self._frame_number % 5 == 0:
            gain = 30.0 + (1.0 - float(img_l.mean()) / 255.0) * 60.0
            self._cam.set_camera_settings(sl.VIDEO_SETTINGS.GAIN, round(gain))
        ts_ns = int(self._cam.get_timestamp(sl.TIME_REFERENCE.IMAGE).get_nanoseconds())
        self.camera_queue.push(CameraQueueEntry(
            timestamp=time.time(), image=img_l, image_second=img_r, ros_timestamp=ts_ns))

    def stop(self):
        super().stop()
        if self._cam is not None:
            self._cam.close()
            self._cam = None


class ReplaySource(ImageSourceBase):
    """A recorded .pb stream as a source (record.ReplayEngine): frames to
    the camera queue, IMU and global states to the sensor queue, optionally
    paced at `fps`."""

    schema = ConfigOptions().required("file", str).optional("fps", float, 0.0)

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        from .record import ReplayEngine

        self._engine = ReplayEngine(self.cfg["file"])

    def start(self, camera_queue: PyBoundedQueue):
        self._engine.attach(camera_queue, self.sensor_queue)
        super().start(camera_queue)

    def _loop(self, thread: ManagedThread):
        if self._engine.stream_more() == 0:
            time.sleep(0.02)
        if self.cfg["fps"] > 0:
            time.sleep(1.0 / self.cfg["fps"])

    @property
    def done(self) -> bool:
        return self._engine.done
