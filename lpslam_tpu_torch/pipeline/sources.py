"""Frame sources, the producers that feed the camera queue (port of
lpslam_tpu/pipeline/sources.py).

- FileImageSource reads mono or stereo image files (PNG, through
  io/png.py) at a fixed rate, optionally looping;
- SyntheticSource renders the planar-scene sequence and publishes each
  frame's ground-truth pose (plus optional noise) as a global state on the
  sensor queue, and optionally IMU samples;
- ReplaySource streams a recorded .pb session.

The live camera sources (OpenCV, Zed, ZedSdk) keep their schema and names
but raise NotImplementedError when built: ROADMAP Queue 1 item 21.
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


class _RefusedSource(ImageSourceBase):
    """A source of a later slice: the schema parses, building raises."""

    what = ""

    def __init__(self, config: Optional[dict] = None):
        super().__init__(config)
        raise NotImplementedError(f"{self.what} is not ported to lpslam_tpu_torch yet")


class OpenCVCameraSource(_RefusedSource):
    what = "the OpenCV camera source (ROADMAP Queue 1 item 21)"
    schema = (
        ConfigOptions()
        .optional("device", int, 0)
        .optional("width", int, 0)
        .optional("height", int, 0)
        .optional("fps", float, 0.0)
        .optional("stereo_split", str, "none")
        .optional("open_retries", int, 5)
    )


class ZedOpenCaptureSource(_RefusedSource):
    what = "the ZED UVC camera source (ROADMAP Queue 1 item 21)"
    schema = (
        ConfigOptions()
        .optional("camera_number", int, -1)
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
        .optional("sensors_hid_path", str, "")
    )


class ZedSdkSource(_RefusedSource):
    what = "the ZED SDK camera source (ROADMAP Queue 1 item 21)"
    schema = (
        ConfigOptions()
        .optional("fps", int, 15)
        .optional("resolution", str, "HD720")
        .optional("exposure", int, 15)
        .optional("gain", int, 50)
        .optional("auto_gain", bool, True)
        .optional("verbose", bool, False)
    )


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
