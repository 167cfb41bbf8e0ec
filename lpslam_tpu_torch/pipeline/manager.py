"""SlamManager, the pipeline's owner (port of lpslam_tpu/pipeline/manager.py).

It owns the camera, sensor and result queues and three worker threads:

- the slam worker refills the camera queue from a replay, pops a camera
  frame, drains the sensor queue up to the frame's timestamp (the last
  non-reference global state is the frame's odometry), asks the host
  application for navigation data, records the frame and its sensor values
  when recording, runs the processors, then the trackers, and pushes their
  results (an invalid result when no tracker produced or deferred one);
- the notify worker pops results and calls the reconstruction callback;
- the image-callback worker JPEG-encodes frames (quality 70) for the image
  callback.

Frames come from sources, a replayed recording, or ``add_image_from_buffer``
(gray, 3- and 4-channel BGR(A) weighted as OpenCV's ``cvtColor``, NV12,
YUYV, JPEG bytes, and two eyes stacked top/bottom or side by side). A
recording goes to ``slam_%Y-%m-%d_%H-%M-%S.pb`` in the working directory.
Every engine tensor lives on the manager's `device`; a CUDA device that does
not exist raises.

The live view (``show_live``) shows every 10th frame with OpenCV's
``imshow``, imported when a frame is shown, and turns itself off at the
first failure (no OpenCV, no display), as the reference does.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..geometry.so3 import rot_to_quat
from ..io.jpeg import decode_gray
from .config import CameraConfig, ConfigError, FullConfig, MarkerConfig, load_config_file
from .processors import (
    AdjustIntensityProcessor,
    BlackoutImageProcessor,
    CameraCalibrationProcessor,
    ProcessorBase,
)
from .queues import (
    BoundedQueue,
    CameraQueueEntry,
    FramerateCompute,
    ManagedThread,
    ResultQueueEntry,
    SensorQueueEntry,
)
from .record import RecordEngine, ReplayEngine, _encode_jpeg
from .rectify import RectifyProcessor
from .sources import (
    FileImageSource,
    bgr_to_gray,
    ImageSourceBase,
    OpenCVCameraSource,
    ReplaySource,
    SyntheticSource,
    ZedOpenCaptureSource,
    ZedSdkSource,
)
from .trackers import LaserScan, TrackerBase, VSLAMTracker


def require_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device that does not exist raises
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device '{device}' asked for, but CUDA is not available")
        if (dev.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"device '{device}' does not exist")
    return dev


@dataclass
class SlamStatus:
    localization: str = "Off"
    landmarks: int = 0
    keyframes: int = 0
    frame_time: float = 0.0
    fps: float = 0.0
    frames_processed: int = 0
    # repr of the last exception a worker raised; "" when healthy
    error: str = ""


SOURCE_REGISTRY = {
    "File": FileImageSource,
    "FileSource": FileImageSource,
    "OpenCV": OpenCVCameraSource,
    "Synthetic": SyntheticSource,
    "Webots": SyntheticSource,            # simulation alias
    "Zed": ZedOpenCaptureSource,
    "ZedSdk": ZedSdkSource,
    "Replay": ReplaySource,
}

PROCESSOR_REGISTRY = {
    "BlackoutImage": BlackoutImageProcessor,
    "AdjustIntensity": AdjustIntensityProcessor,
    "CameraCalibration": CameraCalibrationProcessor,
    "Rectify": RectifyProcessor,
}

class SlamManager:
    """Pipeline owner. Register stages by name or as instances, then
    start()."""

    def __init__(self, config: Optional[FullConfig] = None, *, device="cuda"):
        self.device = require_device(device)
        self.camera_queue = BoundedQueue(maxsize=64)
        self.sensor_queue = BoundedQueue(maxsize=256)
        self.result_queue = BoundedQueue(maxsize=64)
        self.image_cb_queue = BoundedQueue(maxsize=8)

        self.sources: list = []
        self.processors: list = []
        self.trackers: list = []
        self.cameras: dict = {}
        self.markers: dict = {}  # id -> MarkerConfig (known fiducials)

        self.recorder = RecordEngine()
        self.replay: Optional[ReplayEngine] = None
        self._record_enabled = False

        self._worker: Optional[ManagedThread] = None
        self._notify_worker: Optional[ManagedThread] = None
        self._image_cb_worker: Optional[ManagedThread] = None

        self.on_reconstruction: Optional[Callable] = None
        self.on_image: Optional[Callable] = None
        self.request_nav_data: Optional[Callable] = None
        self.request_nav_transformation: Optional[Callable] = None

        self._fps = FramerateCompute()
        self._frames = 0
        self._running = False
        self.store_images_dir: Optional[str] = None
        self.show_live = False

        if config is not None:
            self.apply_config(config)

    # -- configuration ------------------------------------------------------

    def read_configuration_file(self, path: str) -> None:
        self.apply_config(load_config_file(path))

    def apply_config(self, cfg: FullConfig) -> None:
        self.cameras = dict(cfg.cameras)
        for mk in cfg.markers:
            self.markers[mk.marker_id] = mk
        self._record_enabled = cfg.manager.record
        self.recorder.record_images = cfg.manager.record_images
        self.show_live = cfg.manager.show_live
        for type_name, conf in cfg.datasources:
            self.add_source_by_name(type_name, conf)
        for type_name, conf in cfg.processors:
            self.add_processor_by_name(type_name, conf)
        for type_name, conf in cfg.trackers:
            self.add_tracker_by_name(type_name, conf)

    def set_recording(self, enabled: bool) -> None:
        """Record the session (from the next start())."""
        self._record_enabled = bool(enabled)

    def set_camera_configuration(self, cam: CameraConfig):
        self.cameras[cam.number] = cam

    def get_camera_configuration(self, number: int) -> Optional[CameraConfig]:
        return self.cameras.get(number)

    def _camera_model(self, number: int = 0) -> PinholeCamera:
        cc = self.cameras.get(number)
        if cc is None or cc.fx == 0:
            raise ConfigError(f"no camera configuration for camera {number}")
        return PinholeCamera.make(cc.fx, cc.fy, cc.cx, cc.cy, device=self.device)

    # -- registry -----------------------------------------------------------

    def add_source_by_name(self, type_name: str, config: Optional[dict] = None):
        cls = SOURCE_REGISTRY.get(type_name)
        if cls is None:
            raise ConfigError(f"unknown datasource type '{type_name}'")
        src = cls(config)
        self.sources.append(src)
        return src

    def add_processor_by_name(self, type_name: str, config: Optional[dict] = None):
        cls = PROCESSOR_REGISTRY.get(type_name)
        if cls is None:
            raise ConfigError(f"unknown processor type '{type_name}'")
        if cls is RectifyProcessor:
            proc = RectifyProcessor(config, device=self.device)
            n = proc.cfg["camera_number"]
            cam = self.cameras.get(n)
            if cam is not None:
                proc.configure(cam, self.cameras.get(n + 1))
        else:
            proc = cls(config)
        self.processors.append(proc)
        return proc

    def add_tracker_by_name(self, type_name: str, config: Optional[dict] = None):
        if type_name not in ("VSLAM", "OpenVSLAM", "OpenVSLAMStereo"):
            raise ConfigError(f"unknown tracker type '{type_name}'")
        config = dict(config or {})
        if type_name == "OpenVSLAMStereo":
            config.setdefault("mode", "stereo")
        cam_number = config.pop("camera_number", 0)
        cc = self.cameras.get(cam_number)
        if cc is not None and cc.focal_x_baseline and "focal_x_baseline" not in config:
            config["focal_x_baseline"] = cc.focal_x_baseline
        # the camera's mask settings flow into the tracker
        if cc is not None and cc.mask_radius and "mask_radius" not in config:
            config["mask_radius"] = float(cc.mask_radius)
        if cc is not None and cc.mask_image and "mask_image" not in config:
            config["mask_image"] = cc.mask_image
        tracker = VSLAMTracker(self._camera_model(cam_number), config, device=self.device)
        self.trackers.append(tracker)
        return tracker

    def add_source(self, src: ImageSourceBase):
        self.sources.append(src)

    def add_processor(self, proc: ProcessorBase):
        self.processors.append(proc)

    def add_tracker(self, tracker: TrackerBase):
        self.trackers.append(tracker)

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._running:
            return
        for tracker in self.trackers:
            tracker.start(self.sensor_queue)
        for src in self.sources:
            src.start_sensor(self.sensor_queue)
            src.start(self.camera_queue)
        self._worker = ManagedThread(self._work, name="slam-worker")
        self._worker.start()
        self._notify_worker = ManagedThread(self._notify, name="notify")
        self._notify_worker.start()
        self._image_cb_worker = ManagedThread(self._image_cb, name="image-cb")
        self._image_cb_worker.start()
        if self._record_enabled:
            self.recorder.set_output_file(time.strftime("slam_%Y-%m-%d_%H-%M-%S.pb"))
            self.recorder.start()
        self._running = True

    def stop(self):
        if not self._running:
            return
        for src in self.sources:
            src.stop()
        # the frame in progress finishes before flush() touches the trackers
        self._worker.stop(join_timeout=600.0)
        # flush deferred chunk results while the notify worker still runs,
        # so clients receive every frame's result before shutdown
        for tracker in self.trackers:
            self._push_results(tracker.flush())
        deadline = time.monotonic() + 2.0
        while not self.result_queue.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        self._notify_worker.stop()
        self._image_cb_worker.stop()
        for tracker in self.trackers:
            tracker.stop()
        if self._record_enabled:
            self.recorder.stop()
        self._running = False

    # -- external-buffer ingestion ------------------------------------------

    def add_image_from_buffer(self, timestamp: float, buffer: np.ndarray,
                              camera_number: int = 0, compressed: Optional[bytes] = None,
                              ros_timestamp: Optional[int] = None,
                              pixel_format: str = "gray", stereo_layout: str = "none",
                              width: int = 0, height: int = 0):
        """Push one frame. pixel_format: "gray" (8UC1 / 8UC3 / 8UC4 arrays),
        "nv12" (flat Y then UV planes) or "yuyv" / "yuv16" (packed Y0 U Y1 V);
        the planar and packed forms take the flat bytes plus the full
        frame's width and height. stereo_layout: "none", "top_bottom" or
        "side_by_side" splits the frame into two eyes. False when the buffer
        is too small; `compressed` (JPEG bytes) replaces the buffer, False
        when they do not decode."""
        if compressed is not None:
            buffer = decode_gray(compressed)
            if buffer is None:
                return False
            pixel_format = "gray"
        if pixel_format == "nv12":
            flat = np.frombuffer(np.ascontiguousarray(buffer), np.uint8)
            if width * height > flat.size:
                return False
            img = flat[: width * height].reshape(height, width).astype(np.float32)
        elif pixel_format in ("yuyv", "yuv16"):
            flat = np.frombuffer(np.ascontiguousarray(buffer), np.uint8)
            if width * height * 2 > flat.size:
                return False
            # luma is every second byte from byte 0
            img = flat[: width * height * 2].reshape(height, width, 2)[:, :, 0].astype(np.float32)
        else:
            img = self._to_gray_f32(buffer)

        second = None
        if stereo_layout == "top_bottom":
            half = img.shape[0] // 2
            img, second = img[:half], img[half:]
        elif stereo_layout == "side_by_side":
            half = img.shape[1] // 2
            img, second = img[:, :half], img[:, half:]

        self.camera_queue.push(CameraQueueEntry(
            timestamp=timestamp, image=img, image_second=second,
            camera_number=camera_number, ros_timestamp=ros_timestamp,
        ))
        return True

    def add_stereo_image_from_buffer(self, timestamp: float, left: np.ndarray,
                                     right: np.ndarray, camera_number: int = 0,
                                     ros_timestamp: Optional[int] = None):
        self.camera_queue.push(CameraQueueEntry(
            timestamp=timestamp, image=self._to_gray_f32(left),
            image_second=self._to_gray_f32(right), camera_number=camera_number,
            ros_timestamp=ros_timestamp,
        ))
        return True

    @staticmethod
    def _to_gray_f32(buf: np.ndarray) -> np.ndarray:
        """8UC1 as is; 8UC3 / 8UC4 (B, G, R(, A)) to gray; then float32."""
        buf = np.asarray(buf)
        if buf.ndim == 3 and buf.shape[2] in (3, 4):
            buf = bgr_to_gray(buf)
        return buf.astype(np.float32)

    def add_imu(self, timestamp: float, acc, gyro):
        self.sensor_queue.push(SensorQueueEntry(
            timestamp=timestamp, kind="imu",
            acc=np.asarray(acc, np.float64), gyro=np.asarray(gyro, np.float64),
        ))

    def add_global_state(self, timestamp: float, position, rotation, reference=False):
        self.sensor_queue.push(SensorQueueEntry(
            timestamp=timestamp, kind="global_state",
            state=(np.asarray(position), np.asarray(rotation)), reference=reference,
        ))

    def add_marker(self, marker_id: int, position, orientation_wxyz):
        """Register a known marker's global pose."""
        self.markers[marker_id] = MarkerConfig(
            marker_id=marker_id,
            position=np.asarray(position, np.float64),
            orientation_wxyz=np.asarray(orientation_wxyz, np.float64),
        )

    def vehicle_pose_from_marker(self, marker_id: int, measured_pos, measured_q_wxyz):
        """The vehicle's global pose from a measurement of a known marker."""
        mk = self.markers.get(marker_id)
        if mk is None:
            return None
        from ..utils.transformations import vehicle_pose_from_marker_measurement

        return vehicle_pose_from_marker_measurement(
            mk.position, mk.orientation_wxyz, measured_pos, measured_q_wxyz
        )

    def add_laser_scan(self, timestamp: float, ranges, angle_min, angle_increment,
                       range_max):
        ex_R = ex_t = None
        if self.request_nav_transformation is not None:
            # the host application's laser -> camera transform
            tf = self.request_nav_transformation(timestamp, "laser", "camera")
            if tf is not None:
                ex_t, ex_R = tf
        scan = LaserScan(
            timestamp=timestamp, ranges=np.asarray(ranges, np.float64),
            angle_min=angle_min, angle_increment=angle_increment, range_max=range_max,
            extrinsic_R=ex_R, extrinsic_t=ex_t,
        )
        for tracker in self.trackers:
            tracker.add_laser_scan(scan)

    # -- mapping API --------------------------------------------------------

    def mapping_get_map_raw(self):
        for tracker in self.trackers:
            occ = tracker.get_occupancy_map()
            if occ is not None:
                return occ
        return None

    def mapping_get_features(self, max_count: int = 0, boundary=None, transform=None):
        for tracker in self.trackers:
            if hasattr(tracker, "get_features"):
                return tracker.get_features(max_count, boundary=boundary, transform=transform)
        return []

    def mapping_get_features_count(self, boundary=None) -> int:
        for tracker in self.trackers:
            if hasattr(tracker, "get_features_count"):
                return tracker.get_features_count(boundary=boundary)
        return 0

    def mapping_export_csv(self, path: str):
        for tracker in self.trackers:
            if hasattr(tracker, "export_csv"):
                tracker.export_csv(path)
                return True
        return False

    # -- status -------------------------------------------------------------

    def get_status(self) -> SlamStatus:
        st = SlamStatus(fps=self._fps.fps, frames_processed=self._frames)
        for w in (self._worker, self._notify_worker, self._image_cb_worker):
            if w is not None and w.error is not None:
                st.error = repr(w.error)
                break
        for tracker in self.trackers:
            s = tracker.status()
            if s:
                st.localization = s.get("state", "Off")
                st.landmarks = s.get("landmarks", 0)
                st.keyframes = s.get("keyframes", 0)
                st.frame_time = s.get("frame_time", 0.0)
                break
        return st

    # -- workers ------------------------------------------------------------

    def _work(self, thread: ManagedThread):
        if self.replay is not None:
            self.replay.stream_more()
        entry = self.camera_queue.pop(timeout=0.1)
        if entry is None or not entry.valid:
            return
        self._fps.tick()
        self._frames += 1
        if self.on_image is not None:
            self.image_cb_queue.push(entry)

        # sensor values up to the frame's timestamp (and the first after it)
        sensor_values = []
        nav_odom = None
        while True:
            try:
                sv = self.sensor_queue.get_nowait()
            except Exception:
                break
            sensor_values.append(sv)
            if sv.kind == "global_state" and not sv.reference:
                nav_odom = sv.state
            if sv.timestamp > entry.timestamp:
                break

        # the host application's navigation data: odometry, or (odom, map)
        nav_map = None
        if self.request_nav_data is not None:
            nav = self.request_nav_data(entry.timestamp)
            if nav is not None:
                if isinstance(nav, tuple) and len(nav) == 2 and not isinstance(
                    nav[0], np.ndarray
                ):
                    nav_odom, nav_map = nav
                else:
                    nav_odom = nav
        if entry.state_odom is None and nav_odom is not None:
            entry.state_odom = nav_odom
        if entry.state_map is None and nav_map is not None:
            entry.state_map = nav_map
        if nav_map is None:
            nav_map = entry.state_map

        if self._record_enabled:
            self._record(entry, sensor_values)

        # live view every 10th frame; off at the first failure (no OpenCV,
        # no display), as the reference does
        if self.show_live and self._frames % 10 == 0:
            try:
                import cv2

                cv2.imshow("lpslam", np.clip(entry.image, 0, 255).astype(np.uint8))
                cv2.waitKey(1)
            except Exception:
                self.show_live = False

        # every 10th raw frame as PNG
        if self.store_images_dir and self._frames % 10 == 0:
            from ..io.png import write_png

            os.makedirs(self.store_images_dir, exist_ok=True)
            write_png(os.path.join(self.store_images_dir, f"frame_{self._frames:06d}.png"),
                      np.clip(entry.image, 0, 255).astype(np.uint8))

        for proc in self.processors:
            entry = proc.process_image(entry)

        sent = False
        deferred = False
        all_results = []
        for tracker in self.trackers:
            results = tracker.process_image(entry, nav_odom, nav_map, sensor_values)
            if results is None:
                # a chunked tracker buffered the frame: its result comes at
                # the chunk boundary
                deferred = True
                continue
            all_results.append(results)
        # every processor sees this frame's sensor values and results
        flat_results = [r for rs in all_results for r in rs]
        for proc in self.processors:
            proc.process_results(sensor_values, flat_results)
        for results in all_results:
            if self._push_results(results):
                sent = True
        if not sent and not deferred:
            # an invalid reconstruction, so clients see the gap
            self.result_queue.push(ResultQueueEntry(
                timestamp=entry.timestamp, position=np.zeros(3),
                orientation_wxyz=np.asarray([1.0, 0, 0, 0]), valid=False,
            ))

    def _record(self, entry: CameraQueueEntry, sensor_values) -> None:
        """The frame (with its navigation states) and its sensor values."""
        self.recorder.store_camera_image(entry)
        for sv in sensor_values:
            if sv.kind == "imu":
                self.recorder.store_imu(sv.timestamp, sv.acc, sv.gyro)
            elif sv.kind == "global_state" and sv.state is not None:
                pos, R = sv.state
                q = rot_to_quat(torch.as_tensor(np.asarray(R), dtype=torch.float32)).numpy()
                self.recorder.store_global_state(sv.timestamp, pos, q, reference=sv.reference)

    def _push_results(self, results) -> bool:
        sent = False
        for res in results:
            rq = ResultQueueEntry(
                timestamp=res.timestamp,
                position=res.position,
                orientation_wxyz=res.orientation_wxyz,
                valid=res.valid,
                position_sigma=getattr(res, "position_sigma", None),
                orientation_sigma=getattr(res, "orientation_sigma", 0.0),
            )
            if self._record_enabled and res.valid:
                self.recorder.store_result(
                    res.timestamp, res.position, res.orientation_wxyz,
                    position_sigma=rq.position_sigma, orientation_sigma=rq.orientation_sigma)
            self.result_queue.push(rq)
            sent = True
        return sent

    def _notify(self, thread: ManagedThread):
        res = self.result_queue.pop(timeout=0.1)
        if res is None:
            return
        if self.on_reconstruction is not None:
            self.on_reconstruction(res)

    def _image_cb(self, thread: ManagedThread):
        entry = self.image_cb_queue.pop(timeout=0.1)
        if entry is None or self.on_image is None:
            return
        second = None
        if entry.image_second is not None:
            second = _encode_jpeg(entry.image_second, quality=70)
        self.on_image(entry.timestamp, _encode_jpeg(entry.image, quality=70), second)
