"""The public facade (port of lpslam_tpu/interface/lpslam_manager.py): add
sources, processors and trackers by name, push images and sensor data,
register callbacks (reconstruction, JPEG image, navigation requests), use
the mapping API, record a session or replay one, start and stop, on `device`
(default cuda). The live view (``set_show_live_stream``) shows every 10th
frame with OpenCV's imshow and turns itself off where that fails.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

from ..pipeline.config import CameraConfig
from ..pipeline.manager import SlamManager, SlamStatus
from ..pipeline.record import _encode_jpeg

LpSlamStatus = SlamStatus


class LpSlamManager:
    """Forwards to a SlamManager; the add_* and read_* calls return False
    instead of raising."""

    def __init__(self, device="cuda"):
        self._m = SlamManager(device=device)

    # configuration ---------------------------------------------------------

    def read_configuration_file(self, path: str) -> bool:
        try:
            self._m.read_configuration_file(path)
            return True
        except Exception:
            logging.getLogger("lpslam_tpu_torch").exception(
                "reading configuration %s failed", path)
            return False

    def set_camera_configuration(self, cam: CameraConfig) -> None:
        self._m.set_camera_configuration(cam)

    # logging ---------------------------------------------------------------

    def log_to_file(self, filename: str) -> None:
        h = logging.FileHandler(filename)
        h.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
        logging.getLogger("lpslam_tpu_torch").addHandler(h)

    def set_log_level(self, level: str) -> None:
        """level: 'Debug' | 'Info' | 'Error'."""
        lut = {"debug": logging.DEBUG, "info": logging.INFO, "error": logging.WARNING}
        logging.getLogger("lpslam_tpu_torch").setLevel(lut.get(level.lower(), logging.INFO))

    # run-mode toggles ------------------------------------------------------

    def set_show_live_stream(self, enabled: bool) -> None:
        self._m.show_live = bool(enabled)

    def set_write_image_files(self, enabled: bool, directory: str = "lpslam_frames") -> None:
        self._m.store_images_dir = directory if enabled else None

    def set_record(self, enabled: bool) -> None:
        self._m.set_recording(enabled)

    def set_record_images(self, enabled: bool) -> None:
        self._m.recorder.record_images = bool(enabled)

    def read_replay_items(self, filename: str) -> bool:
        """Add a recorded .pb stream as a source."""
        try:
            self._m.add_source_by_name("Replay", {"file": filename})
            return True
        except Exception:
            logging.getLogger("lpslam_tpu_torch").exception("replay of %s failed", filename)
            return False

    # stage registry --------------------------------------------------------

    def add_image_data_source(self, type_name: str, config: Optional[dict] = None) -> bool:
        try:
            self._m.add_source_by_name(type_name, config)
            return True
        except Exception:
            return False

    def add_image_processor(self, type_name: str, config: Optional[dict] = None) -> bool:
        try:
            self._m.add_processor_by_name(type_name, config)
            return True
        except Exception:
            return False

    def add_tracker(self, type_name: str, config: Optional[dict] = None) -> bool:
        try:
            self._m.add_tracker_by_name(type_name, config)
            return True
        except Exception:
            return False

    # lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._m.start()

    def stop(self) -> None:
        self._m.stop()

    # data ingestion --------------------------------------------------------

    def add_image_from_buffer(self, timestamp: float, buffer: np.ndarray,
                              camera_number: int = 0, **kw) -> bool:
        return self._m.add_image_from_buffer(timestamp, buffer, camera_number, **kw)

    def add_stereo_image_from_buffer(self, timestamp: float, left: np.ndarray,
                                     right: np.ndarray, camera_number: int = 0,
                                     **kw) -> bool:
        return self._m.add_stereo_image_from_buffer(timestamp, left, right, camera_number, **kw)

    def _file_source(self):
        from ..pipeline.sources import FileImageSource

        for src in self._m.sources:
            if isinstance(src, FileImageSource):
                return src
        src = FileImageSource({})
        self._m.add_source(src)
        return src

    def add_image_from_file(self, filename: str) -> None:
        """Queue an image file on the (first or a new) file source."""
        self._file_source().add_image(filename)

    def add_stereo_image_from_files(self, left: str, right: str) -> None:
        self._file_source().add_stereo_image(left, right)

    def add_imu_data(self, timestamp: float, acc, gyro) -> None:
        self._m.add_imu(timestamp, acc, gyro)

    def add_global_state(self, timestamp: float, position, rotation,
                         reference: bool = False) -> None:
        self._m.add_global_state(timestamp, position, rotation, reference)

    def update_global_reference_state(self, timestamp: float, position, rotation) -> None:
        """Push a reference (ground-truth) global state."""
        self._m.add_global_state(timestamp, position, rotation, reference=True)

    # callbacks -------------------------------------------------------------

    def set_reconstruction_callback(self, cb: Callable) -> None:
        self._m.on_reconstruction = cb

    def set_image_callback(self, cb: Callable) -> None:
        self._m.on_image = cb

    def set_request_nav_data_callback(self, cb: Callable) -> None:
        self._m.request_nav_data = cb

    def set_request_nav_transformation_callback(self, cb: Callable) -> None:
        self._m.request_nav_transformation = cb

    def add_marker(self, marker_id: int, position, orientation_wxyz) -> None:
        self._m.add_marker(marker_id, position, orientation_wxyz)

    # mapping ---------------------------------------------------------------

    def mapping_add_laser_scan(self, timestamp: float, ranges, angle_min: float,
                               angle_increment: float, range_max: float) -> None:
        self._m.add_laser_scan(timestamp, ranges, angle_min, angle_increment, range_max)

    def mapping_get_map_raw(self):
        return self._m.mapping_get_map_raw()

    def mapping_get_features(self, max_count: int = 0, boundary=None, transform=None):
        """Landmarks in the lpslam frame; optional map-plane boundary
        ((y_min, z_min), (y_max, z_max)) and 3x3 / flat-9 transform."""
        return self._m.mapping_get_features(max_count, boundary=boundary, transform=transform)

    def mapping_get_features_count(self, boundary=None) -> int:
        return self._m.mapping_get_features_count(boundary=boundary)

    def mapping_set_mode(self, enable_mapping: bool) -> bool:
        """Freeze or resume mapping on every tracker."""
        ok = False
        for tr in self._m.trackers:
            if hasattr(tr, "set_mapping_mode"):
                tr.set_mapping_mode(enable_mapping)
                ok = True
        return ok

    def mapping_set_filename(self, filename: str) -> bool:
        """Set the map file every tracker saves on stop."""
        ok = False
        for tr in self._m.trackers:
            if "map_file" in getattr(tr, "cfg", {}):
                tr.cfg["map_file"] = filename
                ok = True
        return ok

    def mapping_export_csv(self, path: str) -> bool:
        return self._m.mapping_export_csv(path)

    @staticmethod
    def compress_image(image, quality: int = 70) -> bytes:
        """A frame as grey JPEG bytes."""
        return _encode_jpeg(np.asarray(image), quality)

    # status ----------------------------------------------------------------

    def get_slam_status(self) -> SlamStatus:
        return self._m.get_status()
