"""Per-frame processors that run before the trackers (port of
lpslam_tpu/pipeline/processors.py).

- BlackoutImageProcessor zeroes frames start_frame..end_frame (fault
  injection for tracking loss and relocalization);
- AdjustIntensityProcessor stretches each eye's contrast between two
  percentiles (stretchlim / imadjust);
- CameraCalibrationProcessor (chessboard detection and intrinsics fit, which
  the JAX package does with OpenCV) is refused: ROADMAP Queue 1 item 22.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .config import ConfigOptions
from .queues import CameraQueueEntry


class ProcessorBase:
    schema = ConfigOptions()

    def __init__(self, config: Optional[dict] = None):
        self.cfg = self.schema.parse(config)

    def process_image(self, entry: CameraQueueEntry) -> CameraQueueEntry:
        return entry

    def process_results(self, sensor_values, results):
        return results


class BlackoutImageProcessor(ProcessorBase):
    schema = (
        ConfigOptions()
        .optional("start_frame", int, 150)
        .optional("end_frame", int, 190)
    )

    def __init__(self, config=None):
        super().__init__(config)
        self._frame = 0

    def process_image(self, entry: CameraQueueEntry) -> CameraQueueEntry:
        f = self._frame
        self._frame += 1
        if self.cfg["start_frame"] <= f <= self.cfg["end_frame"]:
            entry.image = np.zeros_like(entry.image)
            if entry.image_second is not None:
                entry.image_second = np.zeros_like(entry.image_second)
        return entry


def stretchlim(img: np.ndarray, low_pct: float = 1.0, high_pct: float = 99.0):
    """Percentile contrast limits (lo, hi)."""
    lo, hi = np.percentile(img, [low_pct, high_pct])
    if hi <= lo:
        lo, hi = float(img.min()), float(max(img.max(), img.min() + 1))
    return float(lo), float(hi)


def imadjust(img: np.ndarray, lo: float, hi: float, out_max: float = 255.0):
    """Linear intensity map [lo, hi] -> [0, out_max], clipped."""
    scaled = (img.astype(np.float32) - lo) * (out_max / max(hi - lo, 1e-6))
    return np.clip(scaled, 0.0, out_max)


class AdjustIntensityProcessor(ProcessorBase):
    schema = (
        ConfigOptions()
        .optional("low_percentile", float, 1.0)
        .optional("high_percentile", float, 99.0)
    )

    def process_image(self, entry: CameraQueueEntry) -> CameraQueueEntry:
        lo, hi = stretchlim(entry.image, self.cfg["low_percentile"],
                            self.cfg["high_percentile"])
        entry.image = imadjust(entry.image, lo, hi)
        if entry.image_second is not None:
            lo2, hi2 = stretchlim(entry.image_second, self.cfg["low_percentile"],
                                  self.cfg["high_percentile"])
            entry.image_second = imadjust(entry.image_second, lo2, hi2)
        return entry


class CameraCalibrationProcessor(ProcessorBase):
    """Refused: the JAX package fits intrinsics with OpenCV's chessboard
    detector and calibrateCamera, which the port does not have."""

    schema = (
        ConfigOptions()
        .optional("board_cols", int, 9)
        .optional("board_rows", int, 6)
        .optional("square_size", float, 0.025)
        .optional("model", str, "fisheye")
        .optional("min_views", int, 12)
        .optional("novelty_px", float, 15.0)
        .optional("border_margin_px", float, 10.0)
    )

    def __init__(self, config=None):
        super().__init__(config)
        raise NotImplementedError(
            "CameraCalibrationProcessor is not ported to lpslam_tpu_torch yet "
            "(ROADMAP Queue 1 item 22)")
