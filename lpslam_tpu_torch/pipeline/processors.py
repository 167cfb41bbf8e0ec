"""Per-frame processors that run before the trackers (port of
lpslam_tpu/pipeline/processors.py).

- BlackoutImageProcessor zeroes frames start_frame..end_frame (fault
  injection for tracking loss and relocalization);
- AdjustIntensityProcessor stretches each eye's contrast between two
  percentiles (stretchlim / imadjust);
- CameraCalibrationProcessor collects chessboard views (border rejection,
  novelty selection) and fits fisheye or pinhole intrinsics once it has
  `min_views`. The chessboard detector, the corner refinement and the fits
  are OpenCV's, imported inside ``process_image`` / ``_fit`` only: a
  calibration session needs OpenCV, the SLAM path does not.
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
    """Collects chessboard views and fits intrinsics (fisheye or pinhole);
    `result` holds the fit: model, K, dist and the RMS reprojection error."""

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
        self._img_points: list = []
        self._image_size = None
        self.result: Optional[dict] = None

    def process_image(self, entry: CameraQueueEntry) -> CameraQueueEntry:
        import cv2

        img8 = np.clip(entry.image, 0, 255).astype(np.uint8)
        self._image_size = img8.shape[::-1]
        pattern = (self.cfg["board_cols"], self.cfg["board_rows"])
        found, corners = cv2.findChessboardCorners(
            img8, pattern, cv2.CALIB_CB_ADAPTIVE_THRESH | cv2.CALIB_CB_FAST_CHECK)
        if not found:
            return entry
        corners = cv2.cornerSubPix(
            img8, corners, (5, 5), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.01))
        if self._accept(corners.reshape(-1, 2)):
            self._img_points.append(corners)
            if len(self._img_points) >= self.cfg["min_views"]:
                self._fit()
        return entry

    def _accept(self, pts: np.ndarray) -> bool:
        """Every corner inside the border margin, and the mean corner motion
        against each accepted view at least `novelty_px`."""
        m = self.cfg["border_margin_px"]
        w, h = self._image_size
        if (pts[:, 0].min() < m or pts[:, 1].min() < m
                or pts[:, 0].max() > w - m or pts[:, 1].max() > h - m):
            return False
        return all(np.abs(prev.reshape(-1, 2) - pts).mean() >= self.cfg["novelty_px"]
                   for prev in self._img_points)

    def _fit(self):
        import cv2

        pattern = (self.cfg["board_cols"], self.cfg["board_rows"])
        objp = np.zeros((pattern[0] * pattern[1], 1, 3), np.float64)
        grid = np.mgrid[0:pattern[0], 0:pattern[1]].T.reshape(-1, 2)
        objp[:, 0, :2] = grid * self.cfg["square_size"]
        obj_points = [objp] * len(self._img_points)
        if self.cfg["model"] == "fisheye":
            # OpenCV 4 names the flags in cv2.fisheye, OpenCV 5 in cv2 (other
            # values); OpenCV 5's fisheye.calibrate takes (1, N, 3) / (1, N, 2)
            # point sets only, which OpenCV 4 takes as well
            flags = sum(getattr(cv2.fisheye, n, None) or getattr(cv2, n)
                        for n in ("CALIB_RECOMPUTE_EXTRINSIC", "CALIB_FIX_SKEW"))
            rms, K, D, _, _ = cv2.fisheye.calibrate(
                [o.reshape(1, -1, 3) for o in obj_points],
                [c.reshape(1, -1, 2).astype(np.float64) for c in self._img_points],
                self._image_size, np.eye(3), np.zeros((4, 1)), flags=flags)
            self.result = {"model": "fisheye", "K": K, "dist": D.ravel(), "rms": rms}
        else:
            rms, K, D, _, _ = cv2.calibrateCamera(
                [o.astype(np.float32) for o in obj_points],
                [c.astype(np.float32) for c in self._img_points],
                self._image_size, None, None)
            self.result = {"model": "perspective", "K": K, "dist": D.ravel(), "rms": rms}
