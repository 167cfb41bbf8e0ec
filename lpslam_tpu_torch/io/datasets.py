"""Dataset readers, EuRoC MAV and TUM RGB-D (port of
lpslam_tpu/io/datasets.py): timestamped frames plus ground truth. Images
are read by io/png.py as ``cv2.imread`` would (gray for the cameras,
unchanged 16-bit for TUM depth); frames and ground truth are the
``DatasetFrame`` and ``GroundTruth`` of io/benchmark.py.
"""
from __future__ import annotations

import csv
import os
from typing import Iterator, Optional

import numpy as np

from .benchmark import DatasetFrame, GroundTruth
from .png import imread_gray, imread_unchanged


class EurocDataset:
    """EuRoC MAV layout: mav0/cam0/data.csv + data/*.png, cam1/...,
    state_groundtruth_estimate0/data.csv."""

    def __init__(self, root: str, stereo: bool = True):
        self.root = root
        self.stereo = stereo
        self.cam0 = os.path.join(root, "mav0", "cam0")
        self.cam1 = os.path.join(root, "mav0", "cam1")
        self.entries = self._read_cam_csv(self.cam0)
        self.entries1 = self._read_cam_csv(self.cam1) if stereo else {}

    @staticmethod
    def _read_cam_csv(cam_dir: str) -> dict:
        path = os.path.join(cam_dir, "data.csv")
        out = {}
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                out[int(row[0])] = row[1].strip()
        return out

    def ground_truth(self) -> Optional[GroundTruth]:
        path = os.path.join(self.root, "mav0", "state_groundtruth_estimate0", "data.csv")
        if not os.path.exists(path):
            return None
        ts, pos, quat = [], [], []
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ts.append(int(row[0]) * 1e-9)
                pos.append([float(row[1]), float(row[2]), float(row[3])])
                quat.append([float(row[4]), float(row[5]), float(row[6]), float(row[7])])
        return GroundTruth(np.asarray(ts), np.asarray(pos), np.asarray(quat))

    def __len__(self):
        return len(self.entries)

    def __iter__(self) -> Iterator[DatasetFrame]:
        for ts_ns in sorted(self.entries):
            img = imread_gray(os.path.join(self.cam0, "data", self.entries[ts_ns]))
            if img is None:
                continue
            right = None
            if self.stereo and ts_ns in self.entries1:
                right = imread_gray(os.path.join(self.cam1, "data", self.entries1[ts_ns]))
                right = None if right is None else right.astype(np.float32)
            yield DatasetFrame(timestamp=ts_ns * 1e-9, image=img.astype(np.float32),
                               image_right=right)


class TumRgbdDataset:
    """TUM RGB-D layout: rgb.txt / depth.txt / groundtruth.txt of
    'timestamp filename' lines; depth in 1/5000 m."""

    DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, root: str, with_depth: bool = True, max_dt: float = 0.02):
        self.root = root
        self.rgb = self._read_list(os.path.join(root, "rgb.txt"))
        self.depth = self._read_list(os.path.join(root, "depth.txt")) if with_depth else []
        self.max_dt = max_dt

    @staticmethod
    def _read_list(path: str) -> list:
        out = []
        if not os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts, fname = line.split()[:2]
                out.append((float(ts), fname))
        return out

    def ground_truth(self) -> Optional[GroundTruth]:
        path = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        ts, pos, quat = [], [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals = [float(v) for v in line.split()]
                ts.append(vals[0])
                pos.append(vals[1:4])
                quat.append([vals[7], vals[4], vals[5], vals[6]])  # stored qx qy qz qw
        return GroundTruth(np.asarray(ts), np.asarray(pos), np.asarray(quat))

    def __len__(self):
        return len(self.rgb)

    def __iter__(self) -> Iterator[DatasetFrame]:
        depth_ts = np.asarray([t for t, _ in self.depth]) if self.depth else None
        for ts, fname in self.rgb:
            img = imread_gray(os.path.join(self.root, fname))
            if img is None:
                continue
            depth = None
            if depth_ts is not None and len(depth_ts):
                j = int(np.argmin(np.abs(depth_ts - ts)))
                if abs(depth_ts[j] - ts) <= self.max_dt:
                    d = imread_unchanged(os.path.join(self.root, self.depth[j][1]))
                    if d is not None:
                        depth = d.astype(np.float32) * self.DEPTH_SCALE
            yield DatasetFrame(timestamp=ts, image=img.astype(np.float32), depth=depth)


# published intrinsics of the benchmark sequences
EUROC_CAM0 = {
    "fx": 458.654, "fy": 457.296, "cx": 367.215, "cy": 248.375,
    "dist": np.asarray([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
    "model": "perspective", "width": 752, "height": 480,
    "baseline": 0.110074,  # approx cam0-cam1
}
EUROC_CAM1 = {
    "fx": 457.587, "fy": 456.134, "cx": 379.999, "cy": 255.238,
    "dist": np.asarray([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0]),
    "model": "perspective", "width": 752, "height": 480,
}
# body -> sensor extrinsics from the published EuRoC sensor.yaml files
EUROC_T_BS_CAM0 = np.asarray([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0],
])
EUROC_T_BS_CAM1 = np.asarray([
    [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
    [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
    [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
    [0.0, 0.0, 0.0, 1.0],
])


def euroc_stereo_extrinsics():
    """(R_rl, t_rl): the right camera (cam1) w.r.t. the left (cam0),
    T_c1_c0 = inv(T_BS_cam1) @ T_BS_cam0."""
    T = np.linalg.inv(EUROC_T_BS_CAM1) @ EUROC_T_BS_CAM0
    return T[:3, :3].copy(), T[:3, 3].copy()


TUM_FR1 = {
    "fx": 517.3, "fy": 516.5, "cx": 318.6, "cy": 255.3,
    "dist": np.asarray([0.2624, -0.9531, -0.0054, 0.0026, 1.1633]),
    "model": "perspective", "width": 640, "height": 480,
}
TUM_FR2 = {
    "fx": 520.9, "fy": 521.0, "cx": 325.1, "cy": 249.7,
    "dist": np.asarray([0.2312, -0.7849, -0.0033, -0.0001, 0.9172]),
    "model": "perspective", "width": 640, "height": 480,
}
TUM_FR3 = {
    "fx": 535.4, "fy": 539.2, "cx": 320.1, "cy": 247.6,
    "dist": np.zeros(5),
    "model": "perspective", "width": 640, "height": 480,
}
