"""Pinhole camera and radial-tangential distortion (port of the mono part of
lpslam_tpu/geometry/camera.py), plus a numpy-only undistortion map.

``undistort_map_radtan`` replaces the ``cv2.initUndistortRectifyMap`` call of
lpslam_tpu/pipeline/rectify.py for the mono case (identity rectification,
new camera matrix = K), so the port needs no OpenCV.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PinholeCamera(NamedTuple):
    """Intrinsics fx, fy, cx, cy as 0-d float32 tensors on one device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @classmethod
    def make(cls, fx, fy, cx, cy, device, dtype=torch.float32):
        return cls(*(torch.as_tensor(float(v), dtype=dtype, device=device)
                     for v in (fx, fy, cx, cy)))

    def K(self):
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack(
            [
                torch.stack([self.fx, z, self.cx], dim=-1),
                torch.stack([z, self.fy, self.cy], dim=-1),
                torch.stack([z, z, o], dim=-1),
            ],
            dim=-2,
        )


def project_pinhole(cam: PinholeCamera, p_cam):
    """Camera-frame 3D points (...,3) -> pixels (...,2). No distortion."""
    z = p_cam[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1)


def unproject_pinhole(cam: PinholeCamera, uv, depth=None):
    """Pixels (...,2) -> unit-depth rays (...,3) (or scaled by depth)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if depth is not None:
        ray = ray * depth[..., None]
    return ray


def distort_radtan(xy, dist):
    """Radial-tangential (plumb-bob) distortion of normalized coordinates.
    dist = (k1, k2, p1, p2, k3), OpenCV ordering. Works on torch tensors and
    numpy arrays alike."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    if isinstance(xy, np.ndarray):
        return np.stack([xd, yd], axis=-1)
    return torch.stack([xd, yd], dim=-1)


def undistort_points_radtan(xy_d, dist, iters: int = 8):
    """Invert radial-tangential distortion by fixed-point iteration."""
    xy = xy_d
    for _ in range(iters):
        xy = xy_d - (distort_radtan(xy, dist) - xy)
    return xy


def undistort_map_radtan(K, dist, size):
    """Remap grid for mono undistortion, numpy only.

    K: (3,3) intrinsics; dist: (k1, k2, p1, p2[, k3]); size: (h, w).
    Returns (h, w, 2) float32 source coordinates (x, y) into the raw image:
    for each ideal output pixel, its normalized ray is pushed through the
    distortion model and back through K — what
    ``cv2.initUndistortRectifyMap(K, dist, I, K, (w, h), CV_32FC2)`` computes.
    """
    h, w = size
    K = np.asarray(K, np.float64)
    d = np.zeros(5, np.float64)
    dist = np.asarray(dist, np.float64).reshape(-1)
    d[: min(5, dist.size)] = dist[:5]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (xs - K[0, 2]) / K[0, 0]
    yn = (ys - K[1, 2]) / K[1, 1]
    xyd = distort_radtan(np.stack([xn, yn], axis=-1), d)
    u = K[0, 0] * xyd[..., 0] + K[0, 2]
    v = K[1, 1] * xyd[..., 1] + K[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)
