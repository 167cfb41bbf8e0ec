"""Camera models (port of lpslam_tpu/geometry/camera.py): pinhole,
radial-tangential (5 coefficients, or OpenCV's rational 8), fisheye
(equidistant / Kannala-Brandt) and omni (Mei), plus numpy-only remap grids.

The grids replace the OpenCV calls of the JAX package, so the port needs no
OpenCV:
- ``undistort_map_radtan``: ``cv2.initUndistortRectifyMap`` for one camera
  (identity rectification, new camera matrix = K);
- ``undistort_map_fisheye``: ``cv2.fisheye.initUndistortRectifyMap``;
- ``rectify_maps_stereo``: ``cv2.stereoRectify`` (radtan) or
  ``cv2.fisheye.stereoRectify`` (fisheye), each with its
  ``initUndistortRectifyMap``.
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


def distort_fisheye(xy, dist):
    """Equidistant (Kannala-Brandt) fisheye distortion of normalized
    coordinates, OpenCV's fisheye model; dist = (k1, k2, k3, k4)."""
    k1, k2, k3, k4 = (dist[..., i] for i in range(4))
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return torch.stack([x * scale, y * scale], dim=-1)


def undistort_points_fisheye(xy_d, dist, iters: int = 10):
    """Invert the fisheye distortion: theta from theta_d by Newton's method,
    a fixed number of iterations."""
    k1, k2, k3, k4 = (dist[..., i] for i in range(4))
    x, y = xy_d[..., 0], xy_d[..., 1]
    theta_d = torch.sqrt(torch.clamp(x * x + y * y, min=1e-18))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / torch.where(torch.abs(df) < 1e-9, 1e-9, df)
    scale = torch.tan(theta) / theta_d
    return torch.stack([x * scale, y * scale], dim=-1)


def project_omni(p, xi, dist4):
    """Mei's unified omnidirectional model: camera-frame points (..., 3) ->
    normalized distorted coordinates (..., 2); dist4 = (k1, k2, p1, p2)."""
    n = torch.linalg.norm(p, dim=-1, keepdim=True)
    s = p / torch.clamp(n, min=1e-12)
    denom = torch.clamp(s[..., 2:3] + xi, min=1e-6)
    m = s[..., :2] / denom
    k1, k2, p1, p2 = (dist4[..., i] for i in range(4))
    x, y = m[..., 0], m[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def omni_undistort_maps(K, dist5, image_size, R=None, K_new=None):
    """Remap grid that turns an omni (Mei) image into a pinhole view: each
    target pixel's ray through K_new and R, projected by the omni model.

    dist5 = (xi, k1, k2, p1, p2). The rays are projected in float32, as the
    JAX package does (its float64 rays become float32 jax arrays). Returns
    ((H, W, 2) float32 source coordinates, K_new (3, 3) float32); K_new
    defaults to focal (W / 1.7, H / 1.7) at the image centre."""
    H, W = image_size
    if K_new is None:
        K_new = np.array([[W / 1.7, 0, W / 2.0], [0, H / 1.7, H / 2.0], [0, 0, 1.0]])
    if R is None:
        R = np.eye(3)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(xs - K_new[0, 2]) / K_new[0, 0], (ys - K_new[1, 2]) / K_new[1, 1],
                     np.ones_like(xs)], axis=-1)
    rays = rays @ R                    # R^T on each ray: target view -> camera
    dist5 = np.asarray(dist5, np.float64)
    d4 = torch.from_numpy(dist5[1:5].astype(np.float32))
    md = project_omni(torch.from_numpy(rays.astype(np.float32)), float(dist5[0]), d4).numpy()
    u = K[0, 0] * md[..., 0] + K[0, 2]
    v = K[1, 1] * md[..., 1] + K[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32), np.asarray(K_new, np.float32)


def _dist8(dist) -> np.ndarray:
    """Radtan coefficients as OpenCV's 8: (k1, k2, p1, p2, k3, k4, k5, k6);
    4 or 5 given leave the rational denominator at 1."""
    d = np.zeros(8, np.float64)
    dist = np.asarray(dist, np.float64).reshape(-1)
    d[: min(8, dist.size)] = dist[:8]
    return d


def _radial(d, r2):
    """The (rational) radial factor of OpenCV's radtan model."""
    k1, k2, _, _, k3, k4, k5, k6 = d
    return (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)


def undistort_map_radtan(K, dist, size):
    """Remap grid for mono undistortion, numpy only.

    K: (3,3) intrinsics; dist: (k1, k2, p1, p2[, k3[, k4, k5, k6]]), the
    last three the rational model's denominator; size: (h, w). Returns
    (h, w, 2) float32 source coordinates (x, y) into the raw image: for each
    ideal output pixel, its normalized ray is pushed through the distortion
    model and back through K, what
    ``cv2.initUndistortRectifyMap(K, dist, I, K, (w, h), CV_32FC2)`` computes.
    """
    h, w = size
    K = np.asarray(K, np.float64)
    d = _dist8(dist)
    _, _, p1, p2 = d[:4]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x = (xs - K[0, 2]) / K[0, 0]
    y = (ys - K[1, 2]) / K[1, 1]
    r2 = x * x + y * y
    kr = _radial(d, r2)
    xd = x * kr + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * kr + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)


def undistort_map_fisheye(K, dist, size, R=None, P=None):
    """Remap grid of ``cv2.fisheye.initUndistortRectifyMap(K, D, R, P,
    (w, h), CV_32F)`` (its two maps stacked), numpy only.

    Each output pixel's ray goes through inv(P R); theta = atan r, theta_d =
    theta (1 + k1 theta^2 + k2 theta^4 + k3 theta^6 + k4 theta^8), then K. As
    OpenCV does, a row's rays are accumulated column by column, and a ray
    with w <= 0 maps to -inf / +inf (by the sign of x, y), outside any
    image. R defaults to the identity and P to K."""
    h, w = size
    K = np.asarray(K, np.float64)
    k = np.asarray(dist, np.float64).reshape(-1)[:4]
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    PP = K if P is None else np.asarray(P, np.float64)[:3, :3]
    iR = np.linalg.inv(PP @ RR)
    i = np.arange(h, dtype=np.float64)[:, None]

    def acc(row):
        start = i * iR[row, 1] + iR[row, 2]
        return np.add.accumulate(
            np.concatenate([start, np.full((h, w - 1), iR[row, 0])], axis=1), axis=1)

    X, Y, Wh = acc(0), acc(1), acc(2)
    front = Wh > 0
    Ws = np.where(front, Wh, 1.0)
    x, y = X / Ws, Y / Ws
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    theta_d = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8)
    scale = np.where(r == 0, 1.0, theta_d / np.where(r == 0, 1.0, r))
    u = K[0, 0] * x * scale + K[0, 2]
    v = K[1, 1] * y * scale + K[1, 2]
    u = np.where(front, u, np.where(X > 0, -np.inf, np.inf))
    v = np.where(front, v, np.where(Y > 0, -np.inf, np.inf))
    return np.stack([u, v], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# Stereo rectification (numpy, once at start-up): what the JAX package gets
# from cv2.stereoRectify(flags=CALIB_ZERO_DISPARITY, alpha=0) and
# cv2.initUndistortRectifyMap, written out so the port needs no OpenCV.
# ---------------------------------------------------------------------------


def _rodrigues_vec(R):
    """Rotation matrix -> axis-angle vector (OpenCV's Rodrigues, matrix
    orthonormalized first)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt(r @ r * 0.25)
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    if s >= 1e-5:
        return r * (np.arccos(c) / (2.0 * s))
    if c > 0:
        return np.zeros(3)
    raise ValueError("the eyes' relative rotation is near 180 degrees")


def _rodrigues_mat(r):
    """Axis-angle vector -> rotation matrix."""
    r = np.asarray(r, np.float64)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * (Kx @ Kx)


def _undistort_points_cv(pts, K, dist, R=None, P=None, iters: int = 5, dtype=np.float32):
    """OpenCV's undistortPoints for the radtan model (8 coefficients):
    `iters` rounds of its fixed-point update (x = (x0 - tangential) /
    radial, stopping where the radial factor turns negative), then R and
    the 3x3 of P applied; `dtype` in and out, double inside."""
    pts = np.asarray(pts, dtype).astype(np.float64)
    d = _dist8(dist)
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    x0 = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    live = np.ones(len(x0), bool)
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = ((1 + ((k6 * r2 + k5) * r2 + k4) * r2)
                  / (1 + ((k3 * r2 + k2) * r2 + k1) * r2))
        stop = live & (icdist < 0)
        x, y = np.where(stop, x0, x), np.where(stop, y0, y)
        live &= ~stop
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = np.where(live, (x0 - dx) * icdist, x)
        y = np.where(live, (y0 - dy) * icdist, y)
    RR = np.eye(3)
    if R is not None:
        RR = np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], axis=-1).astype(dtype)


def _inner_rectangle(K, dist, R, P, size):
    """The largest axis-aligned rectangle (x0, y0, x1, y1) inside the image
    border mapped into the rectified view, from a 9x9 grid over the pixel
    centres 0..w-1, 0..h-1 (OpenCV 5.0's getUndistortRectangles), double."""
    h, w = size
    n = 9
    g = np.arange(n, dtype=np.float64)
    grid = np.stack(np.meshgrid(g * (w - 1) / (n - 1), g * (h - 1) / (n - 1)),
                    axis=-1).reshape(-1, 2)
    p = _undistort_points_cv(grid, K, dist, R, P, dtype=np.float64).reshape(n, n, 2)
    return p[:, 0, 0].max(), p[0, :, 1].max(), p[:, -1, 0].min(), p[-1, :, 1].min()


def _rectify_map(K, dist, R, P, size):
    """(h, w, 2) float32 source coordinates of each rectified pixel: its ray
    through inv(P R), the radtan model, and K."""
    h, w = size
    d = _dist8(dist)
    _, _, p1, p2 = d[:4]
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ R)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    X = iR[0, 0] * xs + iR[0, 1] * ys + iR[0, 2]
    Y = iR[1, 0] * xs + iR[1, 1] * ys + iR[1, 2]
    Wh = iR[2, 0] * xs + iR[2, 1] * ys + iR[2, 2]
    x, y = X / Wh, Y / Wh
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    kr = _radial(d, r2)
    xd = x * kr + p1 * 2 * x * y + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * 2 * x * y
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)


def _fisheye_undistort_points(pts, K, dist, R):
    """``cv2.fisheye.undistortPoints(pts, K, D, R)`` with its default
    criteria (at most 10 Newton steps, stop below 1e-8), float64; a point
    whose theta changes sign maps to (-1e6, -1e6) as in OpenCV."""
    k = np.asarray(dist, np.float64).reshape(-1)[:4]
    out = []
    for px, py in np.asarray(pts, np.float64):
        pw = ((px - K[0, 2]) / K[0, 0], (py - K[1, 2]) / K[1, 1])
        theta_d = np.sqrt(pw[0] * pw[0] + pw[1] * pw[1])
        theta_d = min(max(-np.pi / 2.0, theta_d), np.pi / 2.0)
        theta, scale, converged = theta_d, 0.0, False
        if abs(theta_d) > 1e-8:
            for _ in range(10):
                t2 = theta * theta
                t4 = t2 * t2
                t6 = t4 * t2
                t8 = t6 * t2
                a, b, c, d = k[0] * t2, k[1] * t4, k[2] * t6, k[3] * t8
                fix = ((theta * (1 + a + b + c + d) - theta_d)
                       / (1 + 3 * a + 5 * b + 7 * c + 9 * d))
                theta = theta - fix
                if abs(fix) < 1e-8:
                    converged = True
                    break
            scale = np.tan(theta) / theta_d
        else:
            converged = True
        flipped = (theta_d < 0 < theta) or (theta < 0 < theta_d)
        if converged and not flipped:
            pr = R @ np.array([pw[0] * scale, pw[1] * scale, 1.0])
            out.append((pr[0] / pr[2], pr[1] / pr[2]))
        else:
            out.append((-1000000.0, -1000000.0))
    return np.asarray(out)


def _fisheye_new_camera(K, dist, size, R):
    """``cv2.fisheye.estimateNewCameraMatrixForUndistortRectify`` with
    balance 0 and fov_scale 1: the four edge midpoints undistorted, and the
    largest of the four focal lengths that put each at its edge."""
    h, w = size
    pts = _fisheye_undistort_points(
        [(w // 2, 0), (w, h // 2), (w // 2, h), (0, h // 2)], K, dist, R)
    cn = pts.sum(axis=0) * 0.25
    aspect = K[0, 0] / K[1, 1]
    cn[1] *= aspect
    pts[:, 1] *= aspect
    (minx, miny), (maxx, maxy) = pts.min(axis=0), pts.max(axis=0)
    f = max(w * 0.5 / (cn[0] - minx), w * 0.5 / (maxx - cn[0]),
            h * 0.5 * aspect / (cn[1] - miny), h * 0.5 * aspect / (maxy - cn[1]))
    c = -cn * f + np.array([w, h * aspect]) * 0.5
    return np.array([[f, 0.0, c[0]], [0.0, f / aspect, c[1] / aspect], [0.0, 0.0, 1.0]])


def _stereo_rectify_fisheye(Ks, dists, R_rl, T, size):
    """``cv2.fisheye.stereoRectify(..., flags=CALIB_ZERO_DISPARITY)`` with
    balance 0, fov_scale 1: (R1, R2), (P1, P2)."""
    r_r = _rodrigues_mat(-0.5 * _rodrigues_vec(R_rl))
    t = r_r @ T
    uu = np.array([1.0 if t[0] > 0 else -1.0, 0.0, 0.0])
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww = ww * (np.arccos(abs(t[0]) / np.linalg.norm(t)) / nw)
    wr = _rodrigues_mat(ww)
    Rs = [wr @ r_r.T, wr @ r_r]
    tnew = Rs[1] @ T
    new = [_fisheye_new_camera(K, d, size, R) for K, d, R in zip(Ks, dists, Rs)]
    fc = min(new[0][1, 1], new[1][1, 1])
    cx = (new[0][0, 2] + new[1][0, 2]) * 0.5
    cy = (new[0][1, 2] + new[1][1, 2]) * 0.5
    Ps = [np.array([[fc, 0.0, cx, 0.0], [0.0, fc, cy, 0.0], [0.0, 0.0, 1.0, 0.0]])
          for _ in range(2)]
    Ps[1][0, 3] = tnew[0] * fc
    return Rs, Ps


def _stereo_rectify_radtan(Ks, dists, R_rl, T, size):
    """``cv2.stereoRectify(..., flags=CALIB_ZERO_DISPARITY, alpha=0)``
    (Bouguet's method): (R1, R2), (P1, P2)."""
    H, W = size
    # split the rotation between the eyes, then turn the baseline onto x
    r_r = _rodrigues_mat(-0.5 * _rodrigues_vec(R_rl))
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0.0:
        ww = ww * (np.arccos(abs(c) / nt) / nw)
    wR = _rodrigues_mat(ww)
    Rs = [wR @ r_r.T, wR @ r_r]
    t = Rs[1] @ T

    # shared focal length and principal points of the rectified pair
    nx, ny = float(W), float(H)
    fc_new = (Ks[0][idx ^ 1, idx ^ 1] + Ks[1][idx ^ 1, idx ^ 1]) * 0.5
    cc = []
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], np.float32)
    for K, d, R in zip(Ks, dists, Rs):
        p = _undistort_points_cv(corners, K, d).astype(np.float64)
        p3 = np.concatenate([p, np.ones((4, 1))], axis=1) @ R.T
        proj = (fc_new * p3[:, :2] / p3[:, 2:]).astype(np.float32)
        avg = proj.astype(np.float64).mean(axis=0)
        cc.append([(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]])
    cc = np.asarray(cc)
    cc[:] = cc.mean(axis=0)                        # CALIB_ZERO_DISPARITY

    def proj_mat(k):
        P = np.zeros((3, 4))
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2], P[2, 2] = cc[k, 0], cc[k, 1], 1.0
        if k == 1:
            P[idx, 3] = t[idx] * fc_new
        return P

    Ps = [proj_mat(0), proj_mat(1)]
    # alpha = 0: scale the focal length so that only valid pixels remain
    s0 = -np.inf
    for K, d, R, P, (cx, cy) in zip(Ks, dists, Rs, Ps, cc):
        ix0, iy0, ix1, iy1 = _inner_rectangle(K, d, R, P, (H, W))
        s0 = max(s0, cx / (cx - ix0), cy / (cy - iy0),
                 (nx - 1 - cx) / (ix1 - cx), (ny - 1 - cy) / (iy1 - cy))
    fc_new *= s0
    for P in Ps:
        P[0, 0] = P[1, 1] = fc_new
    Ps[1][idx, 3] *= s0
    return Rs, Ps


def rectify_maps_stereo(K_l, dist_l, K_r, dist_r, R_rl, t_rl, image_size,
                        model: str = "perspective"):
    """Rectification remap grids for a stereo pair, numpy only.

    K_l, K_r: 3x3 intrinsics; dist_l / dist_r: radtan (k1, k2, p1, p2[, k3[,
    k4, k5, k6]]) or, with model="fisheye", (k1, k2, k3, k4); R_rl, t_rl:
    the right camera w.r.t. the left; image_size: (H, W). The rectification
    is OpenCV's, with zero disparity at infinity: ``cv2.stereoRectify``
    (alpha=0) for "perspective", ``cv2.fisheye.stereoRectify`` (balance 0)
    for "fisheye". Returns a dict: map_l, map_r (H, W, 2) float32 sample
    coordinates into the raw images (for kernels.remap.remap_bilinear);
    K_new, the shared rectified intrinsics (3x3 float32); focal_x_baseline =
    fx * baseline.
    """
    H, W = image_size
    Ks = [np.asarray(K_l, np.float64), np.asarray(K_r, np.float64)]
    T = np.asarray(t_rl, np.float64).reshape(3)
    R_rl = np.asarray(R_rl, np.float64)
    if model == "fisheye":
        dists = [np.asarray(d, np.float64).reshape(-1)[:4] for d in (dist_l, dist_r)]
        Rs, Ps = _stereo_rectify_fisheye(Ks, dists, R_rl, T, (H, W))
        maps = [undistort_map_fisheye(K, d, (H, W), R, P)
                for K, d, R, P in zip(Ks, dists, Rs, Ps)]
    else:
        dists = [_dist8(d) for d in (dist_l, dist_r)]
        Rs, Ps = _stereo_rectify_radtan(Ks, dists, R_rl, T, (H, W))
        maps = [_rectify_map(K, d, R, P, (H, W)) for K, d, R, P in zip(Ks, dists, Rs, Ps)]
    return {
        "map_l": maps[0],
        "map_r": maps[1],
        "K_new": Ps[0][:3, :3].astype(np.float32),
        "focal_x_baseline": float(-Ps[1][0, 3]),
    }
