"""Pinhole camera and radial-tangential distortion (port of the pinhole and
radtan parts of lpslam_tpu/geometry/camera.py), plus numpy-only remap grids.

``undistort_map_radtan`` replaces the ``cv2.initUndistortRectifyMap`` call of
lpslam_tpu/pipeline/rectify.py for the mono case (identity rectification,
new camera matrix = K); ``rectify_maps_stereo`` replaces the
``cv2.stereoRectify`` + ``cv2.initUndistortRectifyMap`` pair of the JAX
``rectify_maps_stereo`` for radtan rigs. So the port needs no OpenCV.
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


def _undistort_points_cv(pts, K, dist, R=None, P=None, iters: int = 5):
    """OpenCV's undistortPoints for the radtan model: `iters` rounds of its
    fixed-point update (x = (x0 - tangential) / radial), then R and the 3x3
    of P applied; float32 in, float32 out, double inside."""
    pts = np.asarray(pts, np.float32).astype(np.float64)
    k1, k2, p1, p2, k3 = dist
    x0 = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    RR = np.eye(3)
    if R is not None:
        RR = np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], axis=-1).astype(np.float32)


def _inner_rectangle(K, dist, R, P, size):
    """The largest axis-aligned rectangle (x, y, w, h as float32) inside the
    image border, sampled on a 9x9 grid and mapped into the rectified
    view."""
    h, w = size
    n = 9
    g = np.arange(n, dtype=np.float32)
    xs = g * np.float32(w) / np.float32(n - 1)
    ys = g * np.float32(h) / np.float32(n - 1)
    grid = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    p = _undistort_points_cv(grid, K, dist, R, P).reshape(n, n, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, -1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[-1, :, 1].min()
    return ix0, iy0, np.float32(ix1 - ix0), np.float32(iy1 - iy0)


def _rectify_map(K, dist, R, P, size):
    """(h, w, 2) float32 source coordinates of each rectified pixel: its ray
    through inv(P R), the radtan model, and K."""
    h, w = size
    k1, k2, p1, p2, k3 = dist
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ R)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    X = iR[0, 0] * xs + iR[0, 1] * ys + iR[0, 2]
    Y = iR[1, 0] * xs + iR[1, 1] * ys + iR[1, 2]
    Wh = iR[2, 0] * xs + iR[2, 1] * ys + iR[2, 2]
    x, y = X / Wh, Y / Wh
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * 2 * x * y + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * 2 * x * y
    u = K[0, 0] * xd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return np.stack([u, v], axis=-1).astype(np.float32)


def rectify_maps_stereo(K_l, dist_l, K_r, dist_r, R_rl, t_rl, image_size):
    """Rectification remap grids for a radtan (perspective) stereo pair
    (Bouguet's method, the new camera chosen as OpenCV's alpha=0 with zero
    disparity at infinity).

    K_l, K_r: 3x3 intrinsics; dist_l / dist_r: (k1, k2, p1, p2[, k3]);
    R_rl, t_rl: the right camera w.r.t. the left; image_size: (H, W).
    Returns a dict: map_l, map_r (H, W, 2) float32 sample coordinates into
    the raw images (for kernels.remap.remap_bilinear); K_new, the shared
    rectified intrinsics (3x3 float32); focal_x_baseline = fx * baseline.
    """
    H, W = image_size
    Ks = [np.asarray(K_l, np.float64), np.asarray(K_r, np.float64)]
    dists = []
    for d in (dist_l, dist_r):
        dd = np.zeros(5)
        d = np.asarray(d, np.float64).reshape(-1)
        dd[: min(5, d.size)] = d[:5]
        dists.append(dd)
    T = np.asarray(t_rl, np.float64).reshape(3)

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
        ix, iy, iw, ih = _inner_rectangle(K, d, R, P, (H, W))
        s0 = max(s0,
                 cx / (cx - float(ix)), cy / (cy - float(iy)),
                 (nx - 1 - cx) / (float(np.float32(ix + iw)) - cx),
                 (ny - 1 - cy) / (float(np.float32(iy + ih)) - cy))
    fc_new *= s0
    for P in Ps:
        P[0, 0] = P[1, 1] = fc_new
    Ps[1][idx, 3] *= s0

    maps = [_rectify_map(K, d, R, P, (H, W)) for K, d, R, P in zip(Ks, dists, Rs, Ps)]
    return {
        "map_l": maps[0],
        "map_r": maps[1],
        "K_new": Ps[0][:3, :3].astype(np.float32),
        "focal_x_baseline": float(-Ps[1][0, 3]),
    }
