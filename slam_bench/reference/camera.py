"""The plain reference's camera model: the undistortion and stereo
rectification grids worked out again from the lens, and the bilinear remap
that applies them.

Frozen copies of the port's plain numpy builders (geometry/camera.py:
undistort_map_radtan, the radtan branch of rectify_maps_stereo; OpenCV's
``initUndistortRectifyMap`` and ``stereoRectify(alpha=0,
CALIB_ZERO_DISPARITY)``) and of kernels/remap.py. Imports nothing of the
program.
"""
from __future__ import annotations

import numpy as np
import torch


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


def rectify_maps_stereo(K_l, dist_l, K_r, dist_r, R_rl, t_rl, image_size):
    """Rectification grids of a radtan stereo pair with zero disparity at
    infinity: dict(map_l, map_r (H, W, 2) float32 source coordinates,
    K_new (3, 3) float32, focal_x_baseline)."""
    H, W = image_size
    Ks = [np.asarray(K_l, np.float64), np.asarray(K_r, np.float64)]
    T = np.asarray(t_rl, np.float64).reshape(3)
    dists = [_dist8(d) for d in (dist_l, dist_r)]
    Rs, Ps = _stereo_rectify_radtan(Ks, dists, np.asarray(R_rl, np.float64), T, (H, W))
    maps = [_rectify_map(K, d, R, P, (H, W)) for K, d, R, P in zip(Ks, dists, Rs, Ps)]
    return {"map_l": maps[0], "map_r": maps[1],
            "K_new": Ps[0][:3, :3].astype(np.float32),
            "focal_x_baseline": float(-Ps[1][0, 3])}


def remap_bilinear(img, mapxy):
    """img: (H, W) or (B, H, W) float32; mapxy: (H', W', 2) sample coords
    (x, y) into img. Out-of-range samples clamp to the border."""
    batched = img.dim() == 3
    if not batched:
        img = img[None]
    b, h, w = img.shape
    x = mapxy[..., 0]
    y = mapxy[..., 1]
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)

    flat = img.reshape(b, -1)
    idx00 = (y0 * w + x0).reshape(-1)

    def g(off):
        return flat.index_select(1, idx00 + off).reshape(b, *x.shape)

    out = (
        g(0) * (1 - fx) * (1 - fy)
        + g(1) * fx * (1 - fy)
        + g(w) * (1 - fx) * fy
        + g(w + 1) * fx * fy
    )
    return out if batched else out[0]
