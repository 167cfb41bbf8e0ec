"""Synthetic imagery with exact ground truth, numpy on the host (port of
lpslam_tpu/io/synthetic.py, which the port cannot import).

A corner-rich planar texture seen by a moving pinhole camera: the scene is
a plane, so each frame is an exact homography warp of the texture. Poses
come from the port's ``se3_exp`` on the CPU in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.se3 import SE3, se3_exp


def make_texture(h: int = 480, w: int = 640, seed: int = 0, n_shapes: int = 400):
    """Overlapping axis-aligned rectangles of random intensity on mid-gray,
    lightly smoothed. Returns float32 (h, w) in [0, 255]."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 128.0, np.float32)
    max_rw = min(64, max(w // 2, 9))
    max_rh = min(64, max(h // 2, 9))
    for _ in range(n_shapes):
        rw = rng.integers(8, max_rw)
        rh = rng.integers(8, max_rh)
        x0 = rng.integers(0, w - rw)
        y0 = rng.integers(0, h - rh)
        val = rng.uniform(20, 235)
        img[y0 : y0 + rh, x0 : x0 + rw] = val
    k = np.array([0.25, 0.5, 0.25], np.float32)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), 0, img)
    return img.astype(np.float32)


def warp_homography(img: np.ndarray, H: np.ndarray, out_shape=None):
    """Warp img by the homography H (source pixel -> destination pixel):
    bilinear inverse warp, 128 outside the source."""
    if out_shape is None:
        out_shape = img.shape
    oh, ow = out_shape
    Hinv = np.linalg.inv(H)
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    pts = np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1)
    src = Hinv @ pts
    sx = (src[0] / src[2]).reshape(oh, ow)
    sy = (src[1] / src[2]).reshape(oh, ow)
    x0 = np.clip(np.floor(sx).astype(np.int64), 0, img.shape[1] - 2)
    y0 = np.clip(np.floor(sy).astype(np.int64), 0, img.shape[0] - 2)
    fx = np.clip(sx - x0, 0, 1)
    fy = np.clip(sy - y0, 0, 1)
    v = (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )
    oob = (sx < 0) | (sx > img.shape[1] - 1) | (sy < 0) | (sy > img.shape[0] - 1)
    return np.where(oob, 128.0, v).astype(np.float32)


def imu_from_poses(poses, fps: float, gravity=(0.0, 9.81, 0.0)):
    """Body-frame IMU samples from a camera-to-world pose sequence: gyro
    from the rotation between neighbours, accelerometer from the central
    second difference of the positions plus gravity (+y, optical y down).
    Returns (gyro (T, 3), accel (T, 3))."""
    from ..geometry.so3 import so3_log

    T = len(poses)
    dt = 1.0 / max(fps, 1e-9)
    g = np.asarray(gravity, np.float64)
    gyro = np.zeros((T, 3))
    accel = np.zeros((T, 3))
    pos = np.asarray([np.asarray(p.t, np.float64) for p in poses])
    for t in range(T):
        t1 = min(t + 1, T - 1)
        if t1 > t:
            R0 = np.asarray(poses[t].R, np.float64)
            R1 = np.asarray(poses[t1].R, np.float64)
            gyro[t] = so3_log(torch.as_tensor(R0.T @ R1, dtype=torch.float32)).numpy() / dt
        if 0 < t < T - 1:
            a_w = (pos[t + 1] - 2 * pos[t] + pos[t - 1]) / (dt * dt)
        else:
            a_w = np.zeros(3)
        accel[t] = np.asarray(poses[t].R, np.float64).T @ (a_w + g)
    return gyro, accel


class SyntheticSequence(NamedTuple):
    """A planar-scene camera sequence with exact ground truth."""

    images: np.ndarray        # (T, H, W) float32
    poses_wc: list            # SE3 camera-to-world, numpy-backed
    K: np.ndarray             # (3, 3) intrinsics
    plane_z: float            # the scene plane's depth in the world frame
    images_r: np.ndarray = None   # (T, H, W) right eye (stereo)
    depths: np.ndarray = None     # (T, H, W) metric depth (RGB-D)
    baseline: float = 0.0


def waypoint_trajectory(waypoints, num_frames: int, fps: float = 20.0,
                        speed: float = 0.5, kp: float = 2.0, ki: float = 0.05,
                        kd: float = 0.1, tolerance: float = 0.08,
                        yaw_gain: float = 0.15):
    """A planar vehicle steered through `waypoints` [(x, y), ...] by two
    PID loops on the position error, its heading wiggling with the lateral
    velocity. Returns SE3 camera-to-world poses (the camera faces +z)."""
    from ..utils.pid import PidController

    wps = [np.asarray(wp, np.float64) for wp in waypoints]
    dt = 1.0 / max(fps, 1e-6)
    pid_x = PidController(kp, ki, kd, -speed, speed)
    pid_y = PidController(kp, ki, kd, -speed, speed)
    pos = np.array([0.0, 0.0])
    wp_i = 0
    poses = []
    for _ in range(num_frames):
        target = wps[min(wp_i, len(wps) - 1)]
        err = target - pos
        if np.linalg.norm(err) < tolerance and wp_i < len(wps) - 1:
            wp_i += 1
            pid_x.reset()
            pid_y.reset()
        vx = pid_x.update(err[0], dt)
        vy = pid_y.update(err[1], dt)
        pos = pos + np.array([vx, vy]) * dt
        yaw = yaw_gain * vx / max(speed, 1e-6)
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses.append(SE3(R_wc.astype(np.float32),
                         np.array([pos[0], pos[1], 0.0], np.float32)))
    return poses


def make_sequence(num_frames: int = 30, h: int = 480, w: int = 640, seed: int = 0,
                  motion: str = "orbit", fx: float = 460.0, plane_z: float = 5.0,
                  tex_scale: int = 4, stereo_baseline: float = 0.0,
                  with_depth: bool = False, poses: list = None):
    """Render the textured plane z = plane_z seen from a camera that starts
    at the origin looking down +z. motion: "orbit", "forward" or
    "translate", unless `poses` (camera-to-world) are given."""
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]], np.float32)
    tex_h, tex_w = h * tex_scale, w * tex_scale
    tex = make_texture(tex_h, tex_w, seed=seed, n_shapes=600 * tex_scale)
    # the plane point (X, Y, plane_z) is texture pixel (X s + tex_w/2, Y s + tex_h/2)
    span_x = plane_z * w / fx * 2.2
    s = tex_w / span_x
    T_tex2world = np.array(
        [[1 / s, 0, -tex_w / (2 * s)], [0, 1 / s, -tex_h / (2 * s)], [0, 0, 1]]
    )

    given_poses = poses
    poses = []
    images = np.zeros((num_frames, h, w), np.float32)
    images_r = np.zeros((num_frames, h, w), np.float32) if stereo_baseline else None
    depths = np.zeros((num_frames, h, w), np.float32) if with_depth else None

    def render(R_wc, t_wc_vec):
        R_cw = R_wc.T
        A = np.zeros((3, 3))
        A[:, 0] = R_cw[:, 0]
        A[:, 1] = R_cw[:, 1]
        A[:, 2] = R_cw @ (np.array([0, 0, plane_z]) - t_wc_vec)
        return warp_homography(tex, (K @ A) @ T_tex2world, out_shape=(h, w))

    for t in range(num_frames):
        tt = t / max(num_frames - 1, 1)
        if given_poses is not None:
            T_wc = given_poses[min(t, len(given_poses) - 1)]
            R_wc, t_wc = np.asarray(T_wc.R), np.asarray(T_wc.t)
        else:
            if motion == "orbit":
                xi = [0.6 * np.sin(2 * np.pi * tt), 0.3 * (1 - np.cos(2 * np.pi * tt)),
                      0.35 * np.sin(np.pi * tt), 0.04 * np.sin(2 * np.pi * tt),
                      0.06 * np.sin(2 * np.pi * tt), 0.03 * tt]
            elif motion == "forward":
                xi = [0.05 * t, 0.0, 0.08 * t, 0.0, 0.0, 0.0]
            else:  # translate
                xi = [0.08 * t, 0.02 * t, 0.0, 0.0, 0.0, 0.0]
            T = se3_exp(torch.from_numpy(np.array(xi, np.float32)))
            R_wc, t_wc = T.R.numpy(), T.t.numpy()
        poses.append(SE3(R_wc, t_wc))
        images[t] = render(R_wc, t_wc)
        if stereo_baseline:
            # the right camera sits on the left one's +x axis
            images_r[t] = render(R_wc, t_wc + R_wc @ np.array([stereo_baseline, 0, 0]))
        if with_depth:
            # plane depth per pixel: (R_wc ray)_z * s = plane_z - t_z
            ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
            rays = np.stack(
                [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs)],
                axis=-1,
            )
            d_w = rays @ R_wc.T
            depths[t] = ((plane_z - t_wc[2]) / np.maximum(d_w[..., 2], 1e-9)).astype(np.float32)

    return SyntheticSequence(
        images=images, poses_wc=poses, K=K, plane_z=plane_z,
        images_r=images_r, depths=depths, baseline=stereo_baseline,
    )
