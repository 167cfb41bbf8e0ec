"""Ray-cast textured room with a closing loop, numpy only (a copy of
lpslam_tpu/io/benchmark.py, which the port cannot import).

A closed box room whose six faces carry corner-rich textures, rendered per
frame on the host through a radial-tangential lens (rays are cast through
the distortion model) with vignetting, exposure/gamma drift and sensor
noise. The undistortion of the ray grid is numpy float32 fixed-point
iteration, the same arithmetic the JAX package runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import numpy as np

from ..geometry.camera import undistort_points_radtan
from .synthetic import make_texture


class DatasetFrame(NamedTuple):
    timestamp: float
    image: np.ndarray                 # (H, W) float32 grayscale
    image_right: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None


class GroundTruth(NamedTuple):
    timestamps: np.ndarray            # (T,)
    positions: np.ndarray             # (T, 3) camera centres, world frame
    quaternions_wxyz: Optional[np.ndarray] = None   # (T, 4), where known

    def positions_at(self, query_ts: np.ndarray) -> np.ndarray:
        """Ground-truth positions at the nearest timestamps."""
        idx = np.searchsorted(self.timestamps, query_ts)
        idx = np.clip(idx, 0, len(self.timestamps) - 1)
        prev = np.clip(idx - 1, 0, len(self.timestamps) - 1)
        use_prev = np.abs(self.timestamps[prev] - query_ts) < np.abs(
            self.timestamps[idx] - query_ts
        )
        return self.positions[np.where(use_prev, prev, idx)]


@dataclass
class _Plane:
    p0: np.ndarray
    n: np.ndarray
    u: np.ndarray
    v: np.ndarray
    half_u: float
    half_v: float
    tex: np.ndarray


def _make_room(seed: int, size=(8.0, 3.0, 5.0), tex_px: int = 768):
    """Box room centred at the origin; optical convention x right, y down,
    z forward."""
    sx, sy, sz = size
    specs = [
        ([0, 0, sz / 2], [0, 0, -1], [1, 0, 0], [0, 1, 0], sx / 2, sy / 2),
        ([0, 0, -sz / 2], [0, 0, 1], [-1, 0, 0], [0, 1, 0], sx / 2, sy / 2),
        ([sx / 2, 0, 0], [-1, 0, 0], [0, 0, -1], [0, 1, 0], sz / 2, sy / 2),
        ([-sx / 2, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0], sz / 2, sy / 2),
        ([0, sy / 2, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], sx / 2, sz / 2),
        ([0, -sy / 2, 0], [0, 1, 0], [1, 0, 0], [0, 0, -1], sx / 2, sz / 2),
    ]
    planes = []
    for i, (p0, n, u, v, hu, hv) in enumerate(specs):
        tw = min(int(2 * hu * 128), tex_px)
        th = min(int(2 * hv * 128), tex_px)
        planes.append(_Plane(
            p0=np.asarray(p0, np.float64), n=np.asarray(n, np.float64),
            u=np.asarray(u, np.float64), v=np.asarray(v, np.float64),
            half_u=hu, half_v=hv,
            tex=make_texture(th, tw, seed=seed * 31 + i, n_shapes=500),
        ))
    return planes


def _ray_grid(h: int, w: int, K: np.ndarray, dist: Optional[np.ndarray]):
    """Per-pixel unit-z camera-frame rays through the lens model."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (xs - K[0, 2]) / K[0, 0]
    yn = (ys - K[1, 2]) / K[1, 1]
    if dist is not None and np.any(np.asarray(dist) != 0):
        xy = np.stack([xn, yn], -1).reshape(-1, 2).astype(np.float32)
        und = undistort_points_radtan(xy, np.asarray(dist, np.float32))
        xn = und[:, 0].reshape(h, w).astype(np.float64)
        yn = und[:, 1].reshape(h, w).astype(np.float64)
    return np.stack([xn, yn, np.ones_like(xn)], axis=-1)


def _render(planes, rays_cam, R_wc, C, rng=None, photometric=None, frame_t=0.0):
    """Ray-cast one frame. Returns (image float32 (h,w), depth float32 (h,w))."""
    img, depth = _render_noiseless(planes, rays_cam, R_wc, C, photometric, frame_t)
    if photometric and rng is not None:
        img = img + rng.normal(0.0, 2.0, img.shape)
    return np.clip(img, 0, 255).astype(np.float32), depth


def _render_noiseless(planes, rays_cam, R_wc, C, photometric, frame_t):
    """_render before the sensor noise: (image float64 (h,w), depth float32)."""
    h, w, _ = rays_cam.shape
    d_w = rays_cam.reshape(-1, 3) @ R_wc.T
    img = np.full(h * w, 128.0, np.float64)
    depth = np.full(h * w, np.inf, np.float64)
    best_t = np.full(h * w, np.inf)
    for pl in planes:
        dn = d_w @ pl.n
        t = ((pl.p0 - C) @ pl.n) / np.where(np.abs(dn) < 1e-12, 1e-12, dn)
        hit = (t > 0.05) & (t < best_t)
        if not hit.any():
            continue
        p = C + d_w[hit] * t[hit, None]
        rel = p - pl.p0
        uu = rel @ pl.u
        vv = rel @ pl.v
        inside = (np.abs(uu) <= pl.half_u) & (np.abs(vv) <= pl.half_v + 1e-9)
        idx = np.flatnonzero(hit)[inside]
        if len(idx) == 0:
            continue
        th, tw = pl.tex.shape
        tx = (uu[inside] / pl.half_u * 0.5 + 0.5) * (tw - 1)
        ty = (vv[inside] / pl.half_v * 0.5 + 0.5) * (th - 1)
        x0 = np.clip(tx.astype(np.int64), 0, tw - 2)
        y0 = np.clip(ty.astype(np.int64), 0, th - 2)
        fx = np.clip(tx - x0, 0, 1)
        fy = np.clip(ty - y0, 0, 1)
        img[idx] = (
            pl.tex[y0, x0] * (1 - fx) * (1 - fy)
            + pl.tex[y0, x0 + 1] * fx * (1 - fy)
            + pl.tex[y0 + 1, x0] * (1 - fx) * fy
            + pl.tex[y0 + 1, x0 + 1] * fx * fy
        )
        best_t[idx] = t[idx]
        depth[idx] = t[idx]

    img = img.reshape(h, w)
    depth = np.where(np.isfinite(depth), depth, 0.0).reshape(h, w).astype(np.float32)
    if photometric:
        ys, xs = np.mgrid[0:h, 0:w]
        r2 = ((xs - w / 2) / (w / 2)) ** 2 + ((ys - h / 2) / (h / 2)) ** 2
        vignette = 1.0 - 0.35 * np.clip(r2 / 2.0, 0, 1)
        exposure = 1.0 + 0.18 * np.sin(2 * np.pi * frame_t * 2.3)
        gamma = 1.0 + 0.12 * np.sin(2 * np.pi * frame_t * 1.1 + 1.0)
        img = 255.0 * np.clip(img * vignette * exposure / 255.0, 1e-6, 1.0) ** gamma
    return img, depth


BENCH_CAM = {
    "fx": 380.0, "fy": 380.0, "cx": 320.0, "cy": 240.0,
    "dist": np.asarray([-0.28, 0.07, 1e-4, -1e-4, 0.0]),
    "model": "perspective", "width": 640, "height": 480,
    "baseline": 0.11,
}


class SyntheticBenchmark:
    """Streamed room-loop sequence: a circle of radius `orbit_r` at walking
    height with a height bob and pitch nod, camera looking outward; with
    `stereo` a right eye `BENCH_CAM["baseline"]` to the right, with
    `with_depth` a depth map per frame."""

    def __init__(self, num_frames: int = 600, h: int = 480, w: int = 640,
                 seed: int = 0, stereo: bool = False, with_depth: bool = False,
                 distortion: bool = True, photometric: bool = True,
                 orbit_r: float = 1.2, fps: float = 20.0, turns: float = 1.08):
        self._args = dict(num_frames=num_frames, h=h, w=w, seed=seed,
                          distortion=distortion, photometric=photometric,
                          orbit_r=orbit_r, fps=fps, turns=turns)
        self.turns = turns
        self.num_frames = num_frames
        self.h, self.w = h, w
        self.stereo = stereo
        self.with_depth = with_depth
        self.photometric = photometric
        self.fps = fps
        self.intr = dict(BENCH_CAM)
        self.intr["width"], self.intr["height"] = w, h
        self.intr["fx"] = self.intr["fy"] = 380.0 * (w / 640.0)
        self.intr["cx"], self.intr["cy"] = w / 2.0, h / 2.0
        if not distortion:
            self.intr["dist"] = np.zeros(5)
        self._K = np.array(
            [[self.intr["fx"], 0, self.intr["cx"]],
             [0, self.intr["fy"], self.intr["cy"]], [0, 0, 1.0]]
        )
        self._planes = _make_room(seed)
        self._rays = _ray_grid(h, w, self._K, self.intr["dist"])
        self._rng = np.random.default_rng(seed + 1000)
        self.orbit_r = orbit_r
        self._poses = [self._pose(i) for i in range(num_frames)]

    def _pose(self, i: int):
        """Camera-to-world pose at frame i: (R_wc, C)."""
        a = 2 * np.pi * self.turns * i / max(self.num_frames - 1, 1)
        C = np.array([
            self.orbit_r * np.sin(a),
            0.25 + 0.08 * np.sin(3.1 * a),
            -self.orbit_r * np.cos(a),
        ])
        z_ax = np.array([np.sin(a), 0.18 * np.sin(2.3 * a), -np.cos(a)])
        z_ax /= np.linalg.norm(z_ax)
        x_ax = np.array([np.cos(a), 0.0, np.sin(a)])
        x_ax -= z_ax * (x_ax @ z_ax)
        x_ax /= np.linalg.norm(x_ax)
        y_ax = np.cross(z_ax, x_ax)
        return np.stack([x_ax, y_ax, z_ax], axis=1), C

    def ground_truth(self) -> GroundTruth:
        return GroundTruth(
            timestamps=np.arange(self.num_frames) / self.fps,
            positions=np.asarray([C for _, C in self._poses]),
        )

    def __len__(self):
        return self.num_frames

    def render_uint8(self) -> np.ndarray:
        """Every (left-eye) frame clipped to uint8, (T, H, W): the bytes of
        iterating the sequence and casting each image. The ray casting is
        spread over spawned processes, one per `_FRAMES_PER_WORKER` frames
        (at most 8, at most the cores); the sensor noise is still drawn
        here, frame by frame from the one stream."""
        if self.stereo:
            raise ValueError("render_uint8 renders the left eye of a mono sequence")
        import multiprocessing as mp
        import os
        from concurrent.futures import ProcessPoolExecutor

        workers = min(8, os.cpu_count() or 1, -(-self.num_frames // _FRAMES_PER_WORKER))
        out = np.empty((self.num_frames, self.h, self.w), np.uint8)
        # one BLAS thread per worker: the workers' small products would
        # otherwise oversubscribe the cores. Spawned workers take the
        # environment as it is when map() starts them.
        saved = {k: os.environ.get(k) for k in _THREAD_VARS}
        os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
        try:
            ex = ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"),
                                     initializer=_worker_init, initargs=(self._args,))
            frames = ex.map(_worker_frame, range(self.num_frames), chunksize=4)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        with ex:
            for i, img in enumerate(frames):
                if self.photometric:
                    img = img + self._rng.normal(0.0, 2.0, img.shape)
                # as __iter__'s float32 image, then cast
                out[i] = np.clip(img, 0, 255).astype(np.float32).astype(np.uint8)
        return out

    def __iter__(self) -> Iterator[DatasetFrame]:
        """Frames in order. stereo: the right eye is rendered at
        C + R_wc @ [baseline, 0, 0] right after the left one, from the same
        noise stream; with_depth: the left eye's z-depth map (0 = no hit)."""
        b = self.intr["baseline"]
        for i in range(self.num_frames):
            R_wc, C = self._poses[i]
            rng = self._rng if self.photometric else None
            ft = i / max(self.num_frames - 1, 1)
            img, depth = _render(
                self._planes, self._rays, R_wc, C,
                rng=rng, photometric=self.photometric, frame_t=ft,
            )
            right = None
            if self.stereo:
                right, _ = _render(
                    self._planes, self._rays, R_wc, C + R_wc @ np.array([b, 0, 0]),
                    rng=rng, photometric=self.photometric, frame_t=ft,
                )
            yield DatasetFrame(
                timestamp=i / self.fps,
                image=img,
                image_right=right,
                depth=depth if self.with_depth else None,
            )


_WORKER_DS = None
# frames per rendering process: a spawned worker starts in ~2 s (mostly
# importing torch), ~16 frames' work at 640x480; 32 keeps it under half
_FRAMES_PER_WORKER = 32
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _worker_init(args: dict) -> None:
    global _WORKER_DS
    _WORKER_DS = SyntheticBenchmark(**args)


def _worker_frame(i: int) -> np.ndarray:
    """Frame i of the worker's sequence before the sensor noise."""
    ds = _WORKER_DS
    R_wc, C = ds._poses[i]
    return _render_noiseless(ds._planes, ds._rays, R_wc, C, ds.photometric,
                             i / max(ds.num_frames - 1, 1))[0]
