"""The benchmark's input generator: one closed lap of a textured box room,
rendered on the device; the room's textures come from the configuration's
room seed, the sensor noise from the run's seed.

A frozen copy of the port's room (io/benchmark.py + io/synthetic.py's
``make_texture``), changed in three ways so that a run can replay laps for
as long as its window lasts:
- the orbit is one whole circuit per lap, and the height bob, the pitch nod
  and the exposure and gamma drift have whole periods per lap, so the last
  frame of a lap leads into its first;
- the ray casting runs in torch on the device, a batch of frames per call,
  with the sensor noise drawn from a ``torch.Generator`` on that device;
- a stereo lap renders both eyes in the same calls.

The room's geometry (``BOX``), the orbit (``orbit_pose``) and the lens
(``camera_intrinsics``) are plain numpy, shared with the reference, which
ray-casts the same box for ground-truth depth. Nothing here imports the
program.
"""
from __future__ import annotations

import numpy as np
import torch

BOX = (8.0, 3.0, 5.0)        # room size (x, y, z) in metres, centred at 0
TEX_PX = 768
ORBIT_R = 1.2


def make_texture(h: int, w: int, seed: int, n_shapes: int = 500) -> np.ndarray:
    """Overlapping axis-aligned rectangles of random intensity on mid-gray,
    lightly smoothed: float32 (h, w) in [0, 255]."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 128.0, np.float32)
    max_rw = min(64, max(w // 2, 9))
    max_rh = min(64, max(h // 2, 9))
    for _ in range(n_shapes):
        rw = rng.integers(8, max_rw)
        rh = rng.integers(8, max_rh)
        x0 = rng.integers(0, w - rw)
        y0 = rng.integers(0, h - rh)
        img[y0:y0 + rh, x0:x0 + rw] = rng.uniform(20, 235)
    k = np.array([0.25, 0.5, 0.25], np.float32)
    pad = np.pad(img, 1, mode="constant")
    img = k[0] * pad[1:-1, :-2] + k[1] * pad[1:-1, 1:-1] + k[2] * pad[1:-1, 2:]
    pad = np.pad(img, 1, mode="constant")
    img = k[0] * pad[:-2, 1:-1] + k[1] * pad[1:-1, 1:-1] + k[2] * pad[2:, 1:-1]
    return img.astype(np.float32)


def box_planes():
    """The six faces: (p0, n, u, v, half_u, half_v), optical convention
    (x right, y down, z forward), normals pointing into the room."""
    sx, sy, sz = BOX
    return [
        ([0, 0, sz / 2], [0, 0, -1], [1, 0, 0], [0, 1, 0], sx / 2, sy / 2),
        ([0, 0, -sz / 2], [0, 0, 1], [-1, 0, 0], [0, 1, 0], sx / 2, sy / 2),
        ([sx / 2, 0, 0], [-1, 0, 0], [0, 0, -1], [0, 1, 0], sz / 2, sy / 2),
        ([-sx / 2, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0], sz / 2, sy / 2),
        ([0, sy / 2, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], sx / 2, sz / 2),
        ([0, -sy / 2, 0], [0, 1, 0], [1, 0, 0], [0, 0, -1], sx / 2, sz / 2),
    ]


def orbit_pose(i, lap: int):
    """Camera-to-world pose (R_wc (3, 3), C (3,)) at frame i of a lap of
    `lap` frames, float64: a circle of radius ORBIT_R at walking height,
    looking outward, with a height bob and a pitch nod. Frame `lap` is
    frame 0 again."""
    a = 2 * np.pi * (i % lap) / lap
    C = np.array([ORBIT_R * np.sin(a), 0.25 + 0.08 * np.sin(3 * a), -ORBIT_R * np.cos(a)])
    z_ax = np.array([np.sin(a), 0.18 * np.sin(2 * a), -np.cos(a)])
    z_ax /= np.linalg.norm(z_ax)
    x_ax = np.array([np.cos(a), 0.0, np.sin(a)])
    x_ax -= z_ax * (x_ax @ z_ax)
    x_ax /= np.linalg.norm(x_ax)
    return np.stack([x_ax, np.cross(z_ax, x_ax), z_ax], axis=1), C


def photometric(i, lap: int):
    """(exposure, gamma) at frame i: whole periods per lap."""
    f = (i % lap) / lap
    return 1.0 + 0.18 * np.sin(2 * np.pi * 2 * f), 1.0 + 0.12 * np.sin(2 * np.pi * f + 1.0)


def camera_intrinsics(sensor: dict) -> dict:
    """fx, fy, cx, cy, dist, width, height of the rendered (raw) camera: the
    room's lens (fx = fx_at_640 * width / 640) at the sensor's size."""
    w, h = sensor["width"], sensor["height"]
    f = sensor["fx_at_640"] * w / 640.0
    return {"fx": f, "fy": f, "cx": w / 2.0, "cy": h / 2.0,
            "dist": [float(d) for d in sensor["dist"]], "width": w, "height": h}


def undistort_points_radtan(xy_d, dist, iters: int = 8):
    """Invert radial-tangential distortion by fixed-point iteration
    (float32, as the port's renderer does)."""
    k1, k2, p1, p2, k3 = (np.float32(d) for d in dist)
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = xy_d - (np.stack([xd, yd], -1) - xy)
    return xy


def ray_grid(intr: dict) -> np.ndarray:
    """(h, w, 3) float64 camera-frame rays (unit z) through the lens."""
    h, w = intr["height"], intr["width"]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (xs - intr["cx"]) / intr["fx"]
    yn = (ys - intr["cy"]) / intr["fy"]
    if any(d != 0 for d in intr["dist"]):
        xy = np.stack([xn, yn], -1).reshape(-1, 2).astype(np.float32)
        und = undistort_points_radtan(xy, intr["dist"])
        xn = und[:, 0].reshape(h, w).astype(np.float64)
        yn = und[:, 1].reshape(h, w).astype(np.float64)
    return np.stack([xn, yn, np.ones_like(xn)], axis=-1)


class Room:
    """The room whose textures `room_seed` draws, on `device`, with sensor
    noise drawn from `noise_seed`. ``render(idx, eye_offsets)`` ray-casts
    frames of the lap."""

    def __init__(self, room_seed: int, noise_seed: int, intr: dict, lap: int, device):
        self.intr, self.lap, self.device = intr, lap, torch.device(device)
        self.planes = []
        for i, (p0, n, u, v, hu, hv) in enumerate(box_planes()):
            tw = min(int(2 * hu * 128), TEX_PX)
            th = min(int(2 * hv * 128), TEX_PX)
            tex = make_texture(th, tw, seed=int(room_seed) * 31 + i)
            as_t = lambda a: torch.tensor(a, dtype=torch.float64, device=self.device)  # noqa: E731
            self.planes.append((as_t(p0), as_t(n), as_t(u), as_t(v), hu, hv,
                                torch.from_numpy(tex).to(self.device)))
        self.rays = torch.from_numpy(ray_grid(intr).reshape(-1, 3)).to(self.device)
        h, w = intr["height"], intr["width"]
        ys, xs = np.mgrid[0:h, 0:w]
        r2 = ((xs - w / 2) / (w / 2)) ** 2 + ((ys - h / 2) / (h / 2)) ** 2
        self.vignette = torch.from_numpy(
            (1.0 - 0.35 * np.clip(r2 / 2.0, 0, 1)).astype(np.float32)).to(self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(noise_seed) % 2**63)

    def _cast(self, R_wc, C):
        """(B, h*w) intensities of the noiseless scene seen from (B, 3, 3)
        R_wc and (B, 3) centres. The geometry is float64, so no setting of
        float32 products (TF32) reaches the frames."""
        d_w = torch.einsum("pk,bjk->bpj", self.rays, R_wc)
        img = torch.full(d_w.shape[:2], 128.0, dtype=torch.float64, device=self.device)
        best = torch.full_like(img, float("inf"))
        for p0, n, u, v, hu, hv, tex in self.planes:
            dn = d_w @ n
            dn = torch.where(dn.abs() < 1e-12, torch.full_like(dn, 1e-12), dn)
            t = ((p0 - C) @ n)[:, None] / dn
            p = C[:, None, :] + d_w * t[..., None] - p0
            uu, vv = p @ u, p @ v
            hit = (t > 0.05) & (t < best) & (uu.abs() <= hu) & (vv.abs() <= hv + 1e-6)
            th, tw = tex.shape
            tx = (uu / hu * 0.5 + 0.5) * (tw - 1)
            ty = (vv / hv * 0.5 + 0.5) * (th - 1)
            x0 = torch.clamp(tx.to(torch.int64), 0, tw - 2)
            y0 = torch.clamp(ty.to(torch.int64), 0, th - 2)
            fx = torch.clamp(tx - x0, 0, 1)
            fy = torch.clamp(ty - y0, 0, 1)
            flat = tex.reshape(-1)
            i00 = y0 * tw + x0
            val = (flat[i00] * (1 - fx) * (1 - fy) + flat[i00 + 1] * fx * (1 - fy)
                   + flat[i00 + tw] * (1 - fx) * fy + flat[i00 + tw + 1] * fx * fy)
            img = torch.where(hit, val, img)
            best = torch.where(hit, t, best)
        return img

    def render(self, idx, eye_offsets=(0.0,), batch: int = 16) -> np.ndarray:
        """uint8 frames of the lap indices `idx`, (T, H, W) for one eye or
        (T, E, H, W) for several: each eye `offset` metres along the
        camera's x axis. The noise is drawn frame by frame, eye by eye, from
        the room's generator."""
        h, w = self.intr["height"], self.intr["width"]
        n_eye = len(eye_offsets)
        out = torch.empty((len(idx), n_eye, h, w), dtype=torch.uint8, device=self.device)
        for s in range(0, len(idx), batch):
            part = idx[s:s + batch]
            poses = [orbit_pose(i, self.lap) for i in part]
            R = torch.tensor(np.stack([p[0] for p in poses]), dtype=torch.float64,
                             device=self.device)
            photo = np.array([photometric(i, self.lap) for i in part], np.float32)
            expo = torch.from_numpy(photo[:, 0]).to(self.device)[:, None, None, None]
            gamma = torch.from_numpy(photo[:, 1]).to(self.device)[:, None, None, None]
            eyes = []
            for off in eye_offsets:
                C = np.stack([p[1] + p[0] @ np.array([off, 0.0, 0.0]) for p in poses])
                C = torch.tensor(C, dtype=torch.float64, device=self.device)
                eyes.append(self._cast(R, C).reshape(-1, h, w).float())
            img = torch.stack(eyes, 1)
            img = 255.0 * torch.clamp(img * self.vignette * expo / 255.0, 1e-6, 1.0) ** gamma
            noise = torch.randn(img.shape, generator=self.gen, device=self.device)
            out[s:s + len(part)] = torch.clamp(img + 2.0 * noise, 0, 255).to(torch.uint8)
        frames = out.cpu().numpy()
        return frames[:, 0] if n_eye == 1 else frames

    def render_lap(self, eye_offsets=(0.0,), batch: int = 16) -> np.ndarray:
        return self.render(list(range(self.lap)), eye_offsets, batch)


def box_depth(C, dirs) -> np.ndarray:
    """Ray parameter t of the first face hit from C along each (..., 3) world
    direction (the depth along a unit-z camera ray), float64; inf where no
    face is hit."""
    dirs = np.asarray(dirs, np.float64)
    best = np.full(dirs.shape[:-1], np.inf)
    for p0, n, u, v, hu, hv in box_planes():
        p0, n, u, v = (np.asarray(x, np.float64) for x in (p0, n, u, v))
        dn = dirs @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((p0 - C) @ n) / np.where(np.abs(dn) < 1e-12, 1e-12, dn)
        p = C + dirs * t[..., None] - p0
        hit = (t > 0.05) & (t < best) & (np.abs(p @ u) <= hu) & (np.abs(p @ v) <= hv + 1e-6)
        best = np.where(hit, t, best)
    return best
