"""Corner-rich synthetic texture, numpy only (a copy of
lpslam_tpu/io/synthetic.py:make_texture, which the port cannot import)."""
from __future__ import annotations

import numpy as np


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
