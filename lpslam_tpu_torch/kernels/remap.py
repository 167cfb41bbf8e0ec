"""Bilinear remap (undistort) as a batched gather
(port of lpslam_tpu/kernels/remap.py)."""
from __future__ import annotations

import torch


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
