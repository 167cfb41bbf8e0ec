"""Image pyramid + Gaussian smoothing (port of lpslam_tpu/kernels/pyramid.py).

Images are float32 in [0, 255], shaped (B, H, W); (H, W) is accepted too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, num_levels: int, scale_factor: float):
    """Per-level (h, w) as python ints."""
    shapes = []
    for lvl in range(num_levels):
        s = scale_factor**lvl
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def gaussian_kernel1d(sigma: float, radius: int, device=None):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(img, sigma: float = 2.0, radius: int = 3):
    """Separable Gaussian blur with edge-replicate padding: rows first, then
    columns, each a shift-and-add over the 2r+1 taps in the JAX order."""
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    k = gaussian_kernel1d(sigma, radius, device=x.device)
    h, w = x.shape[-2:]
    xpad = F.pad(x[:, None], (0, 0, radius, radius), mode="replicate")[:, 0]
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + k[i] * xpad[:, i:i + h, :]
    ypad = F.pad(out[:, None], (radius, radius, 0, 0), mode="replicate")[:, 0]
    out = torch.zeros_like(x)
    for i in range(2 * radius + 1):
        out = out + k[i] * ypad[:, :, i:i + w]
    return out[0] if squeeze else out


def build_pyramid(img, num_levels: int = 3, scale_factor: float = 1.2):
    """(B, H, W) or (H, W) float32 -> tuple of per-level images.

    Each level is an antialiased bilinear resize of the previous one, as
    ``jax.image.resize(method="linear")`` does when it shrinks."""
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    h, w = x.shape[-2:]
    shapes = pyramid_shapes(h, w, num_levels, scale_factor)
    levels = [x]
    for lvl in range(1, num_levels):
        levels.append(
            F.interpolate(
                levels[-1][:, None], size=shapes[lvl], mode="bilinear",
                align_corners=False, antialias=True,
            )[:, 0]
        )
    return tuple(lv[0] for lv in levels) if squeeze else tuple(levels)
