"""Coordinate-frame conversions (port of lpslam_tpu/geometry/frames.py).

The engine works in the optical frame (x right, y down, z forward); the
public interface speaks the lpslam frame, where optical (x, y, z) is
lpslam (-y, x, z). Functions take torch tensors or numpy arrays and return
the same kind.
"""
from __future__ import annotations

import numpy as np
import torch

from .se3 import SE3

# rotation that maps lpslam coordinates to optical ones: v_opt = M @ v_lp
_M_LP_TO_OPT = ((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def _stack(parts, like):
    if isinstance(like, torch.Tensor):
        return torch.stack(parts, dim=-1)
    return np.stack(parts, axis=-1)


def lpslam_to_optical(v):
    """lpslam (x, y, z) -> optical (y, -x, z) over (..., 3)."""
    return _stack([v[..., 1], -v[..., 0], v[..., 2]], v)


def optical_to_lpslam(v):
    """optical (x, y, z) -> lpslam (-y, x, z) over (..., 3)."""
    return _stack([-v[..., 1], v[..., 0], v[..., 2]], v)


def _m(T: SE3):
    return torch.tensor(_M_LP_TO_OPT, dtype=T.R.dtype, device=T.R.device)


def se3_lpslam_to_optical(T: SE3) -> SE3:
    """Conjugate an SE3 expressed in the lpslam frame into the optical frame."""
    M = _m(T)
    return SE3(M @ T.R @ M.T, (M @ T.t[..., None])[..., 0])


def se3_optical_to_lpslam(T: SE3) -> SE3:
    M = _m(T)
    return SE3(M.T @ T.R @ M, (M.T @ T.t[..., None])[..., 0])
