"""SE(3) rigid transforms, batched (port of lpslam_tpu/geometry/se3.py).

World->cam ("Tcw") convention: x_cam = R @ x_world + t.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .so3 import so3_exp, so3_log, so3_left_jacobian, so3_left_jacobian_inv


class SE3(NamedTuple):
    """Batched rigid transform: R (...,3,3), t (...,3)."""

    R: torch.Tensor
    t: torch.Tensor

    @property
    def batch_shape(self):
        return self.R.shape[:-2]


def se3_identity(device, batch_shape=(), dtype=torch.float32) -> SE3:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return SE3(R, t)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def se3_compose(a: SE3, b: SE3) -> SE3:
    """a ∘ b: apply b first, then a."""
    return SE3(a.R @ b.R, _mv(a.R, b.t) + a.t)


def se3_inverse(T: SE3) -> SE3:
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -_mv(Rt, T.t))


def se3_apply(T: SE3, p):
    """Transform points p (...,3) by T."""
    return _mv(T.R, p) + T.t


def se3_exp(xi) -> SE3:
    """Exp map: twist (...,6) [rho, phi] (translation, rotation) -> SE3."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return SE3(so3_exp(phi), _mv(so3_left_jacobian(phi), rho))


def se3_log(T: SE3):
    """Log map: SE3 -> twist (...,6) [rho, phi]."""
    phi = so3_log(T.R)
    rho = _mv(so3_left_jacobian_inv(phi), T.t)
    return torch.cat([rho, phi], dim=-1)
