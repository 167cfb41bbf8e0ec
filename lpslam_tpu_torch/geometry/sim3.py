"""Sim(3) similarity transforms, batched (port of lpslam_tpu/geometry/sim3.py).

Representation: (R (...,3,3), t (...,3), s (...)) with action
x' = s * R @ x + t. Tangent ordering: [rho(3), phi(3), sigma(1)].

The pose graph differentiates ``sim3_exp`` / ``sim3_log`` in forward mode
exactly at zero, so every small-angle and small-scale branch keeps the JAX
code's safe forms: the branch that is not taken is still finite there, and
the selecting ``torch.where`` sees finite values and tangents on both sides.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .so3 import hat, so3_exp, so3_log

_EPS = 1e-7


class Sim3(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def sim3_identity(device, batch_shape=(), dtype=torch.float32) -> Sim3:
    return Sim3(
        torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone(),
        torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
        torch.ones(batch_shape, dtype=dtype, device=device),
    )


def sim3_apply(S: Sim3, p):
    return S.s[..., None] * _mv(S.R, p) + S.t


def sim3_compose(a: Sim3, b: Sim3) -> Sim3:
    return Sim3(a.R @ b.R, a.s[..., None] * _mv(a.R, b.t) + a.t, a.s * b.s)


def sim3_inverse(S: Sim3) -> Sim3:
    Rt = S.R.transpose(-1, -2)
    sinv = 1.0 / S.s
    return Sim3(Rt, -sinv[..., None] * _mv(Rt, S.t), sinv)


def _W_matrix(phi, sigma):
    """The Sim(3) 'W' matrix coupling rho to translation: t = W @ rho,
    W = A*I + B*hat(phi) + C*hat(phi)^2 (see the JAX docstring for A, B, C
    and their series limits at sigma -> 0 and theta -> 0)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    es = torch.exp(sigma)
    sig2 = sigma * sigma
    sig3 = sig2 * sigma

    small_sig = torch.abs(sigma) < 1e-3
    small_th = theta < 1e-3
    one = torch.ones_like(sigma)
    safe_sig = torch.where(small_sig, one, sigma)
    safe_sig2 = torch.where(small_sig, one, sig2)
    safe_sig3 = torch.where(small_sig, one, sig3)

    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0, (es - 1.0) / safe_sig)

    denom = torch.clamp(sig2 + theta2, min=_EPS)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    B_gen = (es * sin_t * sigma + (1.0 - es * cos_t) * theta) / (theta * denom)
    B_lim = torch.where(small_sig, 0.5 + sigma / 3.0, (sigma * es - es + 1.0) / safe_sig2)
    B = torch.where(small_th, B_lim, B_gen)

    C_gen = (A - ((es * cos_t - 1.0) * sigma + es * sin_t * theta) / denom) / torch.clamp(
        theta2, min=_EPS
    )
    C_lim = torch.where(
        small_sig,
        1.0 / 6.0 + sigma / 8.0,
        (es - 1.0 - sigma * es + 0.5 * sig2 * es) / safe_sig3,
    )
    C = torch.where(small_th, C_lim, C_gen)

    H = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(*phi.shape[:-1], 3, 3)
    return A[..., None, None] * eye + B[..., None, None] * H + C[..., None, None] * (H @ H)


def sim3_exp(xi) -> Sim3:
    """Exp map: (...,7) [rho, phi, sigma] -> Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return Sim3(so3_exp(phi), _mv(_W_matrix(phi, sigma), rho), torch.exp(sigma))


def sim3_log(S: Sim3):
    """Log map: Sim3 -> (...,7); W is solved linearly, as in the JAX code."""
    phi = so3_log(S.R)
    sigma = torch.log(S.s)
    rho = torch.linalg.solve(_W_matrix(phi, sigma), S.t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
