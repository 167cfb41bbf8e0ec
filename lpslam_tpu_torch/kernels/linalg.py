"""Closed-form small linear algebra (port of lpslam_tpu/kernels/linalg.py):
batched adjugate 3x3 inverse, a guarded variant for BA point blocks, and
6x6 SPD inverse/solve via 3x3 block Schur; and the sorted segment sum that
the solvers' normal equations take their landmark and node blocks from."""
from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
    """Rows grouped by segment: ``order`` the kept rows by segment id, in
    source order within a segment (a stable sort); ``offsets`` (n + 1,)
    where each segment's run starts in ``order``, and where the last one
    ends (its length)."""

    order: torch.Tensor
    offsets: torch.Tensor


def segment_plan(idx, n: int) -> SegmentPlan:
    """The plan of ``segment_sum`` for segment ids ``idx`` (M,); a row whose
    id lies outside [0, n) (a solver's empty slot, -1) is left out of every
    segment. One sort and one read of the kept rows' count on the host; a
    solve computes it once, outside its iterations, since its segment ids
    stay fixed while the values change."""
    idx = idx.reshape(-1).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    sorted_idx, order = torch.sort(idx, stable=True)
    offsets = torch.searchsorted(sorted_idx, torch.arange(n + 1, device=idx.device))
    return SegmentPlan(order[:int(offsets[-1])], offsets)


def segment_sum(vals, plan: SegmentPlan):
    """(M, ...) rows summed by segment into (n, ...): each segment's rows
    gathered in ``plan``'s order and added one after another from 0. That
    is the order of ``index_add_`` on the CPU, so the sums are bit-equal
    to it there; on the card ``index_add_``'s float atomics add in an order
    that changes from run to run, and this does not (torch.segment_reduce
    reduces each segment in a fixed order, one thread per output element
    for rows of more than one element). Leaving the empty slots out keeps
    every segment short: a solver's padding, summed into landmark 0 as the
    ``index_add_`` of a clamped id did, would be one thread's loop over
    most of the slots. ``unsafe=True`` only skips segment_reduce's check
    of the offsets, a host read on every call: the plan's rows are exactly
    the ones its offsets cover. Rows of one element (1-D ``vals``) go
    through a segmented tree reduction on the card, whose order is not the
    CPU's; the solvers sum only blocks of (3,), (3, 3) and (7, 7)."""
    return torch.segment_reduce(vals.index_select(0, plan.order), "sum",
                                offsets=plan.offsets, axis=0, unsafe=True)


def inv3x3(M, eps: float = 0.0):
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    det = torch.where(
        torch.abs(det) > eps,
        det,
        torch.where(det >= 0, 1.0, -1.0) * torch.clamp(torch.abs(det), min=1e-20),
    )
    inv = torch.stack([
        torch.stack([A00, A01, A02], -1),
        torch.stack([A10, A11, A12], -1),
        torch.stack([A20, A21, A22], -1),
    ], -2)
    return inv / det[..., None, None]


def inv3x3_guarded(M, tol: float = 1e12):
    """Adjugate inverse that returns ZERO for catastrophic blocks: non-finite,
    residual |M inv - I| beyond `tol`, or a non-positive diagonal (see the
    JAX package's docstring for why the gate is this permissive)."""
    inv = inv3x3(M)
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    resid = torch.amax(torch.abs(M @ inv - eye), dim=(-2, -1), keepdim=True)
    diag_ok = torch.all(
        torch.diagonal(inv, dim1=-2, dim2=-1) > 0.0, dim=-1
    )[..., None, None]
    ok = torch.isfinite(resid) & (resid <= tol) & diag_ok
    ok = ok & torch.all(torch.isfinite(inv).flatten(-2), dim=-1)[..., None, None]
    return torch.where(ok, inv, 0.0)


def inv6x6_spd(M):
    """Inverse of batched (..., 6, 6) SPD matrices via 3x3 block Schur."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    Ct = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3x3(A)
    Si = inv3x3(D - Ct @ Ai @ B)
    AiB = Ai @ B
    CtAi = Ct @ Ai
    top = torch.cat([Ai + AiB @ Si @ CtAi, -AiB @ Si], dim=-1)
    bot = torch.cat([-Si @ CtAi, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def solve_spd_6x6(H, b):
    """Solve H x = b for one symmetric positive-definite 6x6 H."""
    A = H[:3, :3]
    B = H[:3, 3:]
    D = H[3:, 3:]
    b1, b2 = b[:3], b[3:]
    Ai = inv3x3(A)
    Si = inv3x3(D - B.T @ (Ai @ B))
    x2 = Si @ (b2 - B.T @ (Ai @ b1))
    x1 = Ai @ (b1 - B @ x2)
    return torch.cat([x1, x2])
