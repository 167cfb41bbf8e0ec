"""Pose-only optimization (port of lpslam_tpu/frontend/pose_opt.py): a
fixed-iteration Gauss-Newton solve with an annealed chi2 gate and Huber
weights; the JAX ``lax.scan`` over the annealing schedule is a loop here.

On the card the solve is some 1,200-1,700 small kernels a call, each
launched from the host. So ``pose_only_optimize`` captures the eager body
once per input signature as a CUDA graph and replays it: the same kernels
with the same launch configurations in the same order, so the result is
bit-equal to the eager body's on contiguous inputs. On the CPU it runs the
eager body."""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera, project_pinhole
from ..geometry.se3 import SE3, se3_compose, se3_exp
from ..geometry.so3 import hat
from ..kernels.linalg import inv6x6_spd, solve_spd_6x6
from ..utils import timing

CHI2_2D = 5.991


class PoseOptResult(NamedTuple):
    pose: SE3
    inlier: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor  # () int32
    final_cost: torch.Tensor
    sigma_pos: torch.Tensor = None  # (3,) world-frame camera-centre std-dev
    sigma_rot: torch.Tensor = None  # () rotation std-dev [rad]


def _residuals_jac(pose: SE3, cam: PinholeCamera, p_w, uv):
    p_c = p_w @ pose.R.T + pose.t
    z = torch.clamp(p_c[:, 2], min=1e-6)
    r = project_pinhole(cam, p_c) - uv
    x, y = p_c[:, 0], p_c[:, 1]
    zinv = 1.0 / z
    zinv2 = zinv * zinv
    zero = torch.zeros_like(z)
    Jproj = torch.stack(
        [
            torch.stack([cam.fx * zinv, zero, -cam.fx * x * zinv2], -1),
            torch.stack([zero, cam.fy * zinv, -cam.fy * y * zinv2], -1),
        ],
        dim=-2,
    )  # (N, 2, 3)
    eye = torch.eye(3, dtype=p_w.dtype, device=p_w.device).expand(p_w.shape[0], 3, 3)
    Jse3 = torch.cat([eye, -hat(p_c)], dim=-1)  # (N, 3, 6)
    return r, Jproj @ Jse3, p_c[:, 2] <= 0.05


def pose_only_optimize(pose0: SE3, cam: PinholeCamera, p_w, uv, valid,
                       sigma2=None, iters: int = 10,
                       damping: float = 1e-3) -> PoseOptResult:
    """Optimize Tcw given N landmark positions p_w observed at pixels uv.

    On a CUDA device the solve replays a CUDA graph of the eager body
    captured at the first call of its signature (``_graphed``); on the CPU
    the eager body runs."""
    with timing.span("pose_only_optimize"):
        args = (pose0, cam, p_w, uv, valid, sigma2, iters, damping)
        if p_w.is_cuda:
            return _graphed(*args)
        return _pose_only_optimize_eager(*args)


def _pose_only_optimize_eager(pose0: SE3, cam: PinholeCamera, p_w, uv, valid,
                              sigma2=None, iters: int = 10,
                              damping: float = 1e-3) -> PoseOptResult:
    """The solve itself, one kernel launch per operation."""
    n = p_w.shape[0]
    dev = p_w.device
    if sigma2 is None:
        sigma2 = torch.ones((n,), dtype=p_w.dtype, device=dev)
    anneal = torch.cat([
        torch.logspace(3.0, 0.0, max(iters - 3, 1), dtype=torch.float32, device=dev),
        torch.ones((min(3, iters),), dtype=torch.float32, device=dev),
    ])[:iters]
    eye6 = torch.eye(6, dtype=p_w.dtype, device=dev)
    delta = CHI2_2D ** 0.5

    pose = pose0
    for it in range(iters):
        r, J, behind = _residuals_jac(pose, cam, p_w, uv)
        chi2 = torch.sum(r * r, dim=-1) / sigma2
        ok = valid & ~behind & (chi2 <= CHI2_2D * anneal[it])
        rn = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w = torch.where(rn <= delta, 1.0, delta / rn) / sigma2
        w = torch.where(ok, w, 0.0)
        Jw = J * w[:, None, None]
        H = torch.einsum("nik,nil->kl", Jw, J) + damping * eye6
        b = torch.einsum("nik,ni->k", Jw, r)
        pose = se3_compose(se3_exp(-solve_spd_6x6(H, b)), pose)

    r, J, behind = _residuals_jac(pose, cam, p_w, uv)
    chi2 = torch.sum(r * r, dim=-1) / sigma2
    inlier = valid & ~behind & (chi2 <= CHI2_2D)
    n_in = torch.sum(inlier).to(torch.int32)
    cost = torch.sum(torch.where(inlier, chi2, 0.0))

    # pose covariance s^2 (J^T W J)^-1 at the final inliers
    w_in = torch.where(inlier, 1.0 / sigma2, 0.0)
    H = torch.einsum("nik,nil->kl", J * w_in[:, None, None], J) + 1e-6 * eye6
    s2 = cost / torch.clamp(2.0 * n_in.to(r.dtype) - 6.0, min=1.0)
    Cov = inv6x6_spd(H) * torch.clamp(s2, min=1e-12)
    C_tt = pose.R.T @ Cov[:3, :3] @ pose.R
    sigma_pos = torch.sqrt(torch.clamp(torch.diagonal(C_tt), min=0.0))
    sigma_rot = torch.sqrt(torch.clamp(torch.trace(Cov[3:, 3:]) / 3.0, min=0.0))
    bad = n_in < 6
    return PoseOptResult(
        pose=pose,
        inlier=inlier,
        n_inliers=n_in,
        final_cost=cost,
        sigma_pos=torch.where(bad, 0.0, sigma_pos),
        sigma_rot=torch.where(bad, 0.0, sigma_rot),
    )


# Captured solves by input signature: (graph, static inputs, static outputs).
# A replay reads only the static inputs (contiguous, on the graph's device),
# into which each call copies its own tensors, whatever their strides, so no
# caller's tensor is baked into a graph; the next replay overwrites the static
# outputs, so a call hands out copies of them. The lock keeps one call's
# copy-in, replay and copy-out together.
_GRAPHS: dict = {}
_GRAPHS_LOCK = threading.Lock()


def _tensors(pose0, cam, p_w, uv, valid, sigma2, *_):
    """Every tensor the eager body reads, in a fixed order."""
    return (pose0.R, pose0.t, *cam, p_w, uv, valid) + (() if sigma2 is None else (sigma2,))


def _graphed(pose0, cam, p_w, uv, valid, sigma2, iters, damping) -> PoseOptResult:
    """The eager body's result through the CUDA graph of its signature,
    captured at the signature's first call."""
    inputs = _tensors(pose0, cam, p_w, uv, valid, sigma2)
    # iters and damping shape the graph; a captured product keeps the math
    # mode (TF32 or not) it was captured under
    key = (iters, damping, p_w.device, torch.backends.cuda.matmul.allow_tf32,
           tuple((x.shape, x.dtype) for x in inputs))
    with _GRAPHS_LOCK:
        entry = _GRAPHS.get(key)
        if entry is None:
            with timing.span("pose_opt_graph_capture"):
                entry = _GRAPHS[key] = _capture(inputs, iters, damping)
        graph, static, out = entry
        with timing.span("pose_opt_graph_replay"):
            for dst, src in zip(static, inputs):
                dst.copy_(src)
            graph.replay()
            return PoseOptResult(SE3(out.pose.R.clone(), out.pose.t.clone()),
                                 *(x.clone() for x in out[1:]))


def _capture(inputs, iters: int, damping: float):
    """Warm the eager body up on a side stream, then capture it into a CUDA
    graph that reads contiguous copies of ``inputs`` on p_w's device."""
    dev = inputs[6].device
    static = tuple(x.to(dev, copy=True, memory_format=torch.contiguous_format)
                   for x in inputs)
    R, t, fx, fy, cx, cy, p_w, uv, valid, *sigma2 = static
    args = (SE3(R, t), PinholeCamera(fx, fy, cx, cy), p_w, uv, valid,
            sigma2[0] if sigma2 else None, iters, damping)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _pose_only_optimize_eager(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: a loop worker's CUDA work on another thread may run
    # during the capture without invalidating it
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = _pose_only_optimize_eager(*args)
    return graph, static, out
