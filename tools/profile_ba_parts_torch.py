"""The pieces of one bundle_adjust LM iteration at the local-BA shape,
through lpslam_tpu_torch on the card: tools/profile_ba_parts.py's pieces.

    python3 tools/profile_ba_parts_torch.py [--out FILE]
    python3 tools/profile_ba_parts_torch.py --device cpu --C 2 --N 64 --Pn 128 --reps 2

Shapes C = 6 cameras, N = 1200 observations per camera, Pn = 4096 points;
inputs drawn from numpy's default_rng(0) in the JAX tool's order. Each piece
gets two times (lpslam_tpu_torch/eval/bench_point.py::time_piece): `wall_ms`, the
eager wall per call with REPS = 50 calls between two synchronizations (what
a frame pays today), and `device_ms`, the REPS calls captured in one CUDA
graph and replayed between CUDA events, or the profiler's kernel sum where
a call waits for the host (`device_how`). Their ratio, `wall_over_device`,
is the launch overhead. Every piece is labelled: `jax_literal` is the JAX
tool's op written in torch; `port` is what lpslam_tpu_torch/backend/ba.py
computes for that step, where it differs (its float sums go through
kernels/linalg.py::segment_sum with a plan built once per solve, its 3x3
inverse is inv3x3_guarded, its dense Hcp and Schur product are matmuls over
a one-hot built once per solve). Prints one JSON object, the JAX tool's
piece names as keys.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lpslam_tpu_torch.eval import bench_point as bp  # noqa: E402

C, N, Pn, REPS = 6, 1200, 4096, 50
FX, CX, CY = 460.0, 320.0, 240.0


def inputs(C: int, N: int, Pn: int, seed: int = 0) -> dict:
    """The JAX tool's inputs, drawn in its order, as numpy."""
    rng = np.random.default_rng(seed)
    x = {}
    A = rng.normal(0, 1, (Pn, 3, 3)).astype(np.float32)
    x["A"] = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    S = rng.normal(0, 1, (36, 36)).astype(np.float32)
    x["S"] = S @ S.T + 36 * np.eye(36, dtype=np.float32)
    x["b"] = rng.normal(0, 1, (36,)).astype(np.float32)
    x["JcTJp"] = rng.normal(0, 1, (C, N, 6, 3)).astype(np.float32)
    x["flat_lm"] = rng.integers(0, Pn, C * N).astype(np.int32)
    x["Hcp0"] = rng.normal(0, 1, (C, Pn, 6, 3)).astype(np.float32)
    x["JpTJp"] = rng.normal(0, 1, (C * N, 3, 3)).astype(np.float32)
    x["t"] = rng.normal(0, 0.1, (C, 3)).astype(np.float32)
    x["pts"] = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-2, 2, Pn),
                         rng.uniform(3, 9, Pn)], -1).astype(np.float32)
    x["obs_lm"] = rng.integers(0, Pn, (C, N)).astype(np.int32)
    x["obs_uv"] = rng.normal(300, 80, (C, N, 2)).astype(np.float32)
    return x


def inv_adjugate(M):
    """The JAX tool's closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
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
    inv = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], 1)
    return inv / det[:, None, None]


def pieces(x: dict, device) -> dict:
    """name -> (label, zero-argument call) over the inputs on `device`."""
    from lpslam_tpu_torch.backend import ba
    from lpslam_tpu_torch.geometry import PinholeCamera
    from lpslam_tpu_torch.kernels.linalg import inv3x3_guarded, segment_plan, segment_sum

    T = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    C_, N_ = T["obs_lm"].shape
    P_ = T["A"].shape[0]
    A, S, b = T["A"], T["S"], T["b"]
    lm64 = T["flat_lm"].to(torch.int64)
    cam_rows = torch.arange(C_, device=device).repeat_interleave(N_)
    # the port's one-hot of bundle_adjust, built once per solve
    onehot_t = (T["flat_lm"].reshape(C_, N_)[:, :, None]
                == torch.arange(P_, device=device, dtype=torch.int32)
                ).to(torch.float32).transpose(1, 2)                 # (C,P,N)
    plan = segment_plan(T["flat_lm"], P_)
    Hpi = inv_adjugate(A)
    Hcp0 = T["Hcp0"]
    cam = PinholeCamera.make(FX, FX, CX, CY, device=device)
    R = torch.eye(3, device=device).expand(C_, 3, 3).contiguous()

    def chol():
        L = torch.linalg.cholesky(S)
        y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

    def scatter():
        H = torch.zeros((C_, P_, 6, 3), device=device)
        return H.index_put_((cam_rows, lm64), T["JcTJp"].reshape(-1, 6, 3), accumulate=True)

    def schur_port():
        X = torch.einsum("apij,pjk->apik", Hcp0, Hpi)
        Xr = X.permute(0, 2, 1, 3).reshape(6 * C_, 3 * P_)
        Hr = Hcp0.permute(0, 2, 1, 3).reshape(6 * C_, 3 * P_)
        return (Xr @ Hr.T).reshape(C_, 6, C_, 6)

    def seg_literal():
        return torch.zeros((P_, 3, 3), device=device).index_add_(0, lm64, T["JpTJp"])

    return {
        "inv3x3_lu": ("jax_literal", lambda: torch.linalg.inv(A)),
        "inv3x3_adjugate": ("jax_literal", lambda: inv_adjugate(A)),
        "inv3x3_guarded": ("port", lambda: inv3x3_guarded(A, tol=ba._BA_GUARD_TOL)),
        "solve36_lu": ("jax_literal; the port's dense solve (torch.linalg.solve)",
                       lambda: torch.linalg.solve(S, b)),
        "solve36_chol": ("jax_literal", chol),
        "coupling_scatter": ("jax_literal (index_put_ with accumulate: float atomics)",
                             scatter),
        "coupling_onehot": ("port (Hcp as one-hot (C,P,N) @ (C,N,18))",
                            lambda: (onehot_t @ T["JcTJp"].reshape(C_, N_, 18)
                                     ).reshape(C_, P_, 6, 3)),
        "schur_einsum": ("jax_literal", lambda: torch.einsum(
            "apij,pjk,bplk->aibl", Hcp0, Hpi, Hcp0)),
        "schur_matmul": ("port", schur_port),
        "segment_sum": ("jax_literal (index_add_: float atomics on the card)", seg_literal),
        "segment_sum_plan": ("port (kernels/linalg.py::segment_sum, plan built once per "
                             "solve)", lambda: segment_sum(T["JpTJp"], plan)),
        "segment_plan": ("port (the plan: one sort and one host read, once per solve)",
                         lambda: segment_plan(T["flat_lm"], P_)),
        "project_residuals": ("port (backend/ba.py::_project_residuals, the JAX math)",
                              lambda: ba._project_residuals(cam, R, T["t"], T["pts"],
                                                            T["obs_lm"], T["obs_uv"])),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--C", type=int, default=C)
    p.add_argument("--N", type=int, default=N)
    p.add_argument("--Pn", type=int, default=Pn)
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--out", default="", help="also write the JSON line to this file")
    args = p.parse_args(argv)
    device = bp.open_device(args.device)
    out = {}
    for name, (label, fn) in pieces(inputs(args.C, args.N, args.Pn), device).items():
        out[name] = {"label": label, **bp.time_piece(fn, args.reps, device)}
        print(name, out[name], file=sys.stderr, flush=True)
    out.update(device=str(device), hardware=bp.hardware(device),
               shapes={"C": args.C, "N": args.N, "Pn": args.Pn}, reps=args.reps,
               precision=bp.precision())
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
