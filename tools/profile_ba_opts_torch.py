"""Variants of the bundle_adjust hot pieces, through lpslam_tpu_torch on the
card: tools/profile_ba_opts.py's pieces.

    python3 tools/profile_ba_opts_torch.py [--out FILE]
    python3 tools/profile_ba_opts_torch.py --device cpu --C 2 --N 64 --Pn 128 --reps 2

Shapes C = 6, N = 1200, Pn = 4096, inputs from numpy's default_rng(0) in
the JAX tool's order. Pieces: `onehot_Hpp_and_Hcp` (the one-hot (C,N,P)
built and contracted into both Hpp and Hcp, as the JAX tool writes it;
`onehot_Hpp_and_Hcp_port` the port's bundle_adjust form, which builds the
one-hot once per solve and contracts it with two matmuls), `schur_matmul`
(S = (Hcp Hpp^-1) Hcp^T as one (6C, 3P) x (3P, 6C) product),
`solve36_gauss_jordan` (unpivoted Gauss-Jordan on the 36x36 system, one
eager step per row; `gj_max_err` its largest difference from
torch.linalg.solve) and `project_residuals`. Each gets `wall_ms` and
`device_ms` as tools/profile_ba_parts_torch.py gives them. TF32 stays off
(lpslam_tpu_torch sets matmul precision 'highest'), so every product is
float32. Prints one JSON object, the JAX tool's keys.
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
    x["JcTJp"] = rng.normal(0, 1, (C, N, 6, 3)).astype(np.float32)
    x["JpTJp"] = rng.normal(0, 1, (C, N, 3, 3)).astype(np.float32)
    x["obs_lm"] = rng.integers(0, Pn, (C, N)).astype(np.int32)
    x["Hcp0"] = rng.normal(0, 1, (C, Pn, 6, 3)).astype(np.float32)
    A = rng.normal(0, 1, (Pn, 3, 3)).astype(np.float32)
    x["Hpi"] = A @ A.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    S0 = rng.normal(0, 1, (36, 36)).astype(np.float32)
    x["S0"] = S0 @ S0.T + 36 * np.eye(36, dtype=np.float32)
    x["b0"] = rng.normal(0, 1, (36,)).astype(np.float32)
    x["t"] = rng.normal(0, 0.1, (C, 3)).astype(np.float32)
    x["pts"] = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-2, 2, Pn),
                         rng.uniform(3, 9, Pn)], -1).astype(np.float32)
    x["obs_uv"] = rng.normal(300, 80, (C, N, 2)).astype(np.float32)
    return x


def gj_solve(S, b):
    """Gauss-Jordan without pivoting on [S | b], one eager step per row."""
    n = S.shape[0]
    Ab = torch.cat([S, b[:, None]], dim=1)
    for k in range(n):
        piv = Ab[k] / Ab[k, k]
        fac = Ab[:, k].clone()
        fac[k] = 0.0
        Ab = Ab - fac[:, None] * piv[None, :]
        Ab[k] = piv
    return Ab[:, n]


def pieces(x: dict, device) -> dict:
    """name -> (label, zero-argument call) over the inputs on `device`."""
    from lpslam_tpu_torch.backend import ba
    from lpslam_tpu_torch.geometry import PinholeCamera

    T = {k: torch.from_numpy(v).to(device) for k, v in x.items()}
    C_, N_ = T["obs_lm"].shape
    P_ = T["Hpi"].shape[0]
    ar = torch.arange(P_, device=device, dtype=torch.int32)
    onehot = (T["obs_lm"][:, :, None] == ar).to(torch.float32)      # (C,N,P)
    onehot_flat_t = onehot.reshape(C_ * N_, P_).T
    onehot_t = onehot.transpose(1, 2)
    cam = PinholeCamera.make(FX, FX, CX, CY, device=device)
    R = torch.eye(3, device=device).expand(C_, 3, 3).contiguous()

    def onehot_builds():
        oh = (T["obs_lm"][:, :, None] == ar).to(torch.float32)
        Hpp = torch.einsum("cnp,cnij->pij", oh, T["JpTJp"])
        Hcp = torch.einsum("cnp,cnij->cpij", oh, T["JcTJp"])
        return Hpp, Hcp

    def onehot_port():
        Hpp = (onehot_flat_t @ T["JpTJp"].reshape(C_ * N_, 9)).reshape(P_, 3, 3)
        Hcp = (onehot_t @ T["JcTJp"].reshape(C_, N_, 18)).reshape(C_, P_, 6, 3)
        return Hpp, Hcp

    def schur_matmul():
        Tm = torch.einsum("apij,pjk->apik", T["Hcp0"], T["Hpi"])
        Tm = Tm.permute(0, 2, 1, 3).reshape(C_ * 6, P_ * 3)
        Hm = T["Hcp0"].permute(0, 2, 1, 3).reshape(C_ * 6, P_ * 3)
        return Tm @ Hm.T

    return {
        "onehot_Hpp_and_Hcp": ("jax_literal (one-hot built on every call)", onehot_builds),
        "onehot_Hpp_and_Hcp_port": ("port (one-hot built once per solve, two matmuls)",
                                    onehot_port),
        "schur_matmul": ("jax_literal; the port's form", schur_matmul),
        "solve36_gauss_jordan": ("jax_literal (36 eager steps)",
                                 lambda: gj_solve(T["S0"], T["b0"])),
        "project_residuals": ("port (backend/ba.py::_project_residuals)",
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
    x = inputs(args.C, args.N, args.Pn)
    out = {}
    for name, (label, fn) in pieces(x, device).items():
        out[name] = {"label": label, **bp.time_piece(fn, args.reps, device)}
        print(name, out[name], file=sys.stderr, flush=True)
    S0 = torch.from_numpy(x["S0"]).to(device)
    b0 = torch.from_numpy(x["b0"]).to(device)
    out["gj_max_err"] = float((gj_solve(S0, b0) - torch.linalg.solve(S0, b0)).abs().max())
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
