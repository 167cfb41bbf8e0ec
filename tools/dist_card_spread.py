"""How far the port's bundle adjustments move with the order of their sums:
the evidence behind the tolerances of tests/test_torch_cuda.py's
distributed_bundle_adjust case and of chip_smoke.py phase 15c.

    python3 tools/dist_card_spread.py                  # on the card
    python3 tools/dist_card_spread.py --device cpu     # the CPU columns only

BA: eval/scaling.py's problem at 16 cameras x 512 landmarks x 64
slots and at 8 x 256 x 256, seeds 0-4, solved by backend.ba's
bundle_adjust (one device, dense Schur) and by dist's
distributed_bundle_adjust (default mesh), each in float32 on --device and
on the CPU, and in float64 on the CPU. For each solver it prints the max
|cam_t| difference and the relative final-cost difference of --device
against the CPU (two summation orders) and of float32 against float64 on
the CPU (how far fp32 rounding alone moves the solution).

The room map's spread (phase 7's map solved in worlds of 1 and 2, as phase
15c does) is measured by tools/card_map_repeat.py.

The last line of its output is one JSON object with every reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

BA_SIZES = ((16, 512, 64), (8, 256, 256))
BA_ITERS = 8       # tests/test_torch_cuda.py's case
SEEDS = (0, 1, 2, 3, 4)


def _solve(kind, C, P, N, seed, device, dtype):
    from lpslam_tpu_torch.backend.ba import bundle_adjust
    from lpslam_tpu_torch.dist import distributed_bundle_adjust
    from lpslam_tpu_torch.eval.scaling import build_problem
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    prob = build_problem(C, P, N, seed=seed, device=device)
    prob = prob._replace(**{k: v.to(dtype) for k, v in prob._asdict().items()
                            if v is not None and v.is_floating_point()})
    cam = PinholeCamera.make(460.0, 460.0, 376.0, 240.0, device, dtype)
    fn = bundle_adjust if kind == "single" else distributed_bundle_adjust
    res = fn(prob, cam, iters=BA_ITERS)
    return res.cam_t.double().cpu().numpy(), float(res.final_cost), float(res.initial_cost)


def _diff(a, b) -> dict:
    return {"cam_t_max_diff": float(np.abs(a[0] - b[0]).max()),
            "final_cost_rel_diff": abs(a[1] - b[1]) / abs(b[1])}


def ba_spread(seeds, device) -> list:
    rows = []
    for C, P, N in BA_SIZES:
        for seed in seeds:
            for kind in ("single", "dist"):
                cpu32 = _solve(kind, C, P, N, seed, "cpu", torch.float32)
                cpu64 = _solve(kind, C, P, N, seed, "cpu", torch.float64)
                row = {"size": [C, P, N], "seed": seed, "solver": kind,
                       "initial_cost": cpu32[2], "final_cost_cpu": cpu32[1],
                       "cpu_fp32_vs_fp64": _diff(cpu32, cpu64)}
                if device.type != "cpu":
                    row["device_vs_cpu"] = _diff(_solve(kind, C, P, N, seed, device,
                                                        torch.float32), cpu32)
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("dist_card_spread: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    out = {"ba": ba_spread(SEEDS, device)}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
