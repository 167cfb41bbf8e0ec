"""Readings behind the limits of `correct`: one cell over many seeds in one
process, the program as the configuration states it or, with --control
tf32, with TF32 switched on for its float32 products (the control, one
precision below the configuration's). Prints one JSON line per seed (every
compared number, the cell's metrics, correct) and writes them to --out.

    python3 slam_bench/calibrate.py --workload mono_vga.replay16 --seeds 1,2,3 --seconds 30
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", choices=("none", "tf32"), default="none")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import lpslam_tpu_torch  # noqa: F401  (sets TF32 off; the control turns it on after)
    from slam_bench.cell import run_cell

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter() if lines else T0
        r = run_cell(ROOT, args.workload, seed, args.seconds, bool(args.trace), t0)
        line = {"workload": args.workload, "seed": seed, "control": args.control,
                "correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"],
                "numbers": r["numbers"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "device": r["device"], "breakdown": r.get("breakdown"), "marks": r["marks"], "ms_per_frame": r["ms_per_frame"]}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
