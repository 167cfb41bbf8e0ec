"""Run one cell of the benchmark (BENCHMARK.json at the repository root) on
the card this process is started on:

    python3 slam_bench/run.py --workload mono_vga.replay16 --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 breakdown, and last
the checks (each compared number beside its limit), which also end
standard error. Exits non-zero without a result when there is no card (or
fewer than the cell asks for), when the program is missing, or when JAX or
the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _plain(x):
    """JSON-safe: a number that is not finite becomes null."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from slam_bench import harness

    _, cell, _, _ = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    from slam_bench.cell import run_cell

    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    numbers = result.pop("numbers")
    marks = result.pop("marks")
    ms_per_frame = result.pop("ms_per_frame")
    print("seconds since start " + json.dumps({k: round(v, 3) for k, v in marks.items()}),
          file=sys.stderr)
    if ms_per_frame:
        print("host ms per frame " + json.dumps(ms_per_frame), file=sys.stderr)
    print("numbers " + json.dumps(_plain(numbers)), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
