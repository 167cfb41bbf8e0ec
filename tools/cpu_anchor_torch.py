"""The port's CPU anchor: tools/cpu_anchor.py's run through lpslam_tpu_torch
on the host CPU (device "cpu", asked for explicitly; measuring the CPU is
this tool's purpose).

    python3 tools/cpu_anchor_torch.py [--out FILE]
    python3 tools/cpu_anchor_torch.py --frames 16 --width 160 --height 120 \\
        --keypoints 256 --chunk 8

At the bench operating point (lpslam_tpu_torch/eval/bench_point.py: 640x480 room, 1200
keypoints, 3 levels, MapConfig(128, 24576, 1200), the whole chunk loop with
local BA and the boundary's compaction): 16 init frames, one chunk of
warm-up, then --frames = 48 measured frames in chunks of 16. Prints one
JSON object with the JAX tool's keys (tracked frames/s as `value`,
`os.cpu_count()` as `host_cpus`), plus the CPU model from /proc/cpuinfo and
torch's intra-op thread count.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from lpslam_tpu_torch.eval import bench_point as bp  # noqa: E402


def measure(args) -> dict:
    device = bp.open_device("cpu")
    chunk, n_meas = args.chunk, args.frames
    total = bp.N_INIT + 2 * chunk + n_meas + chunk
    point = bp.BenchPoint(args, total, device)
    frames = point.frames
    ct, t = point.chunked()
    ct.process_chunk(frames[t:t + chunk])
    t += chunk
    ct.sync()

    t0 = time.perf_counter()
    done = 0
    while done < n_meas:
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
        done += chunk
    ct.sync()
    wall = time.perf_counter() - t0
    return {
        "metric": "cpu_anchor_tracked_fps",
        "value": done / wall,
        "unit": "frames/s",
        "host_cpus": os.cpu_count(),
        "cpu_model": bp.cpu_model(),
        "torch_threads": torch.get_num_threads(),
        "torch": torch.__version__,
        "frames": done,
        "keypoints": args.keypoints,
        "size": [args.height, args.width],
        "wall_s": wall,
        "note": ("the port, same operating point, on the host CPU through "
                 "PyTorch's CPU kernels (the hand kernels' plain versions)"),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    bp.add_point_args(p, frames=48, device=False)
    p.add_argument("--out", default="", help="also write the JSON line to this file")
    args = p.parse_args(argv)
    out = measure(args)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
