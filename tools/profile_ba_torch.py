"""The windowed local BA of the port at the bench point's map shapes, and
the chunk loop with no BA: tools/profile_ba.py through lpslam_tpu_torch on
the card.

    python3 tools/profile_ba_torch.py [--out FILE]
    python3 tools/profile_ba_torch.py --device cpu --frames 16 --width 160 \\
        --height 120 --keypoints 256 --chunk 8

At the bench operating point (lpslam_tpu_torch/eval/bench_point.py; MapConfig(128,
24576, 1200)): after 16 init frames, two warm-up chunks and --frames = 128
measured frames through ChunkedTracker(local_ba_every_chunk=False) with
`boundary_compact = False` (the scan with no BA at all, frames staged
beforehand); then `local_ba` on the resulting map at (window, iters) =
(6, 8), (6, 4), (6, 2), (4, 8), (6, 1), covisibility on: one warm call, then
5 timed calls, each synchronized. Prints one JSON object with the JAX
tool's keys (unrounded), plus the map's size and what the numbers were
taken on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lpslam_tpu_torch.eval import bench_point as bp  # noqa: E402

SHAPES = ((6, 8), (6, 4), (6, 2), (4, 8), (6, 1))
TIMED = 5


def measure(args) -> dict:
    from lpslam_tpu_torch.backend.ba import local_ba

    device = bp.open_device(args.device)
    sync = bp.synchronizer(device)
    chunk = args.chunk
    total = bp.N_INIT + 2 * chunk + args.frames
    point = bp.BenchPoint(args, total, device)
    frames = point.frames
    out = {}

    ct, t = point.chunked(local_ba_every_chunk=False)
    ct.boundary_compact = False
    for _ in range(2):
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
    ct.sync()
    staged = []
    while t + chunk <= len(frames):
        staged.append(ct.prefetch(frames[t:t + chunk]))
        t += chunk
    sync()
    tm = time.perf_counter()
    for s in staged:
        ct.process_chunk(s)
    ct.sync()
    sync()
    d = time.perf_counter() - tm
    out["scan_no_ba_ms_per_frame"] = d / (len(staged) * chunk) * 1e3
    out["scan_no_ba_fps"] = len(staged) * chunk / d
    print("scan done", out, file=sys.stderr, flush=True)

    m, cam = ct.engine.map, ct.engine.cam
    out["map"] = {"n_kf": int(m.n_kf), "n_lm": int(m.n_lm)}
    for window, iters in SHAPES:
        local_ba(m, cam, window=window, iters=iters, covisibility=True)
        sync()
        tb = time.perf_counter()
        for _ in range(TIMED):
            local_ba(m, cam, window=window, iters=iters, covisibility=True)
            sync()
        key = f"local_ba_w{window}_i{iters}_ms"
        out[key] = (time.perf_counter() - tb) / TIMED * 1e3
        print("ba", window, iters, out[key], file=sys.stderr, flush=True)

    out.update(device=str(device), hardware=bp.hardware(device),
               frames=len(staged) * chunk, chunk=chunk, size=[args.height, args.width],
               keypoints=args.keypoints)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    bp.add_point_args(p, frames=128)
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
