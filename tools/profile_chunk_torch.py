"""Where the port's chunk-loop time goes: tools/profile_chunk.py's four
measurements, through lpslam_tpu_torch on the card.

    python3 tools/profile_chunk_torch.py [--out FILE]
    python3 tools/profile_chunk_torch.py --device cpu --frames 16 --width 160 \\
        --height 120 --keypoints 256 --chunk 8

At the bench operating point (lpslam_tpu_torch/eval/bench_point.py: 1200 keypoints,
640x480, chunks of 16; 16 init frames, then --frames = 160 measured):
  A. upload only: 10 chunks of raw uint8 frames staged on the device;
  B. scan only: chunks over frames staged beforehand, the boundary's cull
     and compaction off (`boundary_compact = False`);
  C. scan + boundary: the same with the boundary on (the default);
  D. the bench loop: each chunk staged just before the previous one runs.
B-D run two chunks first (warm-up). Each clock reading follows a
synchronize. Prints one JSON object with the JAX tool's keys (unrounded),
plus the culls the boundary ran in C and what the numbers were taken on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lpslam_tpu_torch.eval import bench_point as bp  # noqa: E402


def measure(args) -> dict:
    device = bp.open_device(args.device)
    sync = bp.synchronizer(device)
    chunk, n_meas = args.chunk, args.frames
    total = bp.N_INIT + 2 * chunk + n_meas + chunk
    point = bp.BenchPoint(args, total, device)
    frames = point.frames
    out = {}

    # --- A: upload only
    ct, _ = point.chunked()
    ct.prefetch(frames[0:chunk])
    sync()
    n_up = min(10, len(frames) // chunk)
    tA = time.perf_counter()
    handles = [ct.prefetch(frames[k * chunk:(k + 1) * chunk]) for k in range(n_up)]
    sync()
    dA = time.perf_counter() - tA
    del handles
    out["upload_ms_per_frame"] = dA / (n_up * chunk) * 1e3
    out["upload_fps_ceiling"] = n_up * chunk / dA

    # --- B / C: scan only, then scan + boundary, on staged frames
    from lpslam_tpu_torch.frontend import device_loop

    for name, compact in (("scan_only", False), ("scan_boundary", True)):
        ct, t = point.chunked()
        ct.boundary_compact = compact
        for _ in range(2):  # warm-up
            ct.process_chunk(frames[t:t + chunk])
            t += chunk
        ct.sync()
        staged = []
        while t + chunk <= len(frames) and len(staged) * chunk < n_meas:
            staged.append(ct.prefetch(frames[t:t + chunk]))
            t += chunk
        sync()
        culls = []
        real_cull = device_loop.cull_and_compact

        def counted(*a, **kw):
            culls.append(1)
            return real_cull(*a, **kw)

        device_loop.cull_and_compact = counted
        try:
            tm = time.perf_counter()
            for s in staged:
                ct.process_chunk(s)
            ct.sync()
            sync()
            d = time.perf_counter() - tm
        finally:
            device_loop.cull_and_compact = real_cull
        out[name + "_fps"] = len(staged) * chunk / d
        out[name + "_ms_per_frame"] = d / (len(staged) * chunk) * 1e3
        out[name + "_keyframes"] = int(ct.engine._kf_count)
        out[name + "_culls"] = len(culls)

    # --- D: the bench loop as it is (each chunk staged inline)
    ct, t = point.chunked()
    for _ in range(2):
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
    ct.sync()
    sync()
    tm = time.perf_counter()
    nxt = ct.prefetch(frames[t:t + chunk])
    done = 0
    while done < n_meas:
        cur = nxt
        t += chunk
        if t + chunk <= len(frames):
            nxt = ct.prefetch(frames[t:t + chunk])
        ct.process_chunk(cur)
        done += chunk
    ct.sync()
    sync()
    out["bench_loop_fps"] = done / (time.perf_counter() - tm)

    out.update(device=str(device), hardware=bp.hardware(device), frames=n_meas,
               chunk=chunk, size=[args.height, args.width], keypoints=args.keypoints,
               render_s=point.render_s)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    bp.add_point_args(p, frames=160)
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
