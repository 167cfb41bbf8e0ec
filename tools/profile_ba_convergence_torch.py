"""Convergence of the port's staged-LM local BA on real map windows:
tools/profile_ba_convergence.py through lpslam_tpu_torch on the card.

    python3 tools/profile_ba_convergence_torch.py [--mode mono|stereo] [--out FILE]
    python3 tools/profile_ba_convergence_torch.py --device cpu --mode mono \\
        --frames 30 --width 160 --height 120 --keypoints 256 --iters 2,4

Tracks the room (`SyntheticBenchmark(seed=0, turns=1.08 * frames / 600)`,
640x480, through eval/run_dataset.py::build_rectifier) with a VSLAMTracker
(--mode, 1200 keypoints, 3 levels, MapConfig(128, 24576)) over --frames =
90 frames; snapshots the map at frames nf/3, 2nf/3 and nf-1 where it holds
at least 6 keyframes; and from each snapshot runs `local_ba` (window 6,
covisibility on) at every count of --iters = 4,6,8,12,16,24: one warm call,
then one timed call, synchronized. Reports each call's final Huber cost,
its excess over the largest count's cost (`excess_vs_converged`: within
~1% means that count suffices on real windows) and its wall ms. Prints one
JSON object with the JAX tool's keys (unrounded), plus what the numbers
were taken on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lpslam_tpu_torch.eval import bench_point as bp  # noqa: E402

WINDOW = 6


def profile_snapshot(m, cam, iters_list, sync, window: int = WINDOW) -> dict:
    """local_ba from the same map at every iteration count: final cost, wall
    ms of the timed call, and the excess over the largest count's cost."""
    from lpslam_tpu_torch.backend.ba import local_ba

    per = {"n_kf": int(m.n_kf), "n_lm": int(m.n_lm), "by_iters": []}
    costs = {}
    for it in iters_list:
        local_ba(m, cam, window=window, iters=it, covisibility=True)   # warm
        sync()
        t0 = time.perf_counter()
        _, res = local_ba(m, cam, window=window, iters=it, covisibility=True)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        costs[it] = float(res.final_cost)
        per["by_iters"].append({"iters": it, "final_cost": costs[it], "wall_ms": wall_ms})
    ref = costs[max(iters_list)]
    if ref:
        for r in per["by_iters"]:
            r["excess_vs_converged"] = r["final_cost"] / ref - 1.0
    return per


def measure(args) -> dict:
    import torch

    from lpslam_tpu_torch.eval.run_dataset import build_rectifier
    from lpslam_tpu_torch.io import SyntheticBenchmark
    from lpslam_tpu_torch.mapstore.store import MapStore
    from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
    from lpslam_tpu_torch.pipeline.trackers import VSLAMTracker

    device = bp.open_device(args.device)
    sync = bp.synchronizer(device)
    nf = args.frames
    ds = SyntheticBenchmark(num_frames=nf, h=args.height, w=args.width, seed=0,
                            stereo=args.mode == "stereo", turns=1.08 * nf / 600.0)
    proc, cam, fxb = build_rectifier(ds.intr, args.mode, device=device)
    tracker = VSLAMTracker(cam, {
        "mode": args.mode, "keypoints": args.keypoints, "levels": 3,
        "max_keyframes": args.max_keyframes, "max_landmarks": args.max_landmarks,
        "focal_x_baseline": fxb if args.mode == "stereo" else 0.0,
    }, device=device)
    snapshots = []
    snap_at = {nf // 3, 2 * nf // 3, nf - 1}
    t0 = time.perf_counter()
    for i, frame in enumerate(ds):
        entry = CameraQueueEntry(timestamp=frame.timestamp, image=frame.image,
                                 image_second=frame.image_right)
        if proc is not None:
            entry = proc.process_image(entry)
        tracker.process_image(entry)
        m = tracker.engine.map
        if i in snap_at and int(m.n_kf) >= 6:
            snapshots.append((i, MapStore(*(x.clone() for x in m))))
    track_s = time.perf_counter() - t0
    if not snapshots:
        raise SystemExit("no snapshot with enough keyframes")
    iters_list = [int(s) for s in args.iters.split(",")]
    rows = []
    for fid, m in snapshots:
        per = {"frame": fid, **profile_snapshot(m, tracker.engine.cam, iters_list, sync)}
        rows.append(per)
        print(json.dumps(per), file=sys.stderr, flush=True)
    return {
        "metric": "local_ba_staged_lm_convergence",
        "platform": device.type,
        "hardware": bp.hardware(device),
        "torch": torch.__version__,
        "mode": args.mode,
        "keypoints": args.keypoints,
        "window": WINDOW,
        "frames": nf,
        "track_s": track_s,
        "note": "same map snapshot optimized at each iters count;"
                f" iters={max(iters_list)} treated as converged reference",
        "snapshots": rows,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--mode", default="stereo", choices=["mono", "stereo"])
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--keypoints", type=int, default=1200)
    p.add_argument("--max-keyframes", type=int, default=bp.MAX_KEYFRAMES,
                   dest="max_keyframes")
    p.add_argument("--max-landmarks", type=int, default=bp.MAX_LANDMARKS,
                   dest="max_landmarks")
    p.add_argument("--iters", default="4,6,8,12,16,24")
    p.add_argument("--out", default="")
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
