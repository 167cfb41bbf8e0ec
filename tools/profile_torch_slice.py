"""Where the time of the PyTorch/CUDA port's chunk loop goes, on one card.

    python3 tools/profile_torch_slice.py [--chunks 2]

Initializes the monocular slice exactly as chip_smoke.py does (640x480 room,
1200 keypoints, 3 levels, chunks of 16), runs one warm-up chunk, then:

1. plain window: `--chunks` chunks, uninstrumented, synchronized only at
   its two ends — the loop's own ms/frame;
2. phase breakdown: `--chunks` more chunks with each phase of the loop
   (batched remap+ORB, track_frame, insert_keyframe, local_ba, boundary
   cull) timed on the host clock between torch.cuda.synchronize() calls, and
   inside track_frame its pose_only_optimize and match_projected calls;
3. device view: `--chunks` more chunks under torch.profiler — device time
   per frame, device events per frame and the top kernels by device time.
   The profiler slows the host about twofold, so the device busy share is
   the profiled device time over the plain window's wall time
   (`device_busy_share`); the share over the profiled window itself is
   printed beside it (`device_busy_share_profiled`).

Prints the profiler's table, then one JSON line with the numbers and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _timed(store, name, fn):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        store[name] += time.perf_counter() - t0
        return out
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from lpslam_tpu_torch.backend import ba
    from lpslam_tpu_torch.frontend import device_loop, tracker

    card = chip_smoke.card_line()
    chunk = chip_smoke.CHUNK
    st = chip_smoke.init_slice(torch.device("cuda"), n_after=chunk * (1 + 3 * args.chunks))
    ct, frames, t = st["ct"], st["frames"], st["t"]
    ct.process_chunk(frames[t:t + chunk])
    t += chunk
    torch.cuda.synchronize()

    # 1. the loop as it runs, uninstrumented
    t0 = time.perf_counter()
    for _ in range(args.chunks):
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    # 2. phase breakdown on the host clock (synchronized around each phase)
    phases = defaultdict(float)
    saved = {}
    for mod, name in ((device_loop, "extract_orb"), (device_loop, "remap_bilinear"),
                      (device_loop, "track_frame"), (device_loop, "insert_keyframe"),
                      (device_loop, "cull_and_compact"), (ba, "local_ba"),
                      (tracker, "pose_only_optimize"), (tracker, "match_projected")):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, _timed(phases, name, saved[(mod, name)]))
    # (the chunk step and track_frame look these names up in their modules
    # at call time; the track_frame phase includes its two sub-phases)
    t0 = time.perf_counter()
    for _ in range(args.chunks):
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
    torch.cuda.synchronize()
    wall_phase = time.perf_counter() - t0
    for (mod, name), fn in saved.items():
        setattr(mod, name, fn)

    # 3. device view under the profiler
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.chunks):
            ct.process_chunk(frames[t:t + chunk])
            t += chunk
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    # device activity (kernels, copies, memsets) as the profiler saw it; one
    # stream, so device events do not overlap and their sum is busy time
    from torch.autograd import DeviceType

    dev = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for ev in dev:
        by_name[ev.name] += ev.time_range.elapsed_us()
    dev_us = sum(by_name.values())
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    n_frames = args.chunks * chunk
    print(json.dumps({
        "card": card,
        "frames": n_frames,
        "phase_ms_per_frame": {k: v * 1e3 / n_frames for k, v in phases.items()},
        "plain_ms_per_frame": wall_plain * 1e3 / n_frames,
        "phase_window_ms_per_frame": wall_phase * 1e3 / n_frames,
        "profiled_ms_per_frame": wall_prof * 1e3 / n_frames,
        "device_ms_per_frame": dev_us * 1e-3 / n_frames if dev else None,
        "device_busy_share": dev_us * 1e-6 / wall_plain if dev else None,
        "device_busy_share_profiled": dev_us * 1e-6 / wall_prof if dev else None,
        "device_events_per_frame": len(dev) / n_frames,
        "top_device_ms_per_frame": {k[:80]: v * 1e-3 / n_frames for k, v in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
