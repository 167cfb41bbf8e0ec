"""Benchmark of the PyTorch/CUDA port: full-pipeline tracked frames/s on one
card at the reference operating point, under bench.py's protocol.

    python3 bench_torch.py                       # on the card
    BENCH_DEVICE=cpu BENCH_FRAMES=16 BENCH_WINDOWS=1 python3 bench_torch.py

Prints ONE JSON line with bench.py's keys: {"metric":
"full_pipeline_tracked_fps_per_chip", "value": N, "unit": "frames/s",
"vs_baseline": N / 60, "detail": {...}}; `detail` holds every key of
bench.py's, plus `device` and `hardware` (the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them,
or the CPU model). Numbers are not rounded.

Workload: bench.py's, through lpslam_tpu_torch (eval/bench_point.py):
the 640x480 ray-cast room with lens distortion as uint8 frames, undistorted
on the device, 1200 keypoints, 3 levels, MapConfig(128, 24576, 1200), at
most 16 frames of host initialization, then the chunk loop (ChunkedTracker)
in chunks of BENCH_CHUNK. Every frame is rendered before any timer.

Knobs (bench.py's names): BENCH_CHUNK (16), BENCH_WINDOWS (3), BENCH_FRAMES
(160 per window), and BENCH_DEVICE (cuda), the only way to ask for the CPU:
without a card and without BENCH_DEVICE=cpu the script exits non-zero. There
is no fallback. Each chunk is staged just before it runs (bench.py's
BENCH_IO_THREADS=0); bench.py's thread-pool staging is not ported, since it
gained nothing on the H100 (PERF.md), and BENCH_IO_THREADS other than 0 is
refused.

Protocol: two chunks of warm-up; the upload probe (three chunks staged, each
followed by a synchronize); BENCH_WINDOWS windows of BENCH_FRAMES //
BENCH_CHUNK chunks, each window's wall ending after ct.sync() and a
synchronize; the floor (`scan_only_fps`): one more window whose chunks are
all staged and synchronized before its timer; the headline is the median
window, the lower middle one for an even count. Three departures from
bench.py:
1. no retry windows: exactly BENCH_WINDOWS windows run (bench.py measures
   more when the median sits under 0.7x the floor, so its sample depends
   on the outcome); `windows_retried` is always 0;
2. `frame_ms_median` / `_p95` time each chunk's work, not its dispatch: on
   the card, CUDA events on the current stream before the window and after
   each process_chunk, read after the window's synchronize (no sync inside
   the window); on the CPU, whose work is synchronous, the host clock
   around each call;
3. a window's frames/s divides the frames it processed (whole chunks), not
   BENCH_FRAMES; `frames_per_window` says how many.

`cpu_anchor_fps` is the port on a host CPU at this point, from
CPU_ANCHOR_TORCH.json (tools/cpu_anchor_torch.py), never bench.py's
CPU_ANCHOR.json; null where the file is missing.
"""
from __future__ import annotations

import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from lpslam_tpu_torch.eval import bench_point as bp

BASELINE_FPS = 60.0    # BASELINE.md: twice an OpenVSLAM-class CPU tracker's ~30 frames/s
POINT = SimpleNamespace(width=640, height=480, keypoints=1200,
                        max_keyframes=bp.MAX_KEYFRAMES, max_landmarks=bp.MAX_LANDMARKS)
CPU_ANCHOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "CPU_ANCHOR_TORCH.json")


def bench_point(device, chunk: int = 16, windows: int = 3, frames_per_window: int = 160,
                frames=None) -> bp.BenchPoint:
    """The bench's room, rectifier and tracker configuration, with bench.py's
    frame count (init, warm-up, the windows, the floor and one chunk to
    spare); `frames` hands in a rendering of the room already made."""
    total = bp.N_INIT + 2 * chunk + (windows + 1) * frames_per_window + chunk
    return bp.BenchPoint(POINT, total, torch.device(device), frames=frames)


def lower_median(values) -> int:
    """The index of the median value; the lower middle one for an even count."""
    return int(np.argsort(values, kind="stable")[(len(values) - 1) // 2])


def cpu_anchor_fps():
    try:
        with open(CPU_ANCHOR) as f:
            return float(json.load(f)["value"])
    except (OSError, KeyError, TypeError, ValueError):
        return None


def measure(chunk: int = 16, windows: int = 3, frames_per_window: int = 160,
            device="cuda", point=None, mark=None) -> dict:
    """Run the protocol and return the line. `point` (default: the bench's
    on `device`, rendered here) gives `frames`, `cfg`, `device` and
    `chunked()`, and its device is the one measured; `mark(stage)`, if
    given, is called before "init", "warmup", "probe", "windows" and
    "floor", and at "end", each outside every timer."""
    from lpslam_tpu_torch.frontend import TrackerStatus

    n_chunks = frames_per_window // chunk
    if windows < 1 or n_chunks < 1:
        raise ValueError(f"{windows} windows of {frames_per_window} frames in chunks of "
                         f"{chunk}: a window needs at least one chunk")
    if point is None:
        point = bench_point(device, chunk, windows, frames_per_window)
    device = point.device
    sync = bp.synchronizer(device)
    on_card = device.type == "cuda"
    mark = mark or (lambda stage: None)
    frames = point.frames

    mark("init")
    ct, t = point.chunked()
    engine = ct.engine
    need = t + 2 * chunk + (windows + 1) * n_chunks * chunk
    if len(frames) < need:
        raise ValueError(f"{len(frames)} frames; the protocol needs {need}")

    # warm-up: every chunk of the windows has this size, so nothing new is
    # built inside them
    mark("warmup")
    for _ in range(2):
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
    ct.sync()
    sync()

    mark("probe")
    tp0 = time.perf_counter()
    for _ in range(3):
        ct.prefetch(frames[t - 2 * chunk:t - chunk])
        sync()
    upload_probe_ms = (time.perf_counter() - tp0) / (3 * chunk) * 1e3

    def run_window(t0: int):
        starts = [t0 + k * chunk for k in range(n_chunks)]
        stamps = []
        t_w = time.perf_counter()
        if on_card:
            first = torch.cuda.Event(enable_timing=True)
            first.record()
        for s in starts:
            cur = ct.prefetch(frames[s:s + chunk])
            tc = time.perf_counter()
            ct.process_chunk(cur)
            if on_card:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                stamps.append(e)
            else:
                stamps.append((time.perf_counter() - tc) * 1e3)
        ct.sync()
        sync()
        wall = time.perf_counter() - t_w
        if on_card:
            stamps = [a.elapsed_time(b) for a, b in zip([first] + stamps, stamps)]
        return n_chunks * chunk / wall, np.asarray(stamps) / chunk, starts[-1] + chunk

    window_fps, window_ms = [], []
    mark("windows")
    for _ in range(windows):
        fps_w, ms_w, t = run_window(t)
        window_fps.append(fps_w)
        window_ms.append(ms_w)

    # the floor: every chunk on the device before the timer
    mark("floor")
    staged = []
    for _ in range(n_chunks):
        staged.append(ct.prefetch(frames[t:t + chunk]))
        sync()
        t += chunk
    t_s = time.perf_counter()
    for cur in staged:
        ct.process_chunk(cur)
    ct.sync()
    sync()
    scan_only_fps = n_chunks * chunk / (time.perf_counter() - t_s)
    mark("end")

    head = lower_median(window_fps)
    fps, ms = window_fps[head], window_ms[head]
    anchor = cpu_anchor_fps()
    sts, n_inl = ct.collect()[:2]
    h, w = frames.shape[1:3]
    return {
        "metric": "full_pipeline_tracked_fps_per_chip",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / BASELINE_FPS,
        "detail": {
            "keypoints": point.cfg.orb.num_keypoints,
            "levels": point.cfg.orb.num_levels,
            "resolution": f"{w}x{h}",
            "chunk": chunk,
            "io_threads": 0,
            "frames_per_window": n_chunks * chunk,
            "window_fps": window_fps,
            "window_fps_best": max(window_fps),
            "window_fps_worst": min(window_fps),
            "windows_retried": 0,
            "scan_only_fps": scan_only_fps,
            "cpu_anchor_fps": anchor,
            "vs_cpu_anchor": fps / anchor if anchor else None,
            "upload_probe_ms_per_frame": upload_probe_ms,
            "window_vs_compute_floor": fps / scan_only_fps,
            "transport_bound": bool(fps < 0.7 * scan_only_fps),
            "tracking_fraction": float((sts == int(TrackerStatus.TRACKING)).mean()),
            "median_inliers": int(np.median(n_inl)),
            "keyframes": int(engine._kf_count),
            "landmarks": int(engine.n_landmarks),
            "state": engine.status.name,
            "frame_ms_median": float(np.median(ms)),
            "frame_ms_p95": float(np.percentile(ms, 95)),
            "device": str(device),
            "hardware": bp.hardware(device),
        },
    }


def main() -> int:
    if os.environ.get("BENCH_IO_THREADS", "0") != "0":
        print("bench_torch: BENCH_IO_THREADS is not ported; chunks are staged in "
              "sequence (BENCH_IO_THREADS=0)", file=sys.stderr)
        return 2
    name = os.environ.get("BENCH_DEVICE", "cuda")
    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        print(f"bench_torch: no CUDA device for BENCH_DEVICE={name}; the benchmark runs "
              "on the card (BENCH_DEVICE=cpu asks for the CPU)", file=sys.stderr)
        return 2
    line = measure(chunk=int(os.environ.get("BENCH_CHUNK", "16")),
                   windows=int(os.environ.get("BENCH_WINDOWS", "3")),
                   frames_per_window=int(os.environ.get("BENCH_FRAMES", "160")),
                   device=bp.open_device(name))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
