"""The operating point that bench_torch.py and the port's profile tools
(tools/*_torch.py) share, and how the tools time.

bench.py's point, as bench.py, tools/profile_chunk.py, profile_ba.py and
cpu_anchor.py set it up for the JAX package: the 640x480 ray-cast room
(`SyntheticBenchmark(seed=0, turns=1.08 * frames / 556)`, lens distortion)
as uint8 frames, undistorted on the device by
eval/run_dataset.py::build_rectifier(intr, "mono"), a MonoTracker with 1200
keypoints, 3 levels and MapConfig(128, 24576, 1200), initialized on the host
path from the first 16 frames, then driven in chunks of 16. Imports only
lpslam_tpu_torch (and numpy, torch).
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

N_INIT = 16
MAX_KEYFRAMES, MAX_LANDMARKS = 128, 24576


def add_point_args(p, frames: int, chunk: int = 16, device: bool = True) -> None:
    """The size arguments: measured frames, frame size, keypoints, chunk,
    the map's capacities, and the device (the card unless the CPU is asked for)."""
    if device:
        p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--frames", type=int, default=frames, help="measured frames")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--keypoints", type=int, default=1200)
    p.add_argument("--chunk", type=int, default=chunk)
    p.add_argument("--max-keyframes", type=int, default=MAX_KEYFRAMES, dest="max_keyframes")
    p.add_argument("--max-landmarks", type=int, default=MAX_LANDMARKS, dest="max_landmarks")


def open_device(name: str) -> torch.device:
    """The device a tool measures on; a CUDA device must exist (no fallback
    to the CPU: a CPU run is asked for with --device cpu)."""
    import lpslam_tpu_torch  # noqa: F401  (full-fp32 matmuls, TF32 off)

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {name}; pass --device cpu")
    return device


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo; where the name reads
    "unknown" (a virtual machine may hide it), its vendor, family and model
    numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name and name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} model "
                f"{info.get('model', '?')} (model name {name!r})")
    import platform

    return platform.processor() or "unknown CPU"


def hardware(device: torch.device) -> str:
    """What the numbers were taken on: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them, or the CPU model."""
    if device.type != "cuda":
        return cpu_model()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        lines = out.stdout.strip().splitlines()
        idx = device.index or 0
        if out.returncode == 0 and len(lines) > idx:
            return lines[idx].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(device)} (nvidia-smi unavailable)"


def precision() -> str:
    """The float32 matmul settings in force (lpslam_tpu_torch turns TF32 off
    and asks for 'highest' precision, ROADMAP rule 2)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    return (f"float32 products; TF32 {'on' if tf32 else 'off'}, matmul precision "
            f"'{torch.get_float32_matmul_precision()}'")


def synchronizer(device: torch.device):
    """torch.cuda.synchronize on the card (where the JAX tools call
    block_until_ready), a no-op on the CPU."""
    if device.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


class BenchPoint:
    """The rendered room, its rectifier and the tracker configuration.
    `total` frames are rendered as uint8 (the JAX tools' bytes), unless
    `frames` hands in a rendering of the same room already made (uint8,
    (T, height, width)); every `engine()` call initializes a new MonoTracker
    on the host path."""

    def __init__(self, args, total: int, device: torch.device, frames=None):
        from lpslam_tpu_torch.eval.run_dataset import build_rectifier
        from lpslam_tpu_torch.frontend import TrackerConfig
        from lpslam_tpu_torch.io import SyntheticBenchmark
        from lpslam_tpu_torch.kernels.orb import OrbParams
        from lpslam_tpu_torch.mapstore import MapConfig

        t0 = time.perf_counter()
        ds = SyntheticBenchmark(num_frames=total, h=args.height, w=args.width, seed=0,
                                turns=1.08 * total / 556.0)
        if frames is None:
            frames = ds.render_uint8()
        elif frames.dtype != np.uint8 or frames.shape[1:] != (args.height, args.width):
            raise ValueError(f"frames {frames.dtype} {frames.shape[1:]} are not uint8 "
                             f"({args.height}, {args.width})")
        self.frames = frames
        self.render_s = time.perf_counter() - t0
        self.device = device
        self.proc, self.cam, _ = build_rectifier(ds.intr, "mono", device=device)
        self.cfg = TrackerConfig(
            orb=OrbParams(num_keypoints=args.keypoints, num_levels=3),
            map_cfg=MapConfig(max_keyframes=args.max_keyframes,
                              max_landmarks=args.max_landmarks,
                              num_keypoints=args.keypoints),
        )
        self.rmap = (None if self.proc is None
                     else self.proc._maps[0].cpu().numpy())

    def rectify(self, img):
        from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry

        if self.proc is None:
            return img
        entry = CameraQueueEntry(timestamp=0.0, image=img.astype(np.float32))
        return self.proc.process_image(entry).image

    def engine(self, n_init: int = N_INIT):
        """A MonoTracker initialized on the host path; returns (engine, the
        next frame index)."""
        from lpslam_tpu_torch.frontend import MonoTracker, TrackerStatus

        engine = MonoTracker(self.cam, self.cfg, device=self.device)
        t = 0
        while engine.status != TrackerStatus.TRACKING and t < n_init:
            engine.process(self.rectify(self.frames[t]))
            t += 1
        if engine.status != TrackerStatus.TRACKING:
            raise SystemExit(f"no initialization within {n_init} frames")
        return engine, t

    def chunked(self, **kw):
        """A ChunkedTracker over a freshly initialized engine; returns
        (tracker, the next frame index)."""
        from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker

        engine, t = self.engine()
        return ChunkedTracker(engine, rectify_map=self.rmap, **kw), t


def _syncs(fn) -> bool:
    """Whether one call of `fn` makes the host wait for the card (torch's
    sync debug mode raises on such a call); a call that does cannot be
    captured in a CUDA graph."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return False


def _graph_ms(fn, reps: int) -> float:
    """`reps` calls captured in one CUDA graph, replayed between two
    events: the device time of one call without its launches' host cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _profiler_ms(fn, reps: int):
    """The sum of the card's kernel times over `reps` calls, per call, from
    torch.profiler; None when the trace holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    except RuntimeError as exc:       # the profiler could not trace the card
        print(f"profiler: {exc}", file=sys.stderr)
        return None
    return us / 1e3 / reps if us > 0 else None


def time_piece(fn, reps: int, device: torch.device) -> dict:
    """Two times of one call of `fn`: `wall_ms`, the eager wall per call
    with `reps` calls between two synchronizations (what the frame pays
    today), and `device_ms`, the card's time per call: the `reps` calls
    captured in one CUDA graph and replayed between CUDA events, or, where
    a call waits for the host and cannot be captured, the profiler's kernel
    sum (`device_how` says which). On the CPU `device_ms` is None."""
    sync = synchronizer(device)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    rec = {"wall_ms": (time.perf_counter() - t0) * 1e3 / reps}
    if device.type != "cuda":
        rec.update(device_ms=None, device_how="not measured (CPU)")
    elif _syncs(fn):
        ms = _profiler_ms(fn, reps)
        rec.update(device_ms=ms, device_how=(
            "profiler kernel sum (the call waits for the host)" if ms is not None
            else "not measured: the call waits for the host and the profiler saw no kernel"))
    else:
        rec.update(device_ms=_graph_ms(fn, reps), device_how="cuda graph")
    if rec["device_ms"]:
        rec["wall_over_device"] = rec["wall_ms"] / rec["device_ms"]
    return rec
