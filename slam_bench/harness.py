"""The benchmark's driver: one cell (a configuration under a traffic mix)
from set-up through the measured window to the outputs the reference
judges. Everything that belongs to one configuration, traffic mix or
metric is read from its own file (configs/, traffic/, metrics/) by the name
in BENCHMARK.json.

The window drives the pipeline tracker
(``lpslam_tpu_torch.pipeline.trackers.VSLAMTracker.process_image``) with
one camera stream in a closed loop: the next frame goes in when the call
returns. A frame is a ``CameraQueueEntry`` of raw uint8 frames from the
room's lap. The chunk path gets them raw and rectifies them on the device
(``attach_device_rectify``, which no entry point of the program attaches
yet: ``run_dataset`` and ``SlamManager`` rectify every frame on the host);
a frame headed for the per-frame host path (the engine not TRACKING, or
``chunk_size`` < 2) first goes through the program's ``RectifyProcessor``,
as the pipeline's processors hand it to the tracker.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from . import room as room_mod

BENCH_DIR = Path(__file__).resolve().parent
# set-up gives up when the tracker has not initialized within this many frames
INIT_MAX_FRAMES = 40
# warm-up after initialization: chunk boundaries on the chunk path, frames on the host path
WARMUP_CHUNKS = 2
WARMUP_FRAMES = 16
FORBIDDEN = ("jax", "jaxlib", "flax", "lpslam_tpu", "bench", "bench_torch")
# spans that only label the trace's idle gaps (every metric's own spans are added)
LABEL_SPANS = {
    "extract_orb": ["lpslam_tpu_torch.frontend.device_loop:extract_orb",
                    "lpslam_tpu_torch.frontend.tracker:extract_orb"],
    "pose_only_optimize": ["lpslam_tpu_torch.frontend.tracker:pose_only_optimize"],
    "cull_and_compact": ["lpslam_tpu_torch.frontend.device_loop:cull_and_compact",
                         "lpslam_tpu_torch.frontend.tracker:cull_and_compact"],
    "rectify": ["lpslam_tpu_torch.pipeline.rectify:RectifyProcessor.process_image"],
    "process_image": ["lpslam_tpu_torch.pipeline.trackers:VSLAMTracker.process_image"],
}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's (or an earlier bench file's)."""
    return sorted({name.split(".")[0] for name in list(os.sys.modules)} & set(FORBIDDEN))


def tracked_between(frames, t_start: float, t_close: float) -> int:
    """Results that came back TRACKING from calls that returned inside
    [t_start, t_close], whichever call handed their frames in."""
    return sum(1 for f in frames if f.result and f.result.valid and t_start <= f.t_out <= t_close)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str):
    """(benchmark, cell, configuration, traffic) for a workload name."""
    bench = read_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = read_json(root / conf["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def load_limits(workload: str) -> dict:
    """The limits of `correct` of a cell: limits/<cell>.json's "numbers"."""
    return read_json(BENCH_DIR / "limits" / f"{workload}.json")["numbers"]


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or with
    trace its per-layer ones (an entry without `workloads` is everyone's)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell["name"] in m.get("workloads", [cell["name"]])]


def load_metric(name: str):
    """The reader module metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Spans and recorded calls, wrapped around the program's functions
# ---------------------------------------------------------------------------


def _resolve(target: str):
    mod_name, _, path = target.partition(":")
    owner = importlib.import_module(mod_name)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


class Tracer:
    """Host-clock spans (no device sync) around the program's functions,
    patched at the module or class attribute their callers look up, and
    recorded call arguments. A span re-entered under the same name counts
    once. While `profiling`, each span also opens a profiler range, which
    labels the trace."""

    def __init__(self, spans: dict, calls: dict):
        self.totals = {name: [0.0, 0] for name in spans}
        self.calls = {name: [] for name in calls}
        self.timing = self.recording = self.profiling = False
        self._depth = dict.fromkeys(spans, 0)
        self._undo = []
        for name, targets in spans.items():
            for t in targets:
                self._patch(t, self._span_wrapper(name))
        for name, targets in calls.items():
            for t in targets:
                self._patch(t, self._call_wrapper(name))

    def _patch(self, target: str, make):
        owner, attr = _resolve(target)
        own = isinstance(owner, type) and attr in owner.__dict__
        orig = owner.__dict__[attr] if own else getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig, own or not isinstance(owner, type)))

    def _span_wrapper(self, name):
        def make(orig):
            def wrapped(*args, **kwargs):
                if self._depth[name]:
                    return orig(*args, **kwargs)
                self._depth[name] += 1
                rf = None
                if self.profiling:
                    rf = torch.profiler.record_function(name)
                    rf.__enter__()
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t0
                    if rf is not None:
                        rf.__exit__(None, None, None)
                    self._depth[name] -= 1
                    if self.timing:
                        tot = self.totals[name]
                        tot[0] += dt
                        tot[1] += 1
            return wrapped
        return make

    def _call_wrapper(self, name):
        def make(orig):
            def wrapped(*args, **kwargs):
                if self.recording:
                    self.calls[name].append((args, kwargs))
                return orig(*args, **kwargs)
            return wrapped
        return make

    def remove(self):
        for owner, attr, orig, restore in reversed(self._undo):
            if restore:
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        self._undo.clear()


# ---------------------------------------------------------------------------
# The session: room, tracker, feeding
# ---------------------------------------------------------------------------


class Frame:
    __slots__ = ("lap_idx", "t_in", "t_out", "host", "result", "window")

    def __init__(self, lap_idx, t_in, host, window):
        self.lap_idx, self.t_in, self.host, self.window = lap_idx, t_in, host, window
        self.t_out = None
        self.result = None     # the TrackerResult, or False: the call returned none


class Session:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        import lpslam_tpu_torch  # noqa: F401  (TF32 off, "highest" matmul precision)
        from lpslam_tpu_torch.eval.run_dataset import build_rectifier
        from lpslam_tpu_torch.frontend.tracker import TrackerStatus
        from lpslam_tpu_torch.geometry.camera import rectify_maps_stereo, undistort_map_radtan
        from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
        from lpslam_tpu_torch.pipeline.trackers import VSLAMTracker

        self.device = torch.device(device)
        sensor = cfg["sensor"]
        self.mode = sensor["mode"]
        self.fps = float(sensor["fps"])
        self.intr = room_mod.camera_intrinsics(sensor)
        self.lap_len = int(cfg["lap_frames"])
        # every seed runs the same lap of the same room, from its own starting frame
        self.offset = int(seed) % self.lap_len
        eyes = (0.0, sensor["baseline"]) if self.mode == "stereo" else (0.0,)
        self.lap = room_mod.Room(cfg["room_seed"], seed, self.intr, self.lap_len,
                                 self.device).render_lap(eyes)
        if self.device.type == "cuda":
            # the program's peak, not the renderer's
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

        intr = dict(self.intr, dist=np.asarray(self.intr["dist"], np.float64),
                    model="perspective", baseline=sensor.get("baseline", 0.0))
        self.proc, cam, fxb = build_rectifier(intr, self.mode, device=self.device)
        options = dict(cfg["tracker"])
        options.update(traffic.get("tracker", {}))
        options["mode"] = self.mode
        if self.mode == "stereo":
            options["focal_x_baseline"] = fxb
        self.chunk = int(options.get("chunk_size", 0))
        self.tracker = VSLAMTracker(cam, options, device=self.device)
        if self.chunk >= 2:
            K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1.0]])
            size = (intr["height"], intr["width"])
            if self.mode == "stereo":
                r = rectify_maps_stereo(K, intr["dist"], K, intr["dist"], np.eye(3),
                                        np.array([-intr["baseline"], 0.0, 0.0]), size)
                grid = np.stack([r["map_l"], r["map_r"]])
            else:
                grid = undistort_map_radtan(K, intr["dist"], size)
            self.tracker.attach_device_rectify(grid)
        self.TRACKING = TrackerStatus.TRACKING
        self.Entry = CameraQueueEntry
        self.frames: list = []
        self._by_ts: dict = {}

    def lap_index(self, n: int) -> int:
        return (self.offset + n) % self.lap_len

    def raw_left(self, lap_idx: int) -> np.ndarray:
        f = self.lap[lap_idx]
        return f[0] if self.mode == "stereo" else f

    def host_bound(self) -> bool:
        return self.chunk < 2 or self.tracker.engine.status != self.TRACKING

    def feed(self, window: bool):
        """Hand the next frame to the tracker; record its hand-in time and
        whatever results the call gave back. Returns (the Frame, what
        process_image returned)."""
        n = len(self.frames)
        i = self.lap_index(n)
        ts = n / self.fps
        host = self.host_bound()
        fr = Frame(i, time.perf_counter(), host, window)
        self.frames.append(fr)
        self._by_ts[ts] = fr
        img = self.lap[i]
        if self.mode == "stereo":
            entry = self.Entry(timestamp=ts, image=img[0], image_second=img[1])
        else:
            entry = self.Entry(timestamp=ts, image=img)
        if host and self.proc is not None:
            entry = self.proc.process_image(entry)
        out = self.tracker.process_image(entry)
        t_out = time.perf_counter()
        for res in out or ():
            done = self._by_ts[res.timestamp]
            done.result, done.t_out = res, t_out
        if host and fr.t_out is None:
            fr.result, fr.t_out = False, t_out
        return fr, out

    def set_up(self):
        """Initialize on the host path, then warm the cell's own shapes:
        `WARMUP_CHUNKS` chunk boundaries (chunk path) or `WARMUP_FRAMES`
        host frames; the chunk buffer is empty when it returns."""
        while self.tracker.engine.status != self.TRACKING:
            if len(self.frames) >= INIT_MAX_FRAMES:
                raise RuntimeError(f"no initialization within {INIT_MAX_FRAMES} frames")
            self.feed(window=False)
        if self.chunk >= 2:
            boundaries = 0
            while boundaries < WARMUP_CHUNKS:
                fr, out = self.feed(window=False)
                boundaries += (out is not None) and not fr.host
        else:
            for _ in range(WARMUP_FRAMES):
                self.feed(window=False)
        self.n_setup = len(self.frames)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float):
        """The measured window; returns (t_start, t_close)."""
        self.sync()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            self.feed(window=True)
        return t_start, time.perf_counter()

    def wait_results(self, limit_s: float = 60.0):
        """Feed on (frames outside the window) until every window frame has
        its answer, or `limit_s` has passed."""
        t_end = time.perf_counter() + limit_s
        while any(f.window and f.t_out is None for f in self.frames) \
                and time.perf_counter() < t_end:
            self.feed(window=False)

    def window_frames(self) -> list:
        return [f for f in self.frames if f.window]

    def outputs(self) -> dict:
        """What the reference judges, as numpy: the window frames' results
        and the final map. Call after the program's last frame."""
        m = self.tracker.engine.map
        keys = ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_uv", "kf_desc", "kf_kp_valid",
                "kf_lm_idx", "lm_pos", "lm_valid")
        mp = {k: getattr(m, k).detach().cpu().numpy() for k in keys}
        wf = self.window_frames()
        ok = [bool(f.result) and bool(f.result.valid) for f in wf]
        pos = np.array([f.result.position if o else np.zeros(3) for f, o in zip(wf, ok)])
        quat = np.array([f.result.orientation_wxyz if o else np.array([1.0, 0, 0, 0])
                         for f, o in zip(wf, ok)])
        return {
            "map": mp,
            "frames": {"lap_idx": np.array([f.lap_idx for f in wf]), "tracked": np.array(ok),
                       "position_lp": pos.reshape(-1, 3), "quat_lp": quat.reshape(-1, 4)},
            "lap_of_fid": np.array([self.lap_index(n) for n in range(len(self.frames))]),
            "fids_after_setup": set(range(self.n_setup, len(self.frames))),
            "raw_left": self.raw_left,
        }

    def close(self):
        self.tracker.stop()
