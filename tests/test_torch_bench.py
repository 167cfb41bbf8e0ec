"""bench_torch.py, the port's bench.py: its line against the JAX bench's on
the CPU, its protocol with a stub tracker, and its refusal without a card.

Parity: the port's `measure` at BENCH_FRAMES=16, BENCH_WINDOWS=1,
BENCH_CHUNK=16 on the CPU (~2.5 min on one thread) against the line that
bench.py prints at the same settings (BENCH_RETRY_WINDOWS=0, JAX on the
CPU), run as a subprocess beside it (~50 s). Bars are the slice test's
(tests/test_torch_slice.py): the same state and tracking fraction,
keyframes within +-1, landmarks and median inliers within 15%; the port's
keys are bench.py's plus `device` and `hardware`.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lpslam_tpu_torch.frontend import TrackerStatus

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch  # noqa: E402

torch.set_num_threads(1)

SETTINGS = dict(chunk=16, windows=1, frames_per_window=16)
REF_ENV = {"JAX_PLATFORMS": "cpu", "BENCH_CHUNK": "16", "BENCH_WINDOWS": "1",
           "BENCH_FRAMES": "16", "BENCH_RETRY_WINDOWS": "0", "BENCH_IO_THREADS": "0"}
# what bench.py printed at REF_ENV when this test was written (48 s on a
# CPU); shown only when the subprocess gives no line
JAX_BENCH_REF = {
    "metric": "full_pipeline_tracked_fps_per_chip", "value": 9.19, "unit": "frames/s",
    "vs_baseline": 0.153,
    "detail": {
        "keypoints": 1200, "levels": 3, "resolution": "640x480", "chunk": 16,
        "io_threads": 0, "frames_per_window": 16, "window_fps": [9.19],
        "window_fps_best": 9.19, "window_fps_worst": 9.19, "windows_retried": 0,
        "scan_only_fps": 5.55, "cpu_anchor_fps": 3.42, "vs_cpu_anchor": 2.69,
        "upload_probe_ms_per_frame": 0.1, "window_vs_compute_floor": 1.655,
        "transport_bound": False, "tracking_fraction": 1.0, "median_inliers": 439,
        "keyframes": 15, "landmarks": 1869, "state": "TRACKING", "frame_ms_median": 0.08,
        "frame_ms_p95": 0.08,
    },
}


@pytest.fixture(scope="module")
def lines():
    """(the port's line, bench.py's line): bench.py starts first and runs
    while the port measures."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    ref = subprocess.Popen([sys.executable, "bench.py"], cwd=REPO, env={**env, **REF_ENV},
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ours = bench_torch.measure(**SETTINGS, device="cpu")
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    printed = [ln for ln in out.splitlines() if ln.startswith("{") and '"metric"' in ln]
    assert ref.returncode == 0 and printed, (
        f"bench.py gave rc {ref.returncode} and no line (its line when this test was "
        f"written: {JAX_BENCH_REF}); stderr: {err[-2000:]}")
    return ours, json.loads(printed[-1])


def test_parity_state_and_tracking(lines):
    ours, ref = (line["detail"] for line in lines)
    assert ours["state"] == ref["state"] == "TRACKING", (ours, ref)
    assert ours["tracking_fraction"] == ref["tracking_fraction"], (ours, ref)


def test_parity_map_and_inliers(lines):
    ours, ref = (line["detail"] for line in lines)
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    for key in ("landmarks", "median_inliers"):
        assert abs(ours[key] - ref[key]) <= 0.15 * ref[key], (key, ours, ref)


def test_parity_keys(lines):
    ours, ref = lines
    assert ours.keys() == ref.keys()
    assert ours["detail"].keys() == ref["detail"].keys() | {"device", "hardware"}
    assert ours["metric"] == ref["metric"]
    assert ours["unit"] == ref["unit"]
    assert ours["vs_baseline"] == ours["value"] / 60.0
    d = ours["detail"]
    assert d["device"] == "cpu" and d["hardware"]
    assert d["windows_retried"] == 0 and len(d["window_fps"]) == 1
    for key in ("keypoints", "levels", "resolution", "chunk", "io_threads",
                "frames_per_window", "windows_retried"):
        assert d[key] == ref["detail"][key], key


def test_cpu_frame_ms_spans_the_window(lines):
    ours = lines[0]
    d = ours["detail"]
    wall_ms = d["frames_per_window"] / ours["value"] * 1e3
    assert abs(d["frame_ms_median"] * d["frames_per_window"] - wall_ms) <= 0.2 * wall_ms, d


# --- the protocol, with a stub tracker (the host clock times its sleeps)

class _StubTracker:
    """ChunkedTracker's surface: prefetch sleeps `prefetch_s`, the k-th
    process_chunk sleeps `chunk_s(k)`; each call's first frame value is
    recorded (frame i holds i)."""

    def __init__(self, prefetch_s=0.0, chunk_s=lambda k: 0.0):
        self.engine = SimpleNamespace(_kf_count=3, n_landmarks=100,
                                      status=TrackerStatus.TRACKING)
        self.prefetch_s, self.chunk_s = prefetch_s, chunk_s
        self.chunks = []

    def prefetch(self, frames):
        time.sleep(self.prefetch_s)
        return np.array(frames)

    def process_chunk(self, frames):
        time.sleep(self.chunk_s(len(self.chunks)))
        self.chunks.append((int(frames[0, 0, 0]), len(frames)))

    def sync(self):
        pass

    def collect(self):
        n = sum(b for _, b in self.chunks)
        return (np.full(n, int(TrackerStatus.TRACKING)), np.full(n, 50)) + (None,) * 5


def _run(ct, marks=None, frames=256, t0=4, device="cpu", **kw):
    point = SimpleNamespace(
        frames=(np.arange(frames) % 256).astype(np.uint8)[:, None, None] * np.ones((1, 2, 3), np.uint8),
        cfg=SimpleNamespace(orb=SimpleNamespace(num_keypoints=8, num_levels=1)),
        device=torch.device("cpu"), chunked=lambda: (ct, t0))

    def mark(stage):
        if marks is not None:
            marks.append((stage, time.perf_counter(), len(ct.chunks)))

    return bench_torch.measure(device=device, point=point, mark=mark, **kw)


def test_fps_divides_the_frames_processed():
    ct, marks = _StubTracker(chunk_s=lambda k: 0.04), []
    line = _run(ct, marks, chunk=16, windows=1, frames_per_window=40)
    stages = dict((s, (t, n)) for s, t, n in marks)
    assert [s for s, _, _ in marks] == ["init", "warmup", "probe", "windows", "floor", "end"]
    (t_w, n_w), (t_f, n_f) = stages["windows"], stages["floor"]
    # two whole chunks of 16 ran in the window: 32 frames, not 40
    assert ct.chunks[n_w:n_f] == [(36, 16), (52, 16)]
    assert line["detail"]["frames_per_window"] == 32
    outer = 32 / (t_f - t_w)     # the window's wall lies inside the marks
    assert outer <= line["value"] <= 1.1 * outer, (line["value"], outer)


def test_headline_is_the_lower_median_window():
    per_window = {2: 0.02, 3: 0.08, 4: 0.04, 5: 0.06}    # calls 0-1: warm-up
    ct = _StubTracker(chunk_s=lambda k: per_window.get(k, 0.0))
    line = _run(ct, chunk=16, windows=4, frames_per_window=16)
    fps = line["detail"]["window_fps"]
    assert len(fps) == 4 and fps[3] < fps[2], fps
    assert line["value"] == fps[3]        # the lower of the middle two
    assert bench_torch.lower_median([5.0, 1.0, 3.0, 2.0]) == 3
    assert bench_torch.lower_median([5.0, 1.0, 3.0]) == 2


def test_exactly_the_windows_asked_for_below_the_floor():
    ct = _StubTracker(prefetch_s=0.03, chunk_s=lambda k: 0.001)
    line = _run(ct, chunk=16, windows=3, frames_per_window=32)
    d = line["detail"]
    assert d["transport_bound"] and d["window_vs_compute_floor"] < 0.7, d
    assert len(d["window_fps"]) == 3 and d["windows_retried"] == 0
    # warm-up 2, three windows of 2, the floor 2: no window more
    assert [t for t, _ in ct.chunks] == list(range(4, 4 + 16 * 10, 16))
    assert d["tracking_fraction"] == 1.0 and d["median_inliers"] == 50


def test_frame_ms_spans_the_window_when_the_work_is_in_the_calls():
    ct = _StubTracker(chunk_s=lambda k: 0.03)
    line = _run(ct, chunk=16, windows=2, frames_per_window=64)
    d = line["detail"]
    wall_ms = d["frames_per_window"] / line["value"] * 1e3
    assert abs(d["frame_ms_median"] * d["frames_per_window"] - wall_ms) <= 0.2 * wall_ms, d


def test_the_points_device_is_the_one_measured():
    # a point on the CPU is measured on the CPU whatever `device` says
    # (with CUDA events and a CUDA synchronize this would fail without a card)
    line = _run(_StubTracker(chunk_s=lambda k: 0.001), chunk=16, windows=1,
                frames_per_window=16, device="cuda")
    assert line["detail"]["device"] == "cpu"
    assert line["detail"]["io_threads"] == 0


def test_too_few_frames_or_no_chunk_raises():
    with pytest.raises(ValueError):
        _run(_StubTracker(), frames=40, chunk=16, windows=1, frames_per_window=16)
    with pytest.raises(ValueError):
        _run(_StubTracker(), chunk=16, windows=1, frames_per_window=8)


def test_refuses_without_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run the benchmark")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BENCH_DEVICE")}
    out = subprocess.run([sys.executable, "bench_torch.py"], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode != 0
    assert '"metric"' not in out.stdout
    assert "BENCH_DEVICE=cpu" in out.stderr


def test_refuses_threaded_staging(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_IO_THREADS", "2")
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    assert bench_torch.main() != 0
    out = capsys.readouterr()
    assert '"metric"' not in out.out
    assert "BENCH_IO_THREADS" in out.err
