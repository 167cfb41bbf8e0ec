"""CPU tests of the readers of the program's own tracing
(slam_bench/program_trace.py and the four metrics that read it): on
made-up runs, spans and runtime records on one clock, a launch or a sync
outside every span not counted; nothing read where the program has no
tracing; a run without trace never switches the program's tracing on; a
small traced CPU run reads the span metrics (the CPU slice has no CUDA
runtime records, so the launch and sync counts stay out).

    python -m pytest slam_bench/tests/test_slam_bench_program_trace.py -q   (~2 min)
"""
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_bench import harness, program_trace  # noqa: E402
from slam_bench.cell import run_cell  # noqa: E402

NEW = ("pose_opt_ms_per_frame", "pose_opt_launches_per_frame", "host_syncs_per_frame",
       "result_hold_ms_p95")
SMALL_LIMITS = {"feat_bits_mean": 3.0, "traj_seg_rmse_m": 0.3, "rot_rpe_deg": 7.0,
                "lost_share": 0.05}


@pytest.fixture
def capture():
    cap = program_trace.CAPTURE
    cap.clear()
    yield cap
    cap.clear()


def _read(name, run):
    return harness.load_metric(name).read(run)


def test_readers_on_a_made_up_run(capture):
    capture.window = (1_000, 2_000)
    capture.slice = (3_000, 4_000)
    capture.snapshot = {"spans": [
        # name, start, end, parent, frame
        ("chunk_frame", 1_050, 1_600, -1, 1),
        ("pose_only_optimize", 1_100, 1_200, 0, 1),
        ("pose_only_optimize", 1_300, 1_500, 0, 1),
        ("pose_only_optimize", 2_500, 2_900, -1, 5),        # after the window: not read
        ("chunk_frame", 3_050, 3_300, -1, 10),
        ("pose_only_optimize", 3_100, 3_200, 4, 10),
        ("chunk_boundary", 3_700, 3_800, -1, 11),
    ], "stamps": [
        (1, "in", 1_010), (1, "pose", 1_600), (1, "out", 1_900),
        (2, "in", 1_020), (2, "pose", 1_700), (2, "out", 1_800),
        (3, "in", 2_100), (3, "pose", 2_200), (3, "out", 9_000),     # handed in after the window
        (10, "in", 3_010), (11, "in", 3_020),
    ]}
    capture.records = [
        ("cudaLaunchKernel", 3_110, 3_120),         # inside pose_only_optimize
        ("cuLaunchKernel", 3_150, 3_160),           # inside, through the driver
        ("cudaLaunchKernel", 3_210, 3_220),         # in the step, outside the optimization
        ("cudaLaunchKernel", 3_600, 3_610),         # outside every span
        ("cudaStreamSynchronize", 3_250, 3_260),    # in the step
        ("cudaMemcpyAsync", 3_270, 3_280),          # not a wait
        ("cudaStreamSynchronize", 3_720, 3_730),    # at the boundary
        ("cudaStreamSynchronize", 3_500, 3_510),    # outside every span
        ("cudaDeviceSynchronize", 3_190, 3_210),    # straddles the optimization's end
    ]
    run = SimpleNamespace(attempted=2)
    assert _read("pose_opt_ms_per_frame", run) == pytest.approx(300 / 1e6 / 2)
    assert _read("pose_opt_launches_per_frame", run) == pytest.approx(2 / 2)
    assert _read("host_syncs_per_frame", run) == pytest.approx(3 / 2)
    assert _read("result_hold_ms_p95", run) == pytest.approx(
        float(np.percentile([300 / 1e6, 100 / 1e6], 95)))


def test_count_inside_merges_overlapping_spans():
    recs = [("x", 5, 6), ("x", 14, 16), ("x", 25, 26), ("x", 9, 12)]
    assert program_trace.count_inside(recs, [(10, 15), (0, 8), (12, 20)]) == 2


def test_nothing_is_read_without_the_program_s_tracing(capture):
    run = SimpleNamespace(attempted=10)
    assert all(_read(n, run) is None for n in NEW)
    # spans but no runtime records (a CPU slice): the counts are not read
    capture.window, capture.slice = (0, 10), (20, 30)
    capture.snapshot = {"spans": [("pose_only_optimize", 21, 22, -1, 3),
                                  ("chunk_frame", 20, 25, -1, 3)],
                        "stamps": [(3, "in", 20)]}
    capture.records = [("aten::mul", 21, 22)]
    assert _read("pose_opt_launches_per_frame", run) is None
    assert _read("host_syncs_per_frame", run) is None


def test_the_tracer_switches_the_program_s_tracing_with_the_window():
    from lpslam_tpu_torch.utils import timing

    t = harness.Tracer({}, {})
    assert isinstance(t, program_trace.ProgramTracer)
    try:
        t.timing = True
        assert timing.ENABLED
        t.timing = False
        assert timing.ENABLED              # on through the CUDA-only slice
        t.recording = True
        t.recording = False
        assert not timing.ENABLED
        cap = program_trace.CAPTURE
        assert cap.window[0] <= cap.window[1] <= cap.slice[0] <= cap.slice[1]
    finally:
        t.remove()
        program_trace.CAPTURE.clear()
    assert not timing.ENABLED


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout-like root whose BENCHMARK.json points the mono cells at a
    160x120, 256-keypoint copy of the configuration."""
    root = tmp_path_factory.mktemp("small")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "lpslam_mono_vga")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    cfg["sensor"]["width"], cfg["sensor"]["height"] = 160, 120
    cfg["tracker"].update(keypoints=256, max_landmarks=4096, max_keyframes=32)
    (root / "cfg.json").write_text(json.dumps(cfg))
    conf["file"] = "cfg.json"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_run_without_trace_never_switches_the_program_s_tracing_on(small_root, monkeypatch):
    from lpslam_tpu_torch.utils import timing

    calls = []
    monkeypatch.setattr(timing, "enable", lambda: calls.append(1))
    torch.set_num_threads(4)
    r = run_cell(small_root, "mono_vga.replay16", 1234, 3.0, False, time.perf_counter(),
                 device="cpu", limits=SMALL_LIMITS)
    assert r["attempted"] > 0 and set(r["metrics"]) == {"tracked_fps", "frame_latency_p95_ms",
                                                        "setup_s"}
    assert calls == [] and not timing.ENABLED


def test_a_traced_cpu_run_reads_the_program_s_spans(small_root):
    from lpslam_tpu_torch.utils import timing

    torch.set_num_threads(4)
    r = run_cell(small_root, "mono_vga.replay16", 1234, 3.0, True, time.perf_counter(),
                 device="cpu", limits=SMALL_LIMITS)
    m = r["metrics"]
    assert m["pose_opt_ms_per_frame"]["value"] > 0
    assert 0 < m["pose_opt_ms_per_frame"]["value"] < m["track_frame_ms_per_frame"]["value"]
    assert m["result_hold_ms_p95"]["value"] > 0
    assert "pose_opt_launches_per_frame" not in m and "host_syncs_per_frame" not in m
    assert "chunk_step_ms_per_frame" in m and "local_ba_ms_per_frame" in m
    assert not timing.ENABLED and timing.snapshot()["spans"] == []
    cap = program_trace.CAPTURE
    assert cap.frames_in(cap.slice) == 48 and cap.records
