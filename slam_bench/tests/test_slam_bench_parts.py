"""CPU tests of the benchmark's parts: discovery by name, the lap's seam,
the metric arithmetic, the reference's plain pieces, the import check.

    python -m pytest slam_bench/tests -q
"""
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_bench import harness, room, trace  # noqa: E402
from slam_bench.reference import compare, orb  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


# -- discovery ----------------------------------------------------------------

@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    bench, w, cfg, traffic = harness.load_cell(ROOT, cell)
    assert cfg["name"] == w["config"]
    assert set(harness.load_limits(cell)) <= set(compare.NUMBERS)
    assert "tracker" in traffic
    for m in harness.cell_metrics(bench, w, trace=False) + harness.cell_metrics(bench, w, True):
        assert callable(harness.load_metric(m["name"]).read)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w, False)}
        layers = harness.cell_metrics(BENCH, w, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_spans_and_calls_resolve(name):
    mod = harness.load_metric(name)
    tracer = harness.Tracer(getattr(mod, "SPANS", {}), getattr(mod, "CALLS", {}))
    tracer.remove()


def test_tracer_restores_what_it_patched():
    from lpslam_tpu_torch.frontend import device_loop, stereo, tracker

    before = (device_loop.track_frame, tracker.MonoTracker.__dict__["process"],
              stereo.StereoTracker.__dict__["process"])
    t = harness.Tracer(harness.LABEL_SPANS | {
        "track_frame": ["lpslam_tpu_torch.frontend.device_loop:track_frame"],
        "engine": ["lpslam_tpu_torch.frontend.tracker:MonoTracker.process",
                   "lpslam_tpu_torch.frontend.stereo:StereoTracker.process"]}, {})
    assert device_loop.track_frame is not before[0]
    t.remove()
    after = (device_loop.track_frame, tracker.MonoTracker.__dict__["process"],
             stereo.StereoTracker.__dict__["process"])
    assert after == before


def test_span_counts_a_reentered_call_once():
    class Owner:
        def f(self, n):
            return self.f(n - 1) + 1 if n else 0

    mod = SimpleNamespace(Owner=Owner)
    sys.modules["_slam_bench_probe"] = mod
    try:
        t = harness.Tracer({"f": ["_slam_bench_probe:Owner.f"]}, {})
        t.timing = True
        assert Owner().f(3) == 3
        assert t.totals["f"][1] == 1
        t.remove()
        assert "f" in Owner.__dict__ and Owner().f(2) == 2
    finally:
        del sys.modules["_slam_bench_probe"]


# -- the lap --------------------------------------------------------------------

def test_the_lap_closes():
    lap = 556
    R0, C0 = room.orbit_pose(0, lap)
    RL, CL = room.orbit_pose(lap, lap)
    np.testing.assert_allclose(RL, R0, atol=1e-12)
    np.testing.assert_allclose(CL, C0, atol=1e-12)
    assert room.photometric(lap, lap) == pytest.approx(room.photometric(0, lap))
    # the seam's step is a step like any other
    def step(a, b):
        (Ra, Ca), (Rb, Cb) = room.orbit_pose(a, lap), room.orbit_pose(b, lap)
        return np.linalg.norm(Cb - Ca), compare.rot_angle_deg(Ra, Rb)

    seam, inner = step(lap - 1, lap), step(0, 1)
    assert seam[0] == pytest.approx(inner[0], rel=0.05)
    assert seam[1] == pytest.approx(inner[1], rel=0.05)


def _small_room(seed=3, dist=(0, 0, 0, 0, 0), noise=1):
    intr = room.camera_intrinsics({"width": 160, "height": 120, "fx_at_640": 380.0,
                                   "dist": list(dist)})
    return room.Room(seed, noise, intr, 556, "cpu"), intr


def test_frame_after_the_lap_is_the_first_frame():
    rm, _ = _small_room()
    a = rm._cast(*[torch.tensor(np.array(x)[None], dtype=torch.float64)
                   for x in room.orbit_pose(0, 556)])
    b = rm._cast(*[torch.tensor(np.array(x)[None], dtype=torch.float64)
                   for x in room.orbit_pose(556, 556)])
    assert torch.equal(a, b)


def test_same_seeds_same_frames_other_seeds_other_frames():
    a = _small_room(5)[0].render([0, 100])
    b = _small_room(5)[0].render([0, 100])
    c = _small_room(6)[0].render([0, 100])
    d = _small_room(5, noise=2)[0].render([0, 100])
    assert a.dtype == np.uint8 and a.shape == (2, 120, 160)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a, d) and np.abs(a.astype(int) - d).mean() < 3


def test_big_seeds_render():
    rm, _ = _small_room(5, noise=2**31 + 12345)
    assert rm.render([7]).shape == (1, 120, 160)


def test_rendering_agrees_with_the_ground_truth_geometry():
    """A room point seen in frame 0 reprojects, through the true poses, onto
    the same texture in frame 34."""
    rm, intr = _small_room()
    fr = rm.render([0, 34]).astype(np.float64)
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
    R0, C0 = room.orbit_pose(0, 556)
    R1, C1 = room.orbit_pose(34, 556)
    ys, xs = np.mgrid[10:110:4, 10:150:4]
    ray = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                    np.ones(xs.shape)], -1).reshape(-1, 3)
    P = C0 + (ray @ R0.T) * room.box_depth(C0, ray @ R0.T)[:, None]
    pc = (P - C1) @ R1
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    ok = (pc[:, 2] > 0) & (uv[:, 0] > 1) & (uv[:, 0] < 158) & (uv[:, 1] > 1) & (uv[:, 1] < 118)
    a = fr[0][ys.reshape(-1)[ok], xs.reshape(-1)[ok]]
    b = fr[1][np.round(uv[ok, 1]).astype(int), np.round(uv[ok, 0]).astype(int)]
    assert ok.sum() > 200 and np.corrcoef(a, b)[0, 1] > 0.8


def test_stereo_eyes_differ_by_the_baseline():
    rm, intr = _small_room()
    both = rm.render([0], eye_offsets=(0.0, 0.11))
    assert both.shape == (1, 2, 120, 160)
    assert not np.array_equal(both[0, 0], both[0, 1])


# -- metric arithmetic --------------------------------------------------------

def test_rate_and_tail():
    run = SimpleNamespace(tracked_in_window=300, window_s=30.0,
                          latencies_s=list(np.arange(1, 101) / 1000.0), setup_s=12.5)
    assert harness.load_metric("tracked_fps").read(run) == 10.0
    assert harness.load_metric("frame_latency_p95_ms").read(run) == pytest.approx(95.05)
    assert harness.load_metric("setup_s").read(run) == 12.5
    assert harness.load_metric("frame_latency_p95_ms").read(
        SimpleNamespace(latencies_s=[])) is None


def test_span_metrics_per_frame():
    spans = {"process_image": (3.0, 100), "process_chunk": (2.0, 7), "engine_process": (0.5, 3),
             "track_frame": (1.2, 100), "local_ba": (0.3, 4), "insert_keyframe": (0.1, 25)}
    run = SimpleNamespace(spans=spans, attempted=100)
    read = lambda n: harness.load_metric(n).read(run)  # noqa: E731
    assert read("pipeline_self_ms_per_frame") == pytest.approx(5.0)
    assert read("chunk_step_ms_per_frame") == pytest.approx(20.0)
    assert read("host_path_ms_per_frame") == pytest.approx(5.0)
    assert read("track_frame_ms_per_frame") == pytest.approx(12.0)
    assert read("local_ba_ms_per_frame") == pytest.approx(3.0)
    assert read("keyframes_per_100_frames") == pytest.approx(25.0)
    none = SimpleNamespace(spans={k: (0.0, 0) for k in spans}, attempted=100)
    assert harness.load_metric("chunk_step_ms_per_frame").read(none) is None


def test_trace_reduction():
    us = 1e6
    ev = [(trace.SLICE, False, 0.0, 1.0 * us),
          ("k1", True, 0.1 * us, 0.3 * us), ("k2", True, 0.2 * us, 0.4 * us),
          ("k1", True, 0.8 * us, 0.9 * us),
          ("track_frame", False, 0.4 * us, 0.8 * us), ("process_image", False, 0.0, 1.0 * us),
          ("track_frame", True, 0.4 * us, 0.8 * us)]      # a range's copy on the GPU row
    t = trace.reduce_events(ev, ["track_frame", "process_image"])
    assert t["window_s"] == pytest.approx(1.0)
    assert t["busy_s"] == pytest.approx(0.4)
    assert t["kernel_s"] == pytest.approx({"k1": 0.3, "k2": 0.2})
    assert t["gaps"] == pytest.approx({"process_image": 0.2, "track_frame": 0.4})
    assert harness.load_metric("device_idle_pct").read(
        SimpleNamespace(trace=None, window_s=30.0, attempted=100)) is None


def test_kernel_names_lose_only_their_argument_list():
    assert trace.without_arguments(
        "void (anonymous namespace)::fast_kernel<false>(float const*, int)") == \
        "void (anonymous namespace)::fast_kernel<false>"
    assert trace.without_arguments("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert trace.without_arguments("sm80_xmma_gemm_f32f32") == "sm80_xmma_gemm_f32f32"


def test_device_time_is_the_union_of_device_intervals():
    us = 1e6
    ev = [("void k1<false>(float const*)", True, 0.1 * us, 0.3 * us),
          ("k2", True, 0.2 * us, 0.4 * us), ("k1", True, 0.8 * us, 0.9 * us),
          ("cudaLaunchKernel", False, 0.05 * us, 0.1 * us)]
    t = trace.device_time(ev, 2.0)
    assert t["window_s"] == 2.0 and t["busy_s"] == pytest.approx(0.4)
    assert t["kernel_s"] == pytest.approx({"void k1<false>": 0.2, "k2": 0.2, "k1": 0.1})
    # 0.4 s busy over 10 traced frames, against a window of 100 frames in 20 s
    run = SimpleNamespace(trace=dict(t, frames=10), window_s=20.0, attempted=100)
    assert harness.load_metric("device_idle_pct").read(run) == pytest.approx(80.0)


def test_tracked_counts_results_returned_inside_the_window():
    ok, lost = SimpleNamespace(valid=True), SimpleNamespace(valid=False)
    frames = [SimpleNamespace(result=r, t_out=t) for r, t in [
        (ok, 0.5),      # returned before the window
        (ok, 1.0),      # a set-up frame whose result came back in the window
        (lost, 1.5), (ok, 2.0), (None, None), (False, 2.5),
        (ok, 3.5)]]     # returned after the window
    assert harness.tracked_between(frames, 1.0, 3.0) == 2


def test_profiler_events_read_the_slice():
    with trace.profiled(cpu=True) as prof:
        with torch.profiler.record_function(trace.SLICE):
            with torch.profiler.record_function("track_frame"):
                for _ in range(50):     # the span fills the slice, so its middle
                    torch.randn(64, 64) @ torch.randn(64, 64)
    t = trace.reduce_events(trace.profiler_events(prof), ["track_frame", trace.SLICE])
    assert t["window_s"] > 0 and t["busy_s"] == 0.0
    assert set(t["gaps"]) <= {"track_frame", "no span"} and "track_frame" in t["gaps"]


def test_roofline_counts():
    from slam_bench import roofline

    img = torch.zeros((2, 40, 50))
    # a flat image: every pixel's blend and NMS, every interior pixel's compass test
    assert roofline.fast_operations(img) == 12 * 2 * 40 * 50 + 20 * 2 * 34 * 44
    q = torch.zeros((3, 8), dtype=torch.int32)
    uv_q = torch.tensor([[0.0, 0.0], [10.0, 0.0], [100.0, 100.0]])
    k = torch.zeros((2, 8), dtype=torch.int32)
    uv_k = torch.tensor([[1.0, 0.0], [50.0, 50.0]])
    v_q, v_k = torch.ones(3, dtype=torch.bool), torch.ones(2, dtype=torch.bool)
    t = roofline.match_projected_bound_s(q, uv_q, v_q, k, uv_k, v_k, 12.0)
    assert t == pytest.approx(max((3 + 2) * 41 + 3 * 9, 0) / roofline.HBM_BYTES_PER_S)


# -- the reference's plain pieces --------------------------------------------

def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3))
    from slam_bench.reference.camera import _rodrigues_mat

    R = _rodrigues_mat([0.2, -0.4, 0.9])
    dst = 2.5 * src @ R.T + [1.0, -2.0, 0.5]
    s, Ra, t = compare.umeyama(src, dst, True)
    assert s == pytest.approx(2.5) and np.allclose(Ra, R) and np.allclose(t, [1.0, -2.0, 0.5])


def test_quaternion_and_frames_invert_the_pipeline_result():
    from lpslam_tpu_torch.geometry.so3 import so3_exp
    from lpslam_tpu_torch.pipeline.trackers import create_tracker_result_pose

    R = so3_exp(torch.tensor([0.3, -0.5, 0.8])).numpy()
    t = np.array([0.1, 0.2, 0.3])
    c, q = create_tracker_result_pose(R, t)
    np.testing.assert_allclose(compare.quat_lp_to_R_wc(q), R.T, atol=1e-6)
    np.testing.assert_allclose(compare.lp_to_optical(c), -R.T @ t, atol=1e-6)


def test_box_depth():
    d = room.box_depth(np.zeros(3), np.array([[1.0, 0, 0], [0, 0, 1.0], [0, 0.5, 1.0]]))
    np.testing.assert_allclose(d, [4.0, 2.5, 2.5])


def test_trajectory_numbers_on_the_truth():
    lap, n = 556, 200
    idx = np.arange(n) + 30
    poses = [room.orbit_pose(i, lap) for i in idx]
    s, t = 0.37, np.array([0.3, 0, 0])
    # the tracker's world: a scaled, shifted copy; results in the lpslam frame
    C = np.stack([p[1] for p in poses]) * s + t
    pos_lp = np.stack([-C[:, 1], C[:, 0], C[:, 2]], 1)
    from lpslam_tpu_torch.pipeline.trackers import create_tracker_result_pose

    quat = np.stack([create_tracker_result_pose(p[0].T, -p[0].T @ c)[1] for p, c in zip(poses, C)])
    frames = {"lap_idx": idx, "tracked": np.ones(n, bool), "position_lp": pos_lp, "quat_lp": quat}
    got = compare.trajectory_numbers(frames, lap, metric=False)
    assert got["lost_share"] == 0.0
    assert got["traj_seg_rmse_m"] < 1e-6 and got["rot_rpe_deg"] < 1e-3
    assert compare.trajectory_numbers(frames, lap, metric=True)["traj_seg_rmse_m"] > 0.1
    frames["tracked"] = np.zeros(n, bool)
    assert math.isinf(compare.trajectory_numbers(frames, lap, False)["traj_seg_rmse_m"])


def _true_map(lap=556, frames=(40, 48, 56), n_kp=60, scale=1.0):
    """A map whose keyframes sit at the true poses and whose landmarks lie on
    the room's faces, scaled by `scale`."""
    K = np.array([[380.0, 0, 320], [0, 380.0, 240], [0, 0, 1]])
    rng = np.random.default_rng(1)
    kf, lm = len(frames), []
    m = {"kf_R": np.zeros((kf, 3, 3), np.float32), "kf_t": np.zeros((kf, 3), np.float32),
         "kf_valid": np.ones(kf, bool), "kf_frame_id": np.array(frames, np.int32),
         "kf_uv": np.zeros((kf, n_kp, 2), np.float32),
         "kf_desc": np.zeros((kf, n_kp, 8), np.int32),
         "kf_kp_valid": np.ones((kf, n_kp), bool), "kf_lm_idx": np.zeros((kf, n_kp), np.int32)}
    for k, f in enumerate(frames):
        R_wc, C = room.orbit_pose(f, lap)
        uv = rng.uniform([40, 40], [600, 440], (n_kp, 2))
        ray = np.c_[uv, np.ones(n_kp)] @ np.linalg.inv(K).T
        P = C + (ray @ R_wc.T) * room.box_depth(C, ray @ R_wc.T)[:, None]
        m["kf_R"][k], m["kf_t"][k] = R_wc.T, -R_wc.T @ C * scale
        m["kf_uv"][k] = uv
        m["kf_lm_idx"][k] = np.arange(n_kp) + len(lm)
        lm.extend(P * scale)
    m["lm_pos"] = np.asarray(lm, np.float32)
    m["lm_valid"] = np.ones(len(lm), bool)
    return m, K


@pytest.mark.parametrize("metric,scale", [(True, 1.0), (False, 0.3)])
def test_map_numbers_on_a_true_map(metric, scale):
    m, K = _true_map(scale=scale)
    got = compare.map_numbers(m, K, np.arange(1000), 556, metric)
    assert got["map_reproj_p90_px"] < 1e-3 and got["kf_rot_rpe_deg"] < 1e-3
    m["lm_pos"] = m["lm_pos"] * 1.2 + 0.05
    bad = compare.map_numbers(m, K, np.arange(1000), 556, metric)
    assert bad["map_reproj_p50_px"] > 1.0 and bad["lm_depth_err_p50"] > 0.01


def test_reference_orb_is_the_plain_path():
    from lpslam_tpu_torch.kernels.orb import OrbParams, extract_orb

    g = torch.Generator().manual_seed(0)
    img = (torch.rand(120, 160, generator=g) * 255).round()
    a = orb.extract_orb(img, orb.Orb(num_keypoints=256))
    b = extract_orb(img, OrbParams(num_keypoints=256, num_levels=3))
    assert torch.equal(a.xy, b.xy) and torch.equal(a.desc, b.desc)
    assert torch.equal(a.valid, b.valid)


def test_feature_numbers_count_missing_and_differing():
    rm, intr = _small_room(dist=(-0.28, 0.07, 1e-4, -1e-4, 0.0))
    raw = rm.render([5])
    K, grid = compare.reference_camera(intr, "mono", 0.0)
    from slam_bench.reference import camera

    p = orb.Orb(num_keypoints=256)
    f = orb.extract_orb(camera.remap_bilinear(torch.from_numpy(raw[0].astype(np.float32)),
                                              torch.from_numpy(grid)), p)
    m = {"kf_valid": np.array([True]), "kf_frame_id": np.array([9]),
         "kf_uv": f.xy.numpy()[None], "kf_desc": f.desc.numpy()[None],
         "kf_kp_valid": f.valid.numpy()[None]}
    lap_of = np.array([0] * 9 + [5])
    got = compare.feature_numbers(m, lambda i: raw[0], grid, p, lap_of, {9}, seed=1)
    assert got == {"feat_bits_mean": 0.0, "feat_missing_share": 0.0, "desc_bits_mean": 0.0}
    m["kf_desc"] = m["kf_desc"].copy()
    m["kf_desc"][..., 0] ^= 1
    got = compare.feature_numbers(m, lambda i: raw[0], grid, p, lap_of, {9}, seed=1)
    assert got == {"feat_bits_mean": 1.0, "feat_missing_share": 0.0, "desc_bits_mean": 1.0}
    m["kf_kp_valid"] = m["kf_kp_valid"] & (np.arange(256) % 2 == 0)
    got = compare.feature_numbers(m, lambda i: raw[0], grid, p, lap_of, {9}, seed=1)
    assert got["feat_missing_share"] == pytest.approx(0.5, abs=0.05)
    assert got["feat_bits_mean"] == pytest.approx(
        got["feat_missing_share"] * 256 + (1 - got["feat_missing_share"]) * got["desc_bits_mean"])


def test_stereo_reference_rectification_keeps_the_eyes_parallel():
    intr = room.camera_intrinsics({"width": 752, "height": 480, "fx_at_640": 380.0,
                                   "dist": [-0.28, 0.07, 1e-4, -1e-4, 0.0]})
    K, grid = compare.reference_camera(intr, "stereo", 0.11)
    from lpslam_tpu_torch.geometry.camera import rectify_maps_stereo

    Kr = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1.0]])
    ref = rectify_maps_stereo(Kr, np.array(intr["dist"]), Kr, np.array(intr["dist"]), np.eye(3),
                              np.array([-0.11, 0, 0]), (480, 752))
    np.testing.assert_array_equal(grid, ref["map_l"])
    np.testing.assert_array_equal(K, ref["K_new"].astype(np.float64))


# -- the import check ---------------------------------------------------------

def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "lpslam_tpu_torch_probe", SimpleNamespace())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lpslam_tpu.io", SimpleNamespace())
    monkeypatch.setitem(sys.modules, "jax.numpy", SimpleNamespace())
    assert harness.forbidden_modules() == ["jax", "lpslam_tpu"]


def test_the_harness_loads_no_jax():
    """A fresh process that imports every module of the benchmark and the
    program's modules the window drives loads no JAX and no JAX package."""
    import subprocess

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import slam_bench.harness as h, slam_bench.cell, slam_bench.calibrate\n"
            "import slam_bench.run, slam_bench.roofline, slam_bench.trace\n"
            "import lpslam_tpu_torch.pipeline.trackers, lpslam_tpu_torch.frontend.device_loop\n"
            "import lpslam_tpu_torch.eval.run_dataset, lpslam_tpu_torch.backend.ba\n"
            "for n in [m['name'] for m in h.read_json(h.BENCH_DIR.parent / 'BENCHMARK.json')"
            "['per_layer'] + h.read_json(h.BENCH_DIR.parent / 'BENCHMARK.json')['end_to_end']]:\n"
            "    h.load_metric(n)\n"
            "print(h.forbidden_modules())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
