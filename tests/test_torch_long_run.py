"""Port parity, long runs: the chunk loop against a small store over two
cycles of a looping orbit, in lpslam_tpu and lpslam_tpu_torch on the same
frames, and the check logic of tools/soak_torch_long_run.py.

The long-run test is tests/test_long_run.py's (slow-marked there) at a
length that fits tier-1: 400 frames, two cycles of its period-200 orbit,
against a 16-keyframe store at 240x320 with 192 keypoints. Both packages
hold the capacity at every chunk boundary and still insert keyframes in the
final tenth; the port tracks within 4 frames of JAX's count, its keyframe
count at every chunk boundary lies within 2 of JAX's, and its keyframes
inserted over the run within 10% of JAX's (the two round differently, so
keyframe decisions near the threshold may fall a chunk apart).
"""
import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import soak_torch_long_run as soak  # noqa: E402

torch.set_num_threads(1)

N_FRAMES = 400
CHUNK = 16
PERIOD = 200
K = 16


@pytest.fixture(scope="module")
def orbit():
    """The looping orbit's frames (the port's numpy renderer)."""
    from lpslam_tpu_torch.geometry.se3 import se3_exp
    from lpslam_tpu_torch.io.synthetic import make_sequence

    poses = []
    for t in range(N_FRAMES):
        tt = (t % PERIOD) / (PERIOD - 1)
        xi = np.array([0.6 * np.sin(2 * np.pi * tt), 0.3 * (1 - np.cos(2 * np.pi * tt)),
                       0.35 * np.sin(np.pi * tt), 0.04 * np.sin(2 * np.pi * tt),
                       0.06 * np.sin(2 * np.pi * tt), 0.03 * tt], np.float32)
        poses.append(se3_exp(torch.from_numpy(xi)))
    return make_sequence(num_frames=N_FRAMES, h=240, w=320, seed=3, fx=230.0, poses=poses)


def _long_run(pkg, seq):
    if pkg == "jax":
        from lpslam_tpu.frontend import MonoTracker, TrackerConfig, TrackerStatus
        from lpslam_tpu.frontend.device_loop import ChunkedTracker
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.kernels.orb import OrbParams
        from lpslam_tpu.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
        kw = {}
    else:
        from lpslam_tpu_torch.frontend import MonoTracker, TrackerConfig, TrackerStatus
        from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
        from lpslam_tpu_torch.geometry import PinholeCamera
        from lpslam_tpu_torch.kernels.orb import OrbParams
        from lpslam_tpu_torch.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                 device="cpu")
        kw = {"device": "cpu"}
    cfg = TrackerConfig(orb=OrbParams(num_keypoints=192, num_levels=2),
                        map_cfg=MapConfig(max_keyframes=K, max_landmarks=2048,
                                          num_keypoints=192))
    eng = MonoTracker(cam, cfg, **kw)
    t = 0
    while eng.status != TrackerStatus.TRACKING and t < 40:
        eng.process(seq.images[t])
        t += 1
    assert eng.status == TrackerStatus.TRACKING
    ct = ChunkedTracker(eng)
    n_kf_trace = []
    while t + CHUNK <= N_FRAMES:
        ct.process_chunk(np.stack(seq.images[t:t + CHUNK]))
        t += CHUNK
        n_kf_trace.append(int(eng.map.n_kf))  # after the boundary compaction
    ct.sync()
    sts, _, _, _, kf_ins, _, _ = ct.drain()
    return {"n_kf_trace": n_kf_trace, "n_lm": int(eng.map.n_lm),
            "max_landmarks": cfg.map_cfg.max_landmarks,
            "tracked": int((sts == int(TrackerStatus.TRACKING)).sum()), "frames": len(sts),
            "kf_ins": np.asarray(kf_ins), "compactions": eng.drain_compactions()}


def test_chunked_long_run_capacity_and_insertion_matches_jax(orbit):
    ref = _long_run("jax", orbit)
    ours = _long_run("torch", orbit)
    for r in (ref, ours):
        # capacity held at every boundary, not just the end
        assert max(r["n_kf_trace"]) < K, r["n_kf_trace"]
        assert r["n_lm"] < r["max_landmarks"]
        assert r["tracked"] / r["frames"] > 0.95, r["tracked"]
        # insertion never starved: keyframes still created in the last tenth,
        # and far more inserted than the store holds (culling recycled slots)
        kf_ins = r["kf_ins"]
        assert kf_ins[-len(kf_ins) // 10:].sum() >= 1
        assert kf_ins.sum() > 2 * K, int(kf_ins.sum())
        ko, nk = r["compactions"][-1]
        assert nk <= K and np.asarray(ko).shape == (K,)
    assert ours["frames"] == ref["frames"]
    assert abs(ours["tracked"] - ref["tracked"]) <= 4, (ours["tracked"], ref["tracked"])
    diff = np.abs(np.subtract(ours["n_kf_trace"], ref["n_kf_trace"]))
    assert diff.max() <= 2, (ours["n_kf_trace"], ref["n_kf_trace"])
    assert abs(int(ours["kf_ins"].sum()) - int(ref["kf_ins"].sum())) <= 0.1 * ref["kf_ins"].sum()


def _summary(**kw):
    base = {"nan_poses": 0, "map_finite": True, "occupancy": [{"frame": 128}],
            "max_keyframes_seen": 100, "max_landmarks_seen": 14000, "tracked_frac": 0.99,
            "fps_first_quartile": 10.0, "fps_last_quartile": 9.0}
    return {**base, **kw}


def test_soak_check_logic():
    # quartiles: a quarter of the windows each, at least one
    assert soak.quartile_fps([4.0, 8.0, 1.0, 1.0, 2.0, 6.0, 1.0, 3.0]) == (6.0, 2.0)
    assert soak.quartile_fps([5.0, 7.0, 9.0]) == (5.0, 9.0)
    assert all(soak.soak_checks(_summary()).values())
    # capacity: strictly under it at every sample, and at least one sample
    assert soak.soak_checks(_summary(max_keyframes_seen=127))["capacity_held"]
    assert not soak.soak_checks(_summary(max_keyframes_seen=128))["capacity_held"]
    assert not soak.soak_checks(_summary(max_landmarks_seen=24576))["capacity_held"]
    assert not soak.soak_checks(_summary(occupancy=[]))["capacity_held"]
    assert soak.soak_checks(_summary(tracked_frac=0.95))["tracked_frac_ge_095"]
    assert not soak.soak_checks(_summary(tracked_frac=0.9499))["tracked_frac_ge_095"]
    assert soak.soak_checks(_summary(fps_last_quartile=7.0))["fps_stable"]
    assert not soak.soak_checks(_summary(fps_last_quartile=6.99))["fps_stable"]
    assert not soak.soak_checks(_summary(nan_poses=1))["no_nan_poses"]
    # JAX's soak: the tracked fraction within 0.02 of its 2045 / 2048 (0.99854)
    ref = soak.JAX_SOAK_REF
    assert "tracked_within_002_of_jax" not in soak.soak_checks(_summary())
    assert soak.soak_checks(_summary(tracked_frac=0.979), ref)["tracked_within_002_of_jax"]
    assert not soak.soak_checks(_summary(tracked_frac=0.978), ref)["tracked_within_002_of_jax"]
    assert soak.soak_checks(_summary(tracked_frac=1.0), ref)["tracked_within_002_of_jax"]
    # the reference holds only at its own configuration
    assert soak.jax_reference(soak.parser().parse_args([])) is ref
    for other in (["--frames", "1024"], ["--width", "320"], ["--keypoints", "600"]):
        assert soak.jax_reference(soak.parser().parse_args(other)) is None
    # the maps compared part by part, bit for bit
    a = {"kf_t": np.float32([1.0, 2.0]).tobytes(), "closures": "[[5, 1, 40]]"}
    b = {"kf_t": np.float32([1.0, np.nextafter(2.0, 3.0, dtype=np.float32)]).tobytes(),
         "closures": "[[5, 1, 40]]"}
    assert soak.maps_equal(a, dict(a)) == {"kf_t": True, "closures": True}
    assert soak.maps_equal(a, b) == {"kf_t": False, "closures": True}


def test_soak_tool_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = soak.main(["--device", "cpu", "--frames", "48", "--width", "160", "--height",
                        "120", "--keypoints", "256", "--window", "16"])
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    assert r["platform"] == "cpu" and r["frames"] == 48
    assert [o["frame"] for o in r["occupancy"]] == [16, 32, 48]
    assert len(r["fps_windows"]) == 3 and len(r["drives"]) == 2
    # two drives on the CPU leave the same map, and the checks read the run
    assert r["maps_equal"] == [{"kf_R": True, "kf_t": True, "lm_pos": True, "closures": True}]
    assert r["checks"]["drives_maps_equal"]
    assert r["checks"]["no_nan_poses"] and r["checks"]["map_finite"]
    assert r["checks"]["capacity_held"]
    assert r["jax_ref"] is None   # no JAX reference at this size
    assert r["checks"] == {**soak.soak_checks(r), "drives_maps_equal": True}
    assert rc == (0 if r["ok"] else 1)
