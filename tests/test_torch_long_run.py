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

The port's chunk loop past the landmark store's wall (max_landmarks less a
keyframe's keypoints, where the JAX scan stops inserting keyframes for
good), held against the port's host path (MonoTracker.process, which has no
such gate) on the same frames against a 400-landmark store: both reach the
wall in the first quarter of their keyframes; the loop's keyframes inserted
by every 16th frame lie within 2 of the host path's and over the run within
10%; past the wall both make landmarks in every quarter of their keyframes,
the loop at over half the host path's rate a keyframe (its in-loop BA runs
at most every 8th frame, the host path's on every keyframe); at every 16th
frame both stores are compacted (slots filled from the front, associations
below the landmark count, no landmark unobserved).

track_frame's local cap on a made-up map, against a numpy ranking of the
same map: the slots it matches are the reference's, in order. When more
landmarks pass the visibility test (in front, u, v >= 0) than the cap
holds, every one inside the frame is among them, where the JAX order (by
found ratio) takes the ones off the frame and none inside it; below the
cap the two orders are the same.
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



def _map_checks(m):
    """A compacted store: keyframe and landmark slots filled from the
    front, every keyframe association below n_lm, every landmark there
    observed by some keyframe."""
    n_kf, n_lm = int(m.n_kf), int(m.n_lm)
    idx = m.kf_lm_idx.numpy()[:n_kf][m.kf_kp_valid.numpy()[:n_kf]]
    idx = idx[idx >= 0]
    return {"kf_prefix": bool(np.array_equal(m.kf_valid.numpy(), np.arange(K) < n_kf)),
            "lm_prefix": bool(np.array_equal(m.lm_valid.numpy(),
                                              np.arange(m.lm_valid.shape[0]) < n_lm)),
            "assoc_below_n_lm": bool((idx < n_lm).all()),
            "no_orphans": bool((np.bincount(idx, minlength=n_lm)[:n_lm] > 0).all())}


def _wall_run(seq, path):
    """The port's mono tracker on the orbit against a 400-landmark store,
    after the host path's initialization: the chunk loop, or the host path
    (MonoTracker.process) frame by frame. Records each frame's keyframe
    insertion, the landmarks each keyframe made beside the count before it,
    and the store's checks at every 16th frame."""
    from lpslam_tpu_torch.frontend import tracker

    made, triangulate = [], tracker.triangulate_new_landmarks

    def counted(m, cam, cfg):
        out = triangulate(m, cam, cfg)
        made.append((int(out.n_lm) - int(m.n_lm), int(m.n_lm)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracker, "triangulate_new_landmarks", counted)
        return _drive_at_the_wall(seq, path, made)


def _drive_at_the_wall(seq, path, made):
    from lpslam_tpu_torch.frontend import MonoTracker, TrackerConfig, TrackerStatus
    from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
    from lpslam_tpu_torch.geometry import PinholeCamera
    from lpslam_tpu_torch.kernels.orb import OrbParams
    from lpslam_tpu_torch.mapstore import MapConfig

    cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], device="cpu")
    cfg = TrackerConfig(orb=OrbParams(num_keypoints=192, num_levels=2),
                        map_cfg=MapConfig(max_keyframes=K, max_landmarks=WALL_STORE,
                                          num_keypoints=192))
    eng = MonoTracker(cam, cfg, device="cpu")
    t = 0
    while eng.status != TrackerStatus.TRACKING and t < 40:
        eng.process(seq.images[t])
        t += 1
    del made[:]
    checks, kf_ins, sts = [], [], []
    ct = ChunkedTracker(eng) if path == "chunk" else None
    while t + CHUNK <= N_FRAMES:
        if ct is not None:
            ct.process_chunk(np.stack(seq.images[t:t + CHUNK]))
        else:
            for i in range(CHUNK):
                last = eng.last_kf_frame
                sts.append(int(eng.process(seq.images[t + i])[0]))
                kf_ins.append(eng.last_kf_frame != last)
            eng._adopt_pending_map()
        t += CHUNK
        checks.append(_map_checks(eng.map))
    if ct is not None:
        ct.sync()
        sts, _, _, _, kf_ins, _, _ = ct.drain()
    return {"kf_ins": np.asarray(kf_ins), "made": np.array(made),
            "tracked": int((np.asarray(sts) == int(TrackerStatus.TRACKING)).sum()),
            "frames": len(sts), "checks": checks, "n_kf": int(eng.map.n_kf)}


WALL_STORE = 400


def test_chunked_long_run_keeps_inserting_at_the_landmark_wall(orbit):
    ref = _wall_run(orbit, "host")
    ours = _wall_run(orbit, "chunk")
    wall = WALL_STORE - 192      # the JAX scan inserts no keyframe from here on
    assert ours["frames"] == ref["frames"]
    after = {}
    for r in (ref, ours):
        assert all(all(c.values()) for c in r["checks"]), r["checks"]
        assert r["n_kf"] < K and r["tracked"] / r["frames"] > 0.95, r["tracked"]
        made, n_before = r["made"].T
        at_wall = np.flatnonzero(n_before >= wall)
        assert at_wall.size and at_wall[0] < len(made) // 4, n_before.tolist()
        after[id(r)] = made[at_wall[0]:]
        # landmarks made throughout, in each quarter of the keyframes past the wall
        assert all(q.sum() > 0 for q in np.array_split(after[id(r)], 4)), made.tolist()
    # the keyframes inserted by each 16th frame within 2 of the host path's
    # count, and over the run within 10%, as the JAX long run holds the port
    per_chunk = [r["kf_ins"].reshape(-1, CHUNK).sum(1).cumsum() for r in (ours, ref)]
    assert np.abs(per_chunk[0] - per_chunk[1]).max() <= 2, per_chunk
    assert abs(int(ours["kf_ins"].sum()) - int(ref["kf_ins"].sum())) <= 0.1 * ref["kf_ins"].sum()
    # past the wall the loop makes landmarks at over half the host path's rate
    # a keyframe (its in-loop BA runs at most every 8th frame, the host's on
    # every keyframe)
    assert after[id(ours)].mean() > 0.5 * after[id(ref)].mean(), \
        (after[id(ours)].mean(), after[id(ref)].mean())


def _ranked_slots(pos, valid, n_found, n_visible, cam, cap, image_hw=None):
    """track_frame's local-cap selection in numpy, at the identity pose: the
    slots of the `cap` best scores, ties to the lowest slot. Visible
    (in front, u, v >= 0) ranks first; with image_hw and more visible
    landmarks than the cap, visible ones inside the frame rank above the
    rest. image_hw=None is the JAX package's order."""
    fx, fy, cx, cy = cam
    z = pos[:, 2]
    zs = np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    u = fx * pos[:, 0] / zs + cx
    v = fy * pos[:, 1] / zs + cy
    vis = valid & (z > 1e-3) & (u >= 0) & (v >= 0)
    score = vis.astype(np.float32) * np.float32(2.0) + (
        n_found.astype(np.float32) / (n_visible.astype(np.float32) + np.float32(1.0)))
    if image_hw is not None and vis.sum() > cap:
        in_view = vis & (u < image_hw[1]) & (v < image_hw[0])
        score = score + in_view.astype(np.float32)
    return np.argsort(-score, kind="stable")[:cap]


@pytest.mark.parametrize("over_cap", [True, False])
def test_track_frame_ranks_landmarks_in_view_first_at_the_cap(over_cap, monkeypatch):
    from lpslam_tpu_torch.frontend import tracker
    from lpslam_tpu_torch.geometry import PinholeCamera
    from lpslam_tpu_torch.geometry.se3 import se3_identity
    from lpslam_tpu_torch.kernels.orb import OrbFeatures
    from lpslam_tpu_torch.mapstore import MapConfig
    from lpslam_tpu_torch.mapstore.store import empty_map

    rng = np.random.default_rng(5)
    h, w, P = 240, 320, 512
    # in the frame, off its right edge, off its bottom edge, left of it (not
    # visible), behind the camera (not visible); the rest of the store empty
    groups = {"in": 150, "right": 150, "bottom": 100, "left": 40, "behind": 20}
    u = np.concatenate([rng.uniform(20, w - 20, 150), rng.uniform(w + 80, 2 * w, 150),
                        rng.uniform(20, w - 20, 100), rng.uniform(-w, -80, 40),
                        rng.uniform(20, w - 20, 20)])
    v = np.concatenate([rng.uniform(20, h - 20, 150), rng.uniform(20, h - 20, 150),
                        rng.uniform(h + 60, 2 * h, 100), rng.uniform(20, h - 20, 60)])
    n = sum(groups.values())
    z = np.where(np.arange(n) < n - 20, rng.uniform(3.0, 6.0, n), -4.0)
    cam = PinholeCamera.make(300.0, 300.0, 160.0, 120.0, device="cpu")
    pos = np.zeros((P, 3), np.float32)
    pos[:n] = np.stack([(u - 160.0) * z / 300.0, (v - 120.0) * z / 300.0, z], 1)
    valid = np.arange(P) < n
    valid[rng.choice(n, 12, replace=False)] = False
    # the landmarks in the frame were found less often than the others
    n_visible = np.where(valid, 10, 0).astype(np.int32)
    n_found = np.where(np.arange(P) < 150, rng.integers(0, 4, P),
                       rng.integers(4, 11, P)).astype(np.int32) * valid
    desc = rng.integers(-2**31, 2**31, (P, 8), dtype=np.int64).astype(np.int32)
    m = empty_map(MapConfig(4, P, 256), "cpu")
    m = m._replace(lm_pos=torch.from_numpy(pos), lm_desc=torch.from_numpy(desc),
                   lm_valid=torch.from_numpy(valid), lm_n_visible=torch.from_numpy(n_visible),
                   lm_n_found=torch.from_numpy(n_found), n_lm=torch.tensor(n, dtype=torch.int32))
    # a keypoint on each landmark in the frame, with its descriptor
    kp = 256
    xy = np.zeros((kp, 2), np.float32)
    xy[:150] = np.stack([u[:150], v[:150]], 1)
    kd = np.zeros((kp, 8), np.int32)
    kd[:150] = desc[:150]
    feats = OrbFeatures(xy=torch.from_numpy(xy), level=torch.zeros(kp, dtype=torch.int32),
                        angle=torch.zeros(kp), score=torch.ones(kp), desc=torch.from_numpy(kd),
                        valid=torch.arange(kp) < 150)

    n_vis = int((valid[:n] & (z > 0) & (u >= 0) & (v >= 0)).sum())
    cap = 200 if over_cap else n_vis + 30
    assert (n_vis > cap) == over_cap
    picked, stable = [], tracker.topk_stable

    def topk(score, k):
        out = stable(score, k)
        picked.append(out[1].numpy())
        return out

    monkeypatch.setattr(tracker, "topk_stable", topk)
    res = tracker.track_frame(m, se3_identity("cpu"), cam, feats, 25.0, 80, local_cap=cap,
                              image_hw=(h, w))
    ref = (pos, valid, n_found, n_visible, (300.0, 300.0, 160.0, 120.0), cap)
    want = _ranked_slots(*ref, image_hw=(h, w))
    jax_order = _ranked_slots(*ref)
    in_frame = np.arange(P) < 150
    in_frame[~valid] = False
    assert len(picked) == 1
    np.testing.assert_array_equal(picked[0], want)
    if over_cap:
        # every landmark in the frame, then the best of the rest; the JAX
        # order takes the off-frame ones found more often and none in the frame
        assert set(np.flatnonzero(in_frame)) <= set(want.tolist())
        assert not in_frame[jax_order].any()
        assert int(res.n_inliers) >= 120
    else:
        np.testing.assert_array_equal(want, jax_order)
        assert int(res.n_inliers) >= 120


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
