"""Port parity, the loop-closing slice: the pipeline tracker
(pipeline/trackers.py::VSLAMTracker) in lpslam_tpu and lpslam_tpu_torch on
the same closed 120x160 orbit, through the chunked path with loop closure
and the shipped vocabulary.

The 48-frame toy orbit has few keyframes in revisited territory, so both
trackers get the relaxed gates of tests/test_loop_e2e.py (min_gap 6,
min_score 0.12, consistency 1), patched into `_loop_cfg` identically.
Margins: at least one accepted closure, on the same (k_new, candidate) pair
within +-1; keyframes within +-1; tracked frames within 1; Sim3 ATE
<= max(1.5 x JAX, JAX + 0.02 m).

Also the asynchronous loop worker (a verdict in flight is remapped through
a compaction that lands meanwhile, or dropped when a party was culled;
flush() lands every verdict), the one option that stays refused
(`brief_mode`), the ten options the pipeline slice ported (each held to the
JAX package's option on the same input: exact masks, occupancy grids, laser
buffers, emitted features, loaded maps; reseeded poses within 1e-6), and the
TrackerResult pose conversion.
"""
import threading

import numpy as np
import pytest
import torch

from lpslam_tpu.eval import ate_rmse
from lpslam_tpu.io.synthetic import make_sequence

from lpslam_tpu_torch.geometry import PinholeCamera as TCam
from lpslam_tpu_torch.loop.detector import LoopResult, LoopVerdict
from lpslam_tpu_torch.pipeline import ConfigError, VSLAMTracker
from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
from lpslam_tpu_torch.pipeline.trackers import _NOT_PORTED

import chip_smoke

torch.set_num_threads(1)

CONFIG = {"mode": "mono", "keypoints": 256, "levels": 2, "max_keyframes": 16,
          "max_landmarks": 2048, "loop_closure": True, "loop_async": False,
          "chunk_size": 8, "loop_global_ba_iters": 2}


def _run(pkg, seq, config=CONFIG):
    if pkg == "jax":
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.loop.detector import LoopCloser, LoopConfig
        from lpslam_tpu.pipeline.queues import CameraQueueEntry as Entry
        from lpslam_tpu.pipeline.trackers import VSLAMTracker as Tracker

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
        tr = Tracker(cam, dict(config))
    else:
        from lpslam_tpu_torch.loop.detector import LoopCloser, LoopConfig

        Entry = CameraQueueEntry
        cam = TCam.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2], device="cpu")
        tr = VSLAMTracker(cam, dict(config), device="cpu")
    tr._loop_cfg = lambda: LoopConfig(min_gap=6, min_score=0.12, consistency=1,
                                      global_ba_iters=config["loop_global_ba_iters"])
    verdicts, undo = chip_smoke.record_closures(LoopCloser)
    try:
        for t, img in enumerate(seq.images):
            tr.process_image(Entry(timestamp=t / 20.0, image=img))
        tr.flush()
    finally:
        undo()
        tr.stop()
    est, gt = [], []
    for fid, pose, _ in tr.engine.trajectory:
        if pose is not None:
            est.append(-np.asarray(pose.R).T @ np.asarray(pose.t))
            gt.append(np.asarray(seq.poses_wc[fid].t))
    m = tr.engine.map
    return {
        "closures": [v[:2] for v in verdicts if v[4]],
        "tracked": len(est),
        "keyframes": tr.engine.n_keyframes,
        "ate": ate_rmse(np.asarray(est), np.asarray(gt))[0],
        "state": tr.engine.status.name,
        "finite": bool(np.isfinite(np.asarray(m.kf_t)).all()
                       and np.isfinite(np.asarray(m.lm_pos)).all()),
        "tracker": tr,
    }


@pytest.fixture(scope="module")
def orbit():
    return make_sequence(num_frames=48, h=120, w=160, seed=1, motion="orbit", fx=115.0)


def test_loop_slice_matches_jax(orbit):
    ref = _run("jax", orbit)
    ours = _run("torch", orbit)
    assert ref["closures"], ref                 # the reference closes here
    assert ours["closures"], ours
    assert any(abs(a - c) <= 1 and abs(b - d) <= 1
               for a, b in ours["closures"] for c, d in ref["closures"]), (ours, ref)
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert ours["tracked"] >= ref["tracked"] - 1, (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)
    assert ours["state"] == ref["state"] == "TRACKING"
    assert ours["finite"]


def test_async_loop_worker_closes_and_flush_lands_every_verdict(orbit):
    res = _run("torch", orbit, dict(CONFIG, loop_async=True))
    tr = res["tracker"]
    assert res["closures"], res
    assert res["finite"] and res["state"] == "TRACKING"
    assert not tr._loop_verdicts and tr._loop_perm_log == []
    assert tr._loop_exec is None                # stop() released the worker


class _StubCloser:
    """verify() waits for `gate`, so its verdict is in flight while the test
    lands a compaction."""

    def __init__(self, cand=2):
        self.gate = threading.Event()
        self.cand = cand
        self.applied, self.remapped = [], []

    def add_keyframe(self, m, k):
        pass

    def verify(self, m, k):
        assert self.gate.wait(30)
        return LoopVerdict(LoopResult(True, self.cand, 50, 20), k, object())

    def remap(self, order, n_kf):
        self.remapped.append((list(order), n_kf))

    def apply(self, m, verdict, cam=None):
        self.applied.append(verdict)
        return m, verdict.result


def _bare_tracker():
    cam = TCam.make(230.0, 230.0, 160.0, 120.0, device="cpu")
    tr = VSLAMTracker(cam, {"mode": "mono", "keypoints": 64, "max_keyframes": 8,
                            "max_landmarks": 256, "loop_closure": True}, device="cpu")
    tr._loop_resync_pose = lambda: None
    tr.loop_closer = _StubCloser()
    return tr


@pytest.mark.parametrize("order,n_after,want", [
    # old slots [0,2,3,5,6,7] survive in that order: 7 -> 5, 6 -> 4, 2 -> 1
    ([0, 2, 3, 5, 6, 7, 1, 4], 6, [(5, 1), (4, 1)]),
    # slot 2 (the candidate) was culled: both verdicts are dropped
    ([0, 1, 3, 4, 5, 6, 7, 2], 7, []),
])
def test_verdict_in_flight_through_compaction(order, n_after, want):
    tr = _bare_tracker()
    stub = tr.loop_closer
    tr._loop_submit(7)
    tr._loop_submit(6)
    # a compaction lands while both verifications are in flight
    tr.engine._compactions.append((np.array(order), n_after))
    tr._sync_compactions()
    assert len(tr._loop_perm_log) == 1
    stub.gate.set()
    tr.flush()
    assert stub.remapped == [(order, n_after)]
    # flush landed both verdicts, in order, with remapped slots
    assert [(v.k_new, v.result.candidate) for v in stub.applied] == want
    assert not tr._loop_verdicts and tr._loop_perm_log == []
    tr.stop()
    assert tr._loop_exec is None


def test_verdict_epoch_skips_perms_seen_before_submission():
    tr = _bare_tracker()
    stub = tr.loop_closer
    tr._loop_perm_log = [(np.array([1, 2, 3]), 3),   # before the verdict
                         (np.array([0, 2, 1]), 3)]   # after it
    v = LoopVerdict(LoopResult(True, 1, 50, 20), 2, object())
    assert tr._loop_apply(v, epoch=1) is True
    assert (stub.applied[0].k_new, stub.applied[0].result.candidate) == (1, 2)


@pytest.mark.parametrize("name", sorted(_NOT_PORTED))
def test_options_of_later_slices_refuse(name):
    default = VSLAMTracker.schema.defaults()[name]
    if isinstance(default, bool):
        value = not default
    elif isinstance(default, float):
        value = default + 1.0
    else:
        value = "x"
    cam = TCam.make(100.0, 100.0, 80.0, 60.0, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        VSLAMTracker(cam, {name: value}, device="cpu")


# the ten options the pipeline slice ported, each checked against the JAX
# package's option on the same input
PORTED_OPTIONS = ("emit_map_seconds", "map_file", "mapping", "mask_image", "mask_radius",
                  "max_laser_age", "occupancy_cell_size", "relocalize_with_nav_data",
                  "time_to_relocalize", "wait_for_navigation_data")


def _lost_stub(pkg):
    """An engine stuck LOST that records nothing (for the nav reseeding)."""
    from test_torch_pipeline_tracker import _Stub

    if pkg == "jax":
        import jax.numpy as jnp
        from lpslam_tpu.frontend.tracker import TrackerStatus
        from lpslam_tpu.geometry.se3 import SE3

        return _Stub(TrackerStatus.LOST, SE3(jnp.eye(3), jnp.zeros(3)))
    from lpslam_tpu_torch.frontend.tracker import TrackerStatus
    from lpslam_tpu_torch.geometry.se3 import se3_identity

    stub = _Stub(TrackerStatus.LOST, se3_identity("cpu"))
    stub.device = torch.device("cpu")
    return stub


def _reseed_run(tr, pkg, times):
    """Frames at `times` (s) with an odometry state, on a LOST stub engine;
    returns the engine pose after each frame (numpy) and whether it moved."""
    from lpslam_tpu.pipeline.queues import CameraQueueEntry as JEntry

    tr.engine = _lost_stub(pkg)
    Entry = JEntry if pkg == "jax" else CameraQueueEntry
    nav = (np.array([0.4, -0.2, 1.5]), np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]]))
    out = []
    for ts in times:
        tr.process_image(Entry(timestamp=ts, image=np.zeros((12, 16), np.float32)),
                         nav_odom=nav)
        out.append((np.asarray(tr.engine.pose.R).copy(), np.asarray(tr.engine.pose.t).copy()))
    return out


@pytest.mark.parametrize("name", PORTED_OPTIONS)
def test_ported_option_matches_jax(name, tmp_path):
    import test_torch_pipeline_tracker as tpt
    from lpslam_tpu.pipeline.trackers import LaserScan as JScan
    from lpslam_tpu_torch.convert import map_from_numpy, map_to_numpy
    from lpslam_tpu_torch.io.png import write_png
    from lpslam_tpu_torch.pipeline.trackers import LaserScan

    seq = make_sequence(num_frames=1, h=120, w=160, seed=1, fx=115.0)
    cfg = dict(tpt.BASE)
    d = tpt.small_map_numpy(seed=7)
    if name == "map_file":
        path = str(tmp_path / "m.npz")
        jt, _ = tpt.make_trackers(seq, cfg)
        jt.engine.map = tpt.jax_map(d)
        jt.cfg["map_file"] = path
        jt.stop()                                  # the JAX package writes it
        cfg[name] = path
    elif name == "mask_image":
        m = np.zeros((30, 40), np.uint8)
        m[3:25, 5:33] = 7
        cfg[name] = str(tmp_path / "mask.png")
        write_png(cfg[name], m)
    else:
        cfg[name] = {"emit_map_seconds": 0.5, "mapping": False, "mask_radius": 50.0,
                     "max_laser_age": 0.25, "occupancy_cell_size": 0.3,
                     "relocalize_with_nav_data": True, "time_to_relocalize": 0.5,
                     "wait_for_navigation_data": True}[name]
    if name == "time_to_relocalize":
        cfg["relocalize_with_nav_data"] = True
    jt, pt = tpt.make_trackers(seq, cfg)          # accepted by both
    assert pt.cfg[name] == jt.cfg[name]

    if name == "map_file":
        assert pt.engine.status.name == jt.engine.status.name == "LOST"
        a = map_to_numpy(pt.engine.map)
        for k, v in d.items():
            np.testing.assert_array_equal(a[k], v, err_msg=k)
    elif name == "mapping":
        assert pt.engine.mapping_enabled is jt.engine.mapping_enabled is False
    elif name in ("mask_image", "mask_radius"):
        jt._configure_mask((120, 160))
        pt._configure_mask((120, 160))
        want = np.asarray(jt.engine.mask)
        assert 0 < want.sum() < want.size
        np.testing.assert_array_equal(pt.engine.mask.numpy(), want)
    elif name in ("max_laser_age", "occupancy_cell_size"):
        jt.engine.map = tpt.jax_map(d)
        pt.engine.map = map_from_numpy(d, "cpu")
        rng = np.random.default_rng(1)
        for ts in (0.0, 0.2, 0.5):
            kw = dict(timestamp=ts, ranges=rng.uniform(0.5, 4.0, 40), angle_min=-0.8,
                      angle_increment=0.04, range_max=3.5)
            jt.add_laser_scan(JScan(**kw))
            pt.add_laser_scan(LaserScan(**kw))
        assert [s.timestamp for s in pt._laser_buffer] == [s.timestamp for s in jt._laser_buffer]
        np.testing.assert_array_equal(pt.get_occupancy_map()["grid"],
                                      jt.get_occupancy_map()["grid"])
    elif name == "emit_map_seconds":
        jt.engine.map = tpt.jax_map(d)
        pt.engine.map = map_from_numpy(d, "cpu")
        got = []
        for tr in (jt, pt):
            q = []
            tr.start(type("Q", (), {"push": staticmethod(q.append)})())
            for now in (0.1, 0.5, 0.7, 1.05):
                tr._maybe_emit_map(now)
            got.append([(e.timestamp, len(e.features)) for e in q])
        assert got[0] == got[1] and len(got[0]) == 2
    elif name == "wait_for_navigation_data":
        from lpslam_tpu.pipeline.queues import CameraQueueEntry as JEntry

        img = seq.images[0]
        assert jt.process_image(JEntry(timestamp=0.0, image=img)) == []
        assert pt.process_image(CameraQueueEntry(0.0, img)) == []
        assert pt.engine.frame_id == jt.engine.frame_id == 0
    else:  # relocalize_with_nav_data, time_to_relocalize
        times = (0.0, 0.3, 0.7, 4.5)
        a, b = _reseed_run(pt, "torch", times), _reseed_run(jt, "jax", times)
        for (Ra, ta), (Rb, tb) in zip(a, b):
            np.testing.assert_allclose(Ra, Rb, atol=1e-6)
            np.testing.assert_allclose(ta, tb, atol=1e-6)
        moved = [not np.allclose(R, np.eye(3)) for R, _ in a]
        # the first frame past the wait reseeds the pose from the odometry
        want = [False, False, True, True] if name == "time_to_relocalize" \
            else [False, False, False, True]
        assert moved == want, moved


def test_schema_and_unported_calls():
    from lpslam_tpu.pipeline import processors as jproc
    from lpslam_tpu.pipeline import sources as jsrc
    from lpslam_tpu.pipeline.rectify import RectifyProcessor as JRect
    from lpslam_tpu.pipeline.config import CameraConfig as JCC
    from lpslam_tpu_torch.pipeline.processors import CameraCalibrationProcessor
    from lpslam_tpu_torch.pipeline.rectify import RectifyProcessor
    from lpslam_tpu_torch.pipeline.config import CameraConfig
    from lpslam_tpu_torch.pipeline.sources import (
        OpenCVCameraSource, ReplaySource, ZedOpenCaptureSource, ZedSdkSource,
    )

    cam = TCam.make(100.0, 100.0, 80.0, 60.0, device="cpu")
    with pytest.raises(ConfigError):
        VSLAMTracker(cam, {"no_such_option": 1}, device="cpu")
    with pytest.raises(ConfigError):
        VSLAMTracker(cam, {"keypoints": "many"}, device="cpu")
    with pytest.raises(ValueError):
        VSLAMTracker(cam, {"mode": "sonar"}, device="cpu")
    tr = VSLAMTracker(cam, {"_comment": "ignored", "keypoints": 64.0}, device="cpu")
    assert tr.cfg["keypoints"] == 64
    assert tr.status()["state"] == "NOT_INITIALIZED"
    # the live sources and the calibration processor build as in JAX (their
    # capture API is imported when they start); without pyzed the SDK source
    # raises as JAX's does; a missing replay file raises as in JAX
    for ours, ref, conf in ((OpenCVCameraSource, jsrc.OpenCVCameraSource, {"device": 2}),
                            (ZedOpenCaptureSource, jsrc.ZedOpenCaptureSource, {"height": 720}),
                            (CameraCalibrationProcessor, jproc.CameraCalibrationProcessor,
                             {"min_views": 3})):
        assert ours(conf).cfg == ref(conf).cfg
    for cls in (ZedSdkSource, jsrc.ZedSdkSource):
        with pytest.raises(RuntimeError, match="pyzed"):
            cls({})
    with pytest.raises(FileNotFoundError):
        ReplaySource({"file": "/nonexistent/x.pb"})
    with pytest.raises(ConfigError):
        ReplaySource({})                           # the schema still parses first
    # fisheye and omni cameras rectify; omni against the JAX processor
    for model, dist in (("fisheye", [0.1, 0.0, 0.0, 0.0]), ("omni", [0.9, -0.1, 0.0, 0.0, 0.0])):
        kw = dict(number=0, model=model, fx=100.0, fy=100.0, cx=80.0, cy=60.0,
                  distortion=np.asarray(dist, np.float32), width=160, height=120)
        proc = RectifyProcessor(camera=CameraConfig(**kw), device="cpu")
        assert proc._maps[0].shape == (120, 160, 2) and proc._maps[1] is None
        if model == "omni":
            np.testing.assert_array_equal(proc.K_new, JRect(camera=JCC(**kw)).K_new)
        else:
            np.testing.assert_array_equal(proc.K_new, np.float32([[100, 0, 80], [0, 100, 60],
                                                                  [0, 0, 1]]))


def test_vocabulary_training_refuses():
    """No vocabulary file: at 4 keyframes the tracker trains one on the
    map's valid keyframe descriptors, as the JAX tracker does; with the JAX
    draw fed in, the same words."""
    import jax
    import jax.numpy as jnp

    from lpslam_tpu.geometry import PinholeCamera as JCam
    from lpslam_tpu.pipeline.trackers import VSLAMTracker as JTracker
    from lpslam_tpu_torch.loop import vocab as tvocab

    config = {"keypoints": 96, "loop_closure": True, "vocab_file": "/nonexistent/v"}
    tr = VSLAMTracker(TCam.make(100.0, 100.0, 80.0, 60.0, device="cpu"), dict(config),
                      device="cpu")
    ref = JTracker(JCam.make(100.0, 100.0, 80.0, 60.0), dict(config))
    tr._ensure_loop_closer()
    ref._ensure_loop_closer()
    assert tr.loop_closer is None and ref.loop_closer is None
    rng = np.random.default_rng(0)
    shape = tuple(tr.engine.map.kf_desc.shape)
    desc = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    valid = rng.random(shape[:2]) < 0.7
    valid[4:] = False
    tr.engine.map = tr.engine.map._replace(
        kf_desc=torch.from_numpy(desc.view(np.int32)), kf_kp_valid=torch.from_numpy(valid),
        n_kf=torch.tensor(4, dtype=torch.int32))
    ref.engine.map = ref.engine.map._replace(
        kf_desc=jnp.asarray(desc), kf_kp_valid=jnp.asarray(valid), n_kf=jnp.asarray(4, jnp.int32))

    def jax_draw(n, n_words, seed, device):
        idx = jax.random.choice(jax.random.PRNGKey(seed), n, (n_words,), replace=False)
        return torch.from_numpy(np.asarray(idx, np.int64)).to(device)

    orig = tvocab._kmajority_draw
    tvocab._kmajority_draw = jax_draw
    try:
        assert tr._maybe_close_loop() is False
    finally:
        tvocab._kmajority_draw = orig
    assert ref._maybe_close_loop() is False
    n = min(4096, int(valid[:4].sum()))
    assert tr.loop_closer.vocab.words.shape[0] == min(512, max(64, n // 8))
    np.testing.assert_array_equal(tr.loop_closer.vocab.words.numpy().view(np.uint32),
                                  np.asarray(ref.loop_closer.vocab.words))
    assert tr.loop_closer.n == ref.loop_closer.n == 4
    np.testing.assert_allclose(tr.loop_closer.db[:4].numpy(), np.asarray(ref.loop_closer.db[:4]),
                               atol=1e-6)


def test_tracker_result_pose_matches_jax():
    from lpslam_tpu.geometry import frames as jfr
    from lpslam_tpu.geometry.se3 import SE3 as JSE3
    from lpslam_tpu.pipeline import trackers as jtr
    from lpslam_tpu_torch.geometry import frames as tfr
    from lpslam_tpu_torch.geometry.se3 import SE3 as TSE3
    from lpslam_tpu_torch.pipeline import trackers as ttr

    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    for a, b in zip(ttr.create_tracker_result_pose(R, t), jtr.create_tracker_result_pose(R, t)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_array_equal(ttr._sigma_to_lpslam([1, 2, 3]), jtr._sigma_to_lpslam([1, 2, 3]))
    # the frame conversions, on tensors and on numpy arrays
    v = rng.normal(size=(5, 3)).astype(np.float32)
    for f in ("lpslam_to_optical", "optical_to_lpslam"):
        np.testing.assert_array_equal(getattr(tfr, f)(torch.from_numpy(v)).numpy(),
                                      np.asarray(getattr(jfr, f)(v)))
        np.testing.assert_array_equal(getattr(tfr, f)(v), np.asarray(getattr(jfr, f)(v)))
    for f in ("se3_lpslam_to_optical", "se3_optical_to_lpslam"):
        a = getattr(tfr, f)(TSE3(torch.from_numpy(R), torch.from_numpy(t)))
        b = getattr(jfr, f)(JSE3(R, t))
        np.testing.assert_allclose(a.R.numpy(), np.asarray(b.R), atol=1e-7)
        np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), atol=1e-7)
