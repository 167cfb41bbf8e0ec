"""Port parity, the pipeline tracker's options: lpslam_tpu_torch's
pipeline/trackers.py::VSLAMTracker against lpslam_tpu's on the same numpy
frames (the JAX package's synthetic orbit at 120x160) and the same maps.

- Navigation priors: the prior each package hands its engine from
  odometry and from map-frame states is equal within 1e-5; a host-path run
  with an odometry prior on every frame tracks within 1 frame of JAX's and
  its Sim3 ATE is within max(1.5 x JAX, JAX + 0.02) (the parity rule).
- wait_for_navigation_data: a frame without odometry is dropped ([]).
- A radial mask on the host path and an image mask (a PNG at half size,
  resized nearest-neighbour) on the chunk path: the masks are bit-equal to
  JAX's, every keyframe keypoint lies inside the mask in both packages, and
  tracked / keyframe counts are within 1 of JAX's.
- `mapping: false` after loading a map, and set_mapping_mode(False) on the
  host path: no keyframe is inserted in either package; in the port's
  chunk loop too (the JAX package's chunk loop keeps its build-time switch).
- The port's chunk loop without loop closing keeps at most one boundary
  compaction queued over a long run, and its keyframe count stays the map's.
- map_file: a map saved by one package on stop() loads into the other's
  tracker as LOST, and both track the next frames the same way.
- get_features (boundary, transform), export_csv and get_occupancy_map with
  a laser scan are equal on the same map; map emission pushes the same
  features entries onto the sensor queue.
"""
import queue

import numpy as np
import pytest
import torch

from lpslam_tpu.eval import ate_rmse
from lpslam_tpu.io.synthetic import make_sequence
from lpslam_tpu.pipeline.queues import CameraQueueEntry as JEntry

from lpslam_tpu_torch.convert import map_from_numpy, map_to_numpy
from lpslam_tpu_torch.geometry import PinholeCamera as TCam
from lpslam_tpu_torch.pipeline import trackers as ttr
from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry, SensorQueueEntry

torch.set_num_threads(1)

BASE = {"mode": "mono", "keypoints": 256, "levels": 2, "max_keyframes": 16,
        "max_landmarks": 2048}


def small_map_numpy(seed=0, K=8, N=32, M=256, n_kf=6, n_lm=200):
    """A MapStore as numpy (the JAX field names and dtypes): keyframes on an
    arc looking at a cloud of landmarks, each keyframe observing some."""
    rng = np.random.default_rng(seed)
    d = {
        "lm_pos": np.zeros((M, 3), np.float32),
        "lm_desc": rng.integers(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32),
        "lm_valid": np.zeros(M, bool),
        "lm_n_obs": np.zeros(M, np.int32),
        "lm_first_kf": np.full(M, -1, np.int32),
        "lm_n_visible": rng.integers(0, 20, M).astype(np.int32),
        "lm_n_found": rng.integers(0, 10, M).astype(np.int32),
        "kf_R": np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        "kf_t": np.zeros((K, 3), np.float32),
        "kf_valid": np.zeros(K, bool),
        "kf_frame_id": np.full(K, -1, np.int32),
        "kf_uv": rng.uniform(0, 160, (K, N, 2)).astype(np.float32),
        "kf_desc": rng.integers(0, 2**32, (K, N, 8), dtype=np.uint64).astype(np.uint32),
        "kf_kp_valid": rng.random((K, N)) < 0.9,
        "kf_lm_idx": np.full((K, N), -1, np.int32),
        "n_kf": np.int32(n_kf),
        "n_lm": np.int32(n_lm),
    }
    d["lm_pos"][:n_lm] = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-1, 1, n_lm),
                                   rng.uniform(3, 9, n_lm)], 1)
    d["lm_valid"][:n_lm] = rng.random(n_lm) < 0.95
    d["lm_n_obs"][:n_lm] = rng.integers(1, 6, n_lm)
    for k in range(n_kf):
        a = 0.1 * k
        c, s = np.cos(a), np.sin(a)
        R = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        d["kf_R"][k] = R
        d["kf_t"][k] = -R @ np.array([0.3 * k, 0.0, 0.1 * k], np.float32)
        d["kf_valid"][k] = True
        d["kf_frame_id"][k] = 3 * k
        d["kf_lm_idx"][k] = np.where(rng.random(N) < 0.7, rng.integers(0, n_lm, N), -1)
    return d


def jax_map(d):
    import jax.numpy as jnp
    from lpslam_tpu.mapstore.store import MapStore

    return MapStore(**{k: jnp.asarray(v) for k, v in d.items()})


def make_trackers(seq, config):
    """(JAX tracker, port tracker) with the same configuration."""
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.pipeline.trackers import VSLAMTracker as JTracker

    K = seq.K
    jt = JTracker(PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), dict(config))
    pt = ttr.VSLAMTracker(TCam.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device="cpu"),
                          dict(config), device="cpu")
    return jt, pt


def jentry(t, img):
    return JEntry(timestamp=t / 20.0, image=img)


def feed(tr, entry_cls, seq, frames, nav=None, before=None):
    """Frames of `seq` through tr.process_image; nav(t) gives (nav_odom,
    nav_map); before(t, tr) runs ahead of each frame."""
    for t in frames:
        if before is not None:
            before(t, tr)
        odom, mp = nav(t) if nav is not None else (None, None)
        tr.process_image(entry_cls(timestamp=t / 20.0, image=seq.images[t]),
                         nav_odom=odom, nav_map=mp)
    tr.flush()


def summary(tr, seq):
    est, gt = [], []
    for fid, pose, _ in tr.engine.trajectory:
        if pose is not None:
            est.append(-np.asarray(pose.R).T @ np.asarray(pose.t))
            gt.append(np.asarray(seq.poses_wc[fid].t))
    return {"tracked": len(est), "keyframes": tr.engine.n_keyframes,
            "ate": ate_rmse(np.asarray(est), np.asarray(gt))[0] if len(est) > 3 else np.inf,
            "state": tr.engine.status.name}


def assert_parity(ours, ref):
    assert ours["tracked"] >= ref["tracked"] - 1, (ours, ref)
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)


@pytest.fixture(scope="module")
def orbit():
    return make_sequence(num_frames=28, h=120, w=160, seed=1, motion="orbit", fx=115.0)


def odom(seq):
    return lambda t: ((np.asarray(seq.poses_wc[t].t, np.float64), np.asarray(seq.poses_wc[t].R)),
                      None)


class _Stub:
    """An engine that records the prior it is handed."""

    def __init__(self, status, pose):
        self.status, self.pose = status, pose
        self.mapping_in_flight = False
        self._compactions = []
        self.captured = []
        self.mapping_enabled = True
        self.last_sigma_pos, self.last_sigma_rot = np.zeros(3), 0.0

    def process(self, image, aux=None, nav_prior=None):
        self.captured.append(nav_prior)
        return self.status, self.pose

    def _drain_compact_stats(self, only_ready=False):
        return []


def test_nav_priors_match_jax(orbit):
    import jax.numpy as jnp
    from lpslam_tpu.frontend.tracker import TrackerStatus as JS
    from lpslam_tpu.geometry.se3 import SE3 as JSE3
    from lpslam_tpu_torch.frontend.tracker import TrackerStatus as TS
    from lpslam_tpu_torch.geometry.se3 import SE3 as TSE3

    jt, pt = make_trackers(orbit, BASE)
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R0 = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    t0 = rng.normal(size=3).astype(np.float32)
    jt.engine = _Stub(JS.TRACKING, JSE3(jnp.asarray(R0), jnp.asarray(t0)))
    pt.engine = _Stub(TS.TRACKING, TSE3(torch.from_numpy(R0), torch.from_numpy(t0)))
    pt.engine.device = torch.device("cpu")
    states = [(orbit.poses_wc[t].t.astype(np.float64), orbit.poses_wc[t].R) for t in (3, 9, 17)]
    for tr, cls in ((jt, None), (pt, CameraQueueEntry)):
        img = orbit.images[0]
        mk = (lambda i: jentry(i, img)) if cls is None else (lambda i: cls(i / 20.0, img))
        tr.process_image(mk(0), nav_odom=states[0])          # first odometry: no delta
        tr.process_image(mk(1), nav_odom=states[1])          # delta onto the pose
        tr.process_image(mk(2), nav_map=states[2])           # absolute map-frame state
    for a, b in zip(pt.engine.captured, jt.engine.captured):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.R.numpy(), np.asarray(b.R), atol=1e-5)
            np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), atol=1e-5)
    assert pt.engine.captured[0] is None and pt.engine.captured[1] is not None


def test_host_path_with_odometry_priors_and_radial_mask(orbit):
    cfg = dict(BASE, mask_radius=70.0)
    jt, pt = make_trackers(orbit, cfg)
    frames = range(len(orbit.images))
    feed(jt, JEntry, orbit, frames, nav=odom(orbit))
    feed(pt, CameraQueueEntry, orbit, frames, nav=odom(orbit))
    np.testing.assert_array_equal(pt.engine.mask.numpy(), np.asarray(jt.engine.mask))
    for tr in (jt, pt):
        m = map_to_numpy(tr.engine.map) if tr is pt else {
            k: np.asarray(v) for k, v in tr.engine.map._asdict().items()}
        nk = int(m["n_kf"])
        uv = m["kf_uv"][:nk][m["kf_kp_valid"][:nk]]
        assert len(uv) > 50
        assert (((uv[:, 0].astype(int) - 80.0) ** 2 + (uv[:, 1].astype(int) - 60.0) ** 2)
                <= 70.0 ** 2 + 1e-6).all()
    assert_parity(summary(pt, orbit), summary(jt, orbit))


def test_wait_for_navigation_data(orbit):
    jt, pt = make_trackers(orbit, dict(BASE, wait_for_navigation_data=True))
    assert jt.process_image(jentry(0, orbit.images[0])) == []
    assert pt.process_image(CameraQueueEntry(0.0, orbit.images[0])) == []
    assert pt.engine.frame_id == jt.engine.frame_id == 0


def test_chunk_path_with_image_mask_then_mapping_frozen(orbit, tmp_path):
    from lpslam_tpu_torch.io.png import write_png

    mask = np.zeros((60, 80), np.uint8)
    mask[5:55, 8:72] = 255
    path = str(tmp_path / "mask.png")
    write_png(path, mask)
    cfg = dict(BASE, mask_image=path, chunk_size=8)
    jt, pt = make_trackers(orbit, cfg)
    frames = range(len(orbit.images))
    feed(jt, JEntry, orbit, frames)
    feed(pt, CameraQueueEntry, orbit, frames)
    want = np.asarray(jt.engine.mask)
    np.testing.assert_array_equal(pt.engine.mask.numpy(), want)
    assert want.shape == (120, 160) and not want.all()
    for tr in (jt, pt):
        assert tr._chunked is not None                       # the chunk path ran
        m = {k: np.asarray(v) if tr is jt else v for k, v in (
            tr.engine.map._asdict().items() if tr is jt else map_to_numpy(tr.engine.map).items())}
        nk = int(m["n_kf"])
        uv = m["kf_uv"][:nk][m["kf_kp_valid"][:nk]].astype(int)
        assert want[np.clip(uv[:, 1], 0, 119), np.clip(uv[:, 0], 0, 159)].all()
    assert_parity(summary(pt, orbit), summary(jt, orbit))

    # localization only on the host path: no keyframe after the freeze
    for tr, cls in ((jt, None), (pt, CameraQueueEntry)):
        tr._chunk_size = 0
        tr.set_mapping_mode(False)
        n_kf = tr.engine.n_keyframes
        mk = jentry if cls is None else (lambda t, img: cls(t / 20.0, img))
        for t in range(len(orbit.images) - 1, 10, -1):       # fly back
            tr.process_image(mk(t, orbit.images[t]))
        assert tr.engine.n_keyframes == n_kf
        assert not tr.engine.mapping_enabled


def test_set_mapping_mode_reaches_the_chunk_loop():
    """The port's own: once the chunk loop exists, set_mapping_mode(False)
    stops keyframe insertion there too (the JAX package's chunk loop keeps
    the switch it was built with). On this orbit the loop inserts 3
    keyframes over frames 28-43 when the switch does not reach it."""
    seq = make_sequence(num_frames=44, h=120, w=160, seed=1, motion="orbit", fx=115.0)
    K = seq.K
    pt = ttr.VSLAMTracker(TCam.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device="cpu"),
                          dict(BASE, chunk_size=8), device="cpu")
    feed(pt, CameraQueueEntry, seq, range(28))
    assert pt._chunked is not None and pt.engine.status.name == "TRACKING"
    chunks = []
    dispatch = pt._chunked.process_chunk
    pt._chunked.process_chunk = lambda frames: (chunks.append(len(frames)), dispatch(frames))[1]
    n_kf = pt.engine.n_keyframes
    pt.set_mapping_mode(False)
    feed(pt, CameraQueueEntry, seq, range(28, 44))
    assert chunks == [8, 8]
    assert [s.name for _, _, s in pt.engine.trajectory[28:]] == ["TRACKING"] * 16
    assert pt.engine.n_keyframes == n_kf


def test_chunk_path_without_loop_closing_keeps_one_compaction_queued():
    """The port's own: without loop closing nothing reads a compaction's
    slot permutation, so the chunk path keeps queued at most the newest
    boundary's compaction (each holds a whole compacted map) however long
    it runs, and once it is read the engine's keyframe count is the map's."""
    seq = make_sequence(num_frames=75, h=120, w=160, seed=1, motion="orbit", fx=115.0)
    K = seq.K
    pt = ttr.VSLAMTracker(TCam.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device="cpu"),
                          dict(BASE, max_keyframes=8, chunk_size=8), device="cpu")
    eng, queued = pt.engine, []
    enqueue = eng._queue_compaction
    eng._queue_compaction = lambda res: (queued.append(pt._chunked is not None), enqueue(res))
    for t in range(len(seq.images)):
        pt.process_image(CameraQueueEntry(t / 20.0, seq.images[t]))
        assert len(eng._pending_compacts) <= 1 and eng._compactions == [], t
    pt.flush()
    assert sum(queued) >= 5, queued      # the chunk path compacted, chunk after chunk
    eng._drain_compact_stats()
    assert eng._kf_count == int(eng.map.n_kf)
    names = [s.name for _, _, s in eng.trajectory]
    assert len(names) == 75 and names.index("TRACKING") < 20
    assert set(names[names.index("TRACKING"):]) == {"TRACKING"}


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_map_file_crosses_and_localizes(orbit, tmp_path, saver):
    path = str(tmp_path / f"map_{saver}.npz")
    jt, pt = make_trackers(orbit, dict(BASE, map_file=path))
    src = jt if saver == "jax" else pt
    feed(src, JEntry if saver == "jax" else CameraQueueEntry, orbit, range(16))
    src.stop()                                                # writes map_file
    jl, pl = make_trackers(orbit, dict(BASE, map_file=path, mapping=False))
    n_kf = int(jl.engine.map.n_kf)
    assert n_kf >= 2
    a, b = map_to_numpy(pl.engine.map), {k: np.asarray(v) for k, v in jl.engine.map._asdict().items()}
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert jl.engine.status.name == pl.engine.status.name == "LOST"
    feed(jl, JEntry, orbit, range(6))
    feed(pl, CameraQueueEntry, orbit, range(6))
    ours, ref = summary(pl, orbit), summary(jl, orbit)
    assert ref["tracked"] >= 4 and ours["tracked"] >= ref["tracked"] - 1, (ours, ref)
    assert ours["keyframes"] == ref["keyframes"] == n_kf      # nothing inserted


def test_exports_and_occupancy_equal_on_the_same_map(tmp_path):
    from lpslam_tpu.pipeline.trackers import LaserScan as JScan

    d = small_map_numpy()
    seq = make_sequence(num_frames=1, h=120, w=160, seed=1, fx=115.0)
    jt, pt = make_trackers(seq, dict(BASE, occupancy_cell_size=0.2, max_laser_age=1.0))
    jt.engine.map = jax_map(d)
    pt.engine.map = map_from_numpy(d, "cpu")
    rng = np.random.default_rng(5)
    for ts in (0.0, 0.6, 1.4):
        kw = dict(timestamp=ts, ranges=rng.uniform(0.2, 6.0, 90), angle_min=-1.2,
                  angle_increment=0.03, range_max=5.0, extrinsic_R=np.eye(3),
                  extrinsic_t=np.array([0.0, 0.1, 0.05]))
        jt.add_laser_scan(JScan(**kw))
        pt.add_laser_scan(ttr.LaserScan(**kw))
    assert [s.timestamp for s in pt._laser_buffer] == [s.timestamp for s in jt._laser_buffer] \
        == [0.6, 1.4]
    og, oj = pt.get_occupancy_map(), jt.get_occupancy_map()
    np.testing.assert_array_equal(og["grid"], oj["grid"])
    np.testing.assert_array_equal(og["origin"], oj["origin"])
    assert (og["grid"] == 100).any() and (og["grid"] == 0).any()
    T = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 2]], np.float32)
    for kw in ({}, {"boundary": ((-1.0, 4.0), (2.0, 7.0))}, {"transform": T.ravel()},
               {"max_count": 17}):
        fg, fj = pt.get_features(**kw), jt.get_features(**kw)
        assert len(fg) == len(fj) > 0
        np.testing.assert_array_equal(np.stack([f["position"] for f in fg]),
                                      np.stack([np.asarray(f["position"]) for f in fj]))
        assert [f["observations"] for f in fg] == [f["observations"] for f in fj]
    b = ((-1.0, 4.0), (2.0, 7.0))
    assert pt.get_features_count(boundary=b) == jt.get_features_count(boundary=b)
    pt.export_csv(str(tmp_path / "t.csv"))
    jt.export_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_map_emission_onto_the_sensor_queue():
    d = small_map_numpy(seed=3)
    seq = make_sequence(num_frames=1, h=120, w=160, seed=1, fx=115.0)
    jt, pt = make_trackers(seq, dict(BASE, emit_map_seconds=0.5))
    jt.engine.map = jax_map(d)
    pt.engine.map = map_from_numpy(d, "cpu")
    qs = []
    for tr in (jt, pt):
        q = queue.Queue()
        q.push = q.put
        tr.start(q)
        for now in (0.2, 0.6, 0.9, 1.2, 1.3):
            tr._maybe_emit_map(now)
        qs.append([q.get_nowait() for _ in range(q.qsize())])
    (ej, eg) = qs
    assert [e.timestamp for e in eg] == [e.timestamp for e in ej] == [0.6, 1.2]
    assert all(isinstance(e, SensorQueueEntry) and e.kind == "features" for e in eg)
    for a, b in zip(eg, ej):
        np.testing.assert_array_equal(np.stack([f["position"] for f in a.features]),
                                      np.stack([np.asarray(f["position"]) for f in b.features]))
