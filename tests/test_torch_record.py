"""Port parity, record and replay: lpslam_tpu_torch's lpslam_pb, RecordEngine,
ReplayEngine, ReplaySource and the manager's, CLI's and LpSlamManager's
recording, replay and JPEG paths, against the JAX package on the CPU.

- Wire format: every message type encodes to the JAX copy's bytes and
  decodes both ways.
- Recording: the same store_* calls through both packages' RecordEngine
  write byte-identical files; a stream either package wrote replays through
  the other's ReplayEngine to equal entries (images bit-equal, states within
  1e-12).
- Manager: a 320x240 synthetic session (at 160x120 both packages lose track
  before the end, live and replayed, which makes the comparison noise) recorded in both packages (each
  camera frame the bytes of cv2.imencode at quality 90), then replayed in both (the port through its CLI's
  --replay, recording sensors and results with --record-no-video): the
  replays held to test_manager_matches_jax's rule (valid results within 1,
  keyframes within 1, landmarks within 15%, Sim3 ATE <= max(1.5 x, + 0.02 m)).
- compressed= input, compress_image and the image callback give the JAX
  package's bytes and pixels.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from lpslam_tpu.eval import ate_rmse  # noqa: E402
from lpslam_tpu.io import lpslam_pb as jpb  # noqa: E402
from lpslam_tpu.io.synthetic import make_sequence  # noqa: E402
from lpslam_tpu_torch.io import lpslam_pb as tpb  # noqa: E402

torch.set_num_threads(1)

N_FRAMES = 30
SIZE = (240, 320)


def _messages(pb):
    vec = pb.Vec3Sigma(x=1.5, y=-2.25, z=3e-9, x_sigma=0.1, y_sigma=0.2, z_sigma=0.3)
    ori = pb.Orientation(w=0.7, x=-0.1, y=0.2, z=0.3, sigma=0.01)
    gs = pb.GlobalState(position=vec, orientation=ori, velocity=vec, velocity_valid=True)
    tcs = pb.TrackerCoordinateSystem(position=vec, orientation=ori)
    return {
        pb.MSG_CAMERA_IMAGE: pb.CameraImage(
            timestamp=-123456789012, data_number=7, image_data=b"\xff\xd8\x00\x01",
            state_odom=gs, state_map=gs, camera_number=2, image_data_second=b"\x02",
            camera_number_second=3, image_base=tcs, image_base_second=tcs,
            has_state_odom=True, has_state_map=True),
        pb.MSG_SENSOR_IMU: pb.SensorImu(timestamp=5, acc=vec, gyro=vec),
        pb.MSG_SENSOR_GLOBAL_STATE: pb.SensorGlobalState(timestamp=9, state=gs, reference=True),
        pb.MSG_RESULT: pb.GlobalStateInTime(timestamp=2**40, state=gs),
        pb.MSG_SENSOR_FEATURE: pb.SensorFeature(
            timestamp=11, last_observed=12, position=vec, closest_keyframe=vec,
            observation_count=4, anchor_id="anchör"),
    }


def test_wire_format_matches_jax():
    assert tpb.MAX_MSG_SIZE == jpb.MAX_MSG_SIZE
    assert set(tpb._DECODERS) == set(jpb._DECODERS)
    ours, ref = _messages(tpb), _messages(jpb)
    for t in ref:
        data = ref[t].encode()
        assert ours[t].encode() == data, t
        assert tpb._DECODERS[t].decode(data).encode() == data
        assert jpb._DECODERS[t].decode(ours[t].encode()).encode() == data
        assert type(ours[t]).decode(b"").encode() == type(ref[t]).decode(b"").encode()


def _store_calls(engine, queues, seed=0):
    """One fixed sequence of store_* calls, with frames from a seed."""
    rng = np.random.default_rng(seed)
    R = cv2.Rodrigues(np.array([0.1, -0.2, 0.3]))[0]
    for t in range(6):
        img = np.clip(rng.normal(120, 40, (45, 67)), 0, 255).astype(np.float32)
        second = img[::-1].copy() if t % 2 else None
        engine.store_camera_image(queues.CameraQueueEntry(
            timestamp=t * 0.05, image=img, image_second=second, camera_number=t % 2,
            state_odom=(np.array([t, 0.5, -1.0]), R) if t % 3 else None,
            state_map=(np.array([0.0, t, 2.0]), R.T) if t == 4 else None))
        engine.store_imu(t * 0.05 + 0.01, rng.normal(size=3), rng.normal(size=3))
        engine.store_global_state(t * 0.05 + 0.02, rng.normal(size=3),
                                  np.array([0.9, 0.1, -0.3, 0.3]), reference=t == 3)
        engine.store_result(t * 0.05, rng.normal(size=3), np.array([1.0, 0, 0, 0]),
                            position_sigma=(0.1, 0.2, 0.3), orientation_sigma=0.05)
    engine.store_features(0.3, [{"position": (1.0, 2.0, 3.0), "observations": 5}])


def _record(pkg, path):
    import importlib

    record = importlib.import_module(f"{pkg}.pipeline.record")
    queues = importlib.import_module(f"{pkg}.pipeline.queues")
    rec = record.RecordEngine(jpeg_quality=90)
    rec.set_output_file(str(path))
    rec.start()
    _store_calls(rec, queues)
    rec.stop()


def _replay(pkg, path):
    import importlib

    record = importlib.import_module(f"{pkg}.pipeline.record")
    queues = importlib.import_module(f"{pkg}.pipeline.queues")
    cam, sens = queues.PyBoundedQueue(maxsize=64), queues.PyBoundedQueue(maxsize=64)
    eng = record.ReplayEngine(str(path))
    eng.attach(cam, sens)
    while not eng.done:
        eng.stream_more()
    out = []
    for q in (cam, sens):
        while not q.empty():
            out.append(q.get_nowait())
    return out


def _assert_entries_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__
        for k, v in vars(x).items():
            w = getattr(y, k)
            if isinstance(v, np.ndarray):
                assert v.dtype == w.dtype, k
                np.testing.assert_array_equal(v, w, err_msg=k)
            elif isinstance(v, tuple):
                for p, q in zip(v, w):
                    np.testing.assert_allclose(p, q, rtol=0, atol=1e-12, err_msg=k)
            else:
                assert v == w, k


def test_record_engines_write_the_same_bytes_and_replay_across(tmp_path):
    _record("lpslam_tpu", tmp_path / "jax.pb")
    _record("lpslam_tpu_torch", tmp_path / "torch.pb")
    data = (tmp_path / "jax.pb").read_bytes()
    assert (tmp_path / "torch.pb").read_bytes() == data and len(data) > 10000
    for path in (tmp_path / "jax.pb", tmp_path / "torch.pb"):
        ref = _replay("lpslam_tpu", path)
        assert sum(e.__class__.__name__ == "CameraQueueEntry" for e in ref) == 6
        _assert_entries_equal(_replay("lpslam_tpu_torch", path), ref)


def _config(tmp_path, seq, record: bool, source: bool = True):
    K = seq.K
    cfg = {
        "manager": {"record": record},
        "datasources": [{"type": "Synthetic", "configuration": {
            "num_frames": N_FRAMES, "width": SIZE[1], "height": SIZE[0], "fps": 20.0,
            "seed": 0}}] if source else [],
        "cameras": [{"number": 0, "model": "no_distortion", "fx": float(K[0, 0]),
                     "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2]),
                     "resolution": [SIZE[1], SIZE[0]]}],
        "trackers": [{"type": "VSLAM", "configuration": {
            "mode": "mono", "keypoints": 256, "levels": 2, "max_keyframes": 16,
            "max_landmarks": 2048}}],
        "processors": [],
    }
    path = tmp_path / f"cfg_{int(record)}_{int(source)}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _run(mgr, timeout=300.0):
    results = []
    mgr.on_reconstruction = results.append
    mgr.start()
    t0 = time.time()
    finite = [s for s in mgr.sources if hasattr(s, "done")]
    while time.time() - t0 < timeout and not (all(s.done for s in finite)
                                              and mgr.camera_queue.empty()):
        time.sleep(0.05)
    mgr.stop()
    return results, mgr.get_status()


def _ate(stamped, seq):
    est = np.stack([np.asarray(p, np.float64) for _, p in stamped])
    gt = np.stack([np.asarray(seq.poses_wc[int(round(ts * 20))].t) for ts, _ in stamped])
    return ate_rmse(est, gt)[0]


def _read(path):
    with jpb.ProtoStreamReader(str(path)) as r:
        return list(r)


def _one_pb(directory):
    files = [f for f in os.listdir(directory) if f.endswith(".pb")]
    assert len(files) == 1 and files[0].startswith("slam_"), files
    return directory / files[0]


def test_record_then_replay_matches_jax(tmp_path, monkeypatch, capsys):
    from lpslam_tpu.pipeline.manager import SlamManager as JManager
    from lpslam_tpu_torch.pipeline import cli
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    seq = make_sequence(num_frames=N_FRAMES, h=SIZE[0], w=SIZE[1], seed=0)
    streams = {}
    for name, make in (("jax", JManager), ("torch", lambda: SlamManager(device="cpu"))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        mgr = make()
        mgr.read_configuration_file(_config(tmp_path, seq, record=True))
        results, st = _run(mgr)
        assert st.error == "" and st.frames_processed == N_FRAMES, st
        msgs = _read(_one_pb(tmp_path / name))
        streams[name] = msgs
        n_valid = sum(r.valid for r in results)
        assert sum(t == jpb.MSG_RESULT for t, _ in msgs) == n_valid > 0
    # each package's frames (the port renders with float32 torch poses, so
    # a few pixels truncate one grey level apart) as cv2.imencode writes them
    from lpslam_tpu_torch.io.synthetic import make_sequence as port_sequence

    frames = {"jax": seq.images, "torch": port_sequence(num_frames=N_FRAMES, h=SIZE[0],
                                                        w=SIZE[1], seed=0).images}
    cams = {k: [m for t, m in v if t == jpb.MSG_CAMERA_IMAGE] for k, v in streams.items()}
    assert len(cams["jax"]) == len(cams["torch"]) == N_FRAMES
    for name in cams:
        for i, m in enumerate(cams[name]):
            u8 = np.clip(frames[name][i], 0, 255).astype(np.uint8)
            assert m.image_data == cv2.imencode(".jpg", u8, [cv2.IMWRITE_JPEG_QUALITY, 90])[
                1].tobytes(), (name, i)
    assert [m.timestamp for m in cams["jax"]] == [m.timestamp for m in cams["torch"]]
    # each frame carries the odometry the worker drained with it (which of
    # the neighbouring ground-truth states that is depends on thread timing;
    # the source publishes a frame's state just after the frame)
    for name in streams:
        assert sum(m.has_state_odom for m in cams[name]) >= N_FRAMES - 2
        assert sum(t == jpb.MSG_SENSOR_GLOBAL_STATE for t, _ in streams[name]) >= N_FRAMES - 1

    # replay each package's recording in that package: JAX through its
    # manager, the port through its CLI (also recording, without video)
    replay_cfg = _config(tmp_path, seq, record=False, source=False)
    monkeypatch.chdir(tmp_path / "jax")
    jm = JManager()
    jm.read_configuration_file(replay_cfg)
    jm.add_source_by_name("Replay", {"file": str(_one_pb(tmp_path / "jax"))})
    ref, st_ref = _run(jm)
    (tmp_path / "replay").mkdir()
    monkeypatch.chdir(tmp_path / "replay")
    traj = tmp_path / "traj.txt"
    capsys.readouterr()
    rc = cli.main(["--config", replay_cfg, "--device", "cpu", "--replay",
                   str(_one_pb(tmp_path / "torch")), "--record-no-video",
                   "--export-trajectory", str(traj)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["error"] == "" and st_ref.error == "", (line, st_ref)
    assert line["frames"] == st_ref.frames_processed == N_FRAMES
    n_ref = sum(r.valid for r in ref)
    assert line["tracked"] >= n_ref - 1 and n_ref > N_FRAMES // 3, (line, n_ref)
    assert abs(line["keyframes"] - st_ref.keyframes) <= 1, (line, st_ref)
    assert abs(line["landmarks"] - st_ref.landmarks) <= 0.15 * st_ref.landmarks, (line, st_ref, n_ref)
    ours = [(v[0], v[1:4]) for v in np.loadtxt(traj, ndmin=2)]
    a = _ate(ours, seq)
    b = _ate([(r.timestamp, r.position) for r in ref if r.valid], seq)
    assert a <= max(1.5 * b, b + 0.02), (a, b)
    # --record-no-video: frames without image data, the results and states
    msgs = _read(_one_pb(tmp_path / "replay"))
    cams = [m for t, m in msgs if t == jpb.MSG_CAMERA_IMAGE]
    assert len(cams) == N_FRAMES and not any(m.image_data for m in cams)
    assert sum(t == jpb.MSG_RESULT for t, _ in msgs) == line["tracked"]


def test_jpeg_paths_match_jax():
    from lpslam_tpu.interface import LpSlamManager as JLpSlam
    from lpslam_tpu.pipeline.manager import SlamManager as JManager
    from lpslam_tpu_torch.interface import LpSlamManager
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    rng = np.random.default_rng(2)
    grey = np.clip(rng.normal(100, 50, (48, 64)), 0, 255).astype(np.uint8)
    assert LpSlamManager.compress_image(grey) == JLpSlam.compress_image(grey)
    assert LpSlamManager.compress_image(grey, 95) == JLpSlam.compress_image(grey, 95)
    colour = cv2.imencode(".jpg", np.stack([grey, grey[::-1], 255 - grey], -1),
                          [cv2.IMWRITE_JPEG_QUALITY, 80])[1].tobytes()
    for data in (JLpSlam.compress_image(grey), colour, b"\xff\xd8\xff\x00junk"):
        pushed = []
        for mgr in (SlamManager(device="cpu"), JManager()):
            ok = mgr.add_image_from_buffer(0.5, None, compressed=data)
            pushed.append(mgr.camera_queue.pop(timeout=0.1) if ok else None)
        if pushed[1] is None:
            assert pushed[0] is None
        else:
            np.testing.assert_array_equal(pushed[0].image, pushed[1].image)
            assert pushed[0].image.dtype == pushed[1].image.dtype
    # the image callback: JPEG at quality 70 of each eye
    got = []
    mgr = SlamManager(device="cpu")
    mgr.on_image = lambda ts, jpeg, second: got.append((ts, jpeg, second))
    mgr.start()
    img = grey.astype(np.float32)
    mgr.add_stereo_image_from_buffer(1.25, grey, grey[::-1])
    t0 = time.time()
    while not got and time.time() - t0 < 10:
        time.sleep(0.01)
    mgr.stop()
    assert got and mgr.get_status().error == ""
    from lpslam_tpu.pipeline.record import _encode_jpeg

    assert got[0] == (1.25, _encode_jpeg(img, 70), _encode_jpeg(img[::-1], 70))
