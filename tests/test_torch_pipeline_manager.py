"""Port parity, the pipeline's owner and entry points: lpslam_tpu_torch's
SlamManager, CLI and LpSlamManager, on the CPU.

- SlamManager in both packages on the same config (the synthetic source at
  160x120, 30 frames, which publishes ground truth as odometry, so every
  TRACKING frame carries a navigation prior; its fixed 460 px focal length
  makes the view narrow here, and both packages initialize only after ~15
  frames): the same frames processed and
  results delivered, valid results within 1, final keyframes within 1,
  landmarks within 15%, and the Sim3 ATE of the lpslam-frame positions
  within max(1.5 x JAX, JAX + 0.02) (the parity rule).
- The CLI's config mode runs to its JSON line with --device cpu and writes
  the trajectory, the landmark CSV and the map file; LpSlamManager then
  localizes in that map (mapping off, map_file set) from buffers, every
  second one 3-channel BGR, with a laser scan: no keyframe added, the
  occupancy grid has occupied cells, no worker error.
- A two-slot camera queue keeps the newest frames (drop-oldest); a worker
  exception shows in SlamStatus.error; every refused option and source
  raises NotImplementedError naming its ROADMAP item (the recording,
  replay, JPEG paths and the live view no longer refuse); the live view
  shows the JAX manager's frames under a stand-in cv2 and turns itself off
  where imshow fails; the default device is the card and a missing one
  raises.
"""
import contextlib
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from lpslam_tpu.eval import ate_rmse
from lpslam_tpu.io.synthetic import make_sequence

torch.set_num_threads(1)

N_FRAMES = 30
CONFIG = {
    "manager": {"record": False},
    "datasources": [{"type": "Synthetic", "configuration": {
        "num_frames": N_FRAMES, "width": 160, "height": 120, "fps": 20.0, "seed": 0}}],
    "trackers": [{"type": "VSLAM", "configuration": {
        "mode": "mono", "keypoints": 256, "levels": 2, "max_keyframes": 16,
        "max_landmarks": 2048}}],
    "processors": [],
}


@pytest.fixture(scope="module")
def seq():
    return make_sequence(num_frames=N_FRAMES, h=120, w=160, seed=0)


def _config_file(tmp_path, seq, name="c.json", **tracker):
    K = seq.K
    cfg = json.loads(json.dumps(CONFIG))
    cfg["cameras"] = [{"number": 0, "model": "no_distortion", "fx": float(K[0, 0]),
                       "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2]),
                       "resolution": [160, 120]}]
    cfg["trackers"][0]["configuration"].update(tracker)
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return str(path)


def _run_manager(mgr, timeout=300.0):
    results = []
    mgr.on_reconstruction = results.append
    mgr.start()
    t0 = time.time()
    src = mgr.sources[0]
    while time.time() - t0 < timeout and not (src.done and mgr.camera_queue.empty()):
        time.sleep(0.05)
    mgr.stop()
    return results, mgr.get_status()


def _ate(results, seq):
    valid = [r for r in results if r.valid]
    est = np.stack([np.asarray(r.position, np.float64) for r in valid])
    gt = np.stack([np.asarray(seq.poses_wc[int(round(r.timestamp * 20))].t) for r in valid])
    return ate_rmse(est, gt)[0]


def test_manager_matches_jax(tmp_path, seq):
    from lpslam_tpu.pipeline.manager import SlamManager as JManager
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    path = _config_file(tmp_path, seq)
    jm = JManager()
    jm.read_configuration_file(path)
    ref, st_ref = _run_manager(jm)
    tm = SlamManager(device="cpu")
    tm.read_configuration_file(path)
    ours, st = _run_manager(tm)
    assert st.error == "" and st_ref.error == "", (st.error, st_ref.error)
    assert st.frames_processed == st_ref.frames_processed == N_FRAMES
    assert len(ours) == len(ref)
    n_ours, n_ref = sum(r.valid for r in ours), sum(r.valid for r in ref)
    assert n_ours >= n_ref - 1 and n_ref > N_FRAMES // 3, (n_ours, n_ref)
    assert abs(st.keyframes - st_ref.keyframes) <= 1, (st, st_ref)
    assert abs(st.landmarks - st_ref.landmarks) <= 0.15 * st_ref.landmarks, (st, st_ref)
    a, b = _ate(ours, seq), _ate(ref, seq)
    assert a <= max(1.5 * b, b + 0.02), (a, b)


def test_cli_then_lpslam_manager_localizes(tmp_path, seq, capsys):
    from lpslam_tpu_torch.interface import LpSlamManager
    from lpslam_tpu_torch.pipeline import cli

    map_file = str(tmp_path / "map.npz")
    path = _config_file(tmp_path, seq, map_file=map_file)
    traj, csv = str(tmp_path / "traj.txt"), str(tmp_path / "map.csv")
    rc = cli.main(["--config", path, "--device", "cpu", "--export-trajectory", traj,
                   "--export-map-csv", csv])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["error"] == "" and line["frames"] == N_FRAMES, line
    assert line["tracked"] > N_FRAMES // 3, line
    rows = open(csv).read().strip().splitlines()
    assert rows[0] == "x,y,z,n_obs" and len(rows) - 1 == line["landmarks"]
    assert len(open(traj).read().strip().splitlines()) == line["tracked"]
    assert os.path.exists(map_file)

    cfg = json.loads(open(path).read())
    cfg["datasources"] = []
    cfg["trackers"][0]["configuration"].update(mapping=False, chunk_size=8)
    loc = tmp_path / "loc.json"
    loc.write_text(json.dumps(cfg))
    lm = LpSlamManager(device="cpu")
    assert lm.read_configuration_file(str(loc))
    n_kf = lm._m.trackers[0].engine.n_keyframes
    assert lm._m.trackers[0].engine.status.name == "LOST"
    results = []
    lm.set_reconstruction_callback(results.append)
    lm.start()
    for t, img in enumerate(seq.images):
        u8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
        buf = np.repeat(u8[..., None], 3, axis=2) if t % 2 else u8
        while lm._m.camera_queue.qsize() >= 8:
            time.sleep(0.01)
        assert lm.add_image_from_buffer(t / 20.0, buf)
    lm.mapping_add_laser_scan(1.0, np.full(50, 2.0), -0.5, 0.02, 5.0)
    while not lm._m.camera_queue.empty():
        time.sleep(0.02)
    lm.stop()
    st = lm.get_slam_status()
    assert st.error == "" and st.frames_processed == N_FRAMES, st
    assert st.keyframes == n_kf
    assert sum(r.valid for r in results) >= N_FRAMES // 2
    assert lm.mapping_get_features_count() == st.landmarks
    assert (lm.mapping_get_map_raw()["grid"] == 100).any()


def test_camera_queue_drops_oldest_as_jax():
    from lpslam_tpu.pipeline.queues import PyBoundedQueue as JQueue
    from lpslam_tpu_torch.pipeline.queues import BoundedQueue

    kept = []
    for q in (BoundedQueue(maxsize=2), JQueue(maxsize=2)):
        for i in range(5):
            q.push(i)
        kept.append([q.pop(timeout=0.01) for _ in range(3)])
    assert kept[0] == kept[1] == [3, 4, None]


def test_worker_exception_shows_in_status():
    from lpslam_tpu_torch.pipeline.manager import SlamManager
    from lpslam_tpu_torch.pipeline.trackers import TrackerBase

    class Broken(TrackerBase):
        def process_image(self, entry, nav_odom=None, nav_map=None, sensor_values=()):
            raise RuntimeError("engine fault")

    mgr = SlamManager(device="cpu")
    mgr.add_tracker(Broken())
    mgr.start()
    mgr.add_image_from_buffer(0.0, np.zeros((8, 8), np.uint8))
    t0 = time.time()
    while mgr.get_status().error == "" and time.time() - t0 < 10:
        time.sleep(0.01)
    mgr.stop()
    assert "engine fault" in mgr.get_status().error


@contextlib.contextmanager
def _stub_cv2(fail: bool = False):
    """A stand-in `cv2` module in sys.modules whose imshow records (window,
    image) and waitKey records its delay; with `fail`, imshow raises as it
    does without a display."""
    stub = types.ModuleType("cv2")
    stub.shown, stub.waits = [], []

    def imshow(name, img):
        if fail:
            raise RuntimeError("no display")
        stub.shown.append((name, np.array(img)))

    stub.imshow = imshow
    stub.waitKey = stub.waits.append
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = stub
    try:
        yield stub
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved


def _show_frames(mgr, frames):
    """Push `frames` one at a time through a manager with show_live on and
    wait until each is processed."""
    mgr.show_live = True
    mgr.start()
    for i, img in enumerate(frames):
        mgr.add_image_from_buffer(i / 20.0, img)
        t0 = time.time()
        while mgr.get_status().frames_processed <= i and time.time() - t0 < 10:
            time.sleep(0.002)
    processed = mgr.get_status().frames_processed
    mgr.stop()
    return processed


def test_live_view_as_jax():
    """show_live shows frames 10, 20, ... as the JAX manager does (the same
    window, the same uint8 images, waitKey(1) after each), and a failing
    imshow turns the view off in both while every frame is still processed."""
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    from lpslam_tpu.pipeline.manager import SlamManager as JManager

    rng = np.random.default_rng(21)
    frames = [rng.integers(0, 256, (24, 32), dtype=np.uint8) for _ in range(25)]
    shown = {}
    for name, make in (("torch", lambda: SlamManager(device="cpu")), ("jax", JManager)):
        with _stub_cv2() as cv2:
            assert _show_frames(make(), frames) == len(frames)
        shown[name] = cv2
    port, ref = shown["torch"], shown["jax"]
    assert [n for n, _ in port.shown] == [n for n, _ in ref.shown] == ["lpslam"] * 2
    for (_, a), (_, b), want in zip(port.shown, ref.shown, (frames[9], frames[19])):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)
    assert port.waits == ref.waits == [1, 1]
    for make in (lambda: SlamManager(device="cpu"), JManager):
        mgr = make()
        with _stub_cv2(fail=True):
            assert _show_frames(mgr, frames) == len(frames)
        assert mgr.show_live is False


def test_refused_options_and_sources(tmp_path):
    from lpslam_tpu_torch.interface import LpSlamManager
    from lpslam_tpu_torch.pipeline import cli
    from lpslam_tpu_torch.pipeline.config import CameraConfig
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    from lpslam_tpu.pipeline.manager import SlamManager as JManager
    from lpslam_tpu_torch.pipeline.processors import CameraCalibrationProcessor
    from lpslam_tpu_torch.pipeline.sources import OpenCVCameraSource, ZedOpenCaptureSource

    # the live sources, calibration and fisheye Rectify are ported: they
    # build by name as in the JAX manager (ZedSdk without pyzed raises in both)
    mgr, ref = SlamManager(device="cpu"), JManager()
    for name, cls in (("OpenCV", OpenCVCameraSource), ("Zed", ZedOpenCaptureSource)):
        assert isinstance(mgr.add_source_by_name(name, {}), cls)
        assert type(ref.add_source_by_name(name, {})).__name__ == cls.__name__
    for m in (mgr, ref):
        with pytest.raises(RuntimeError, match="pyzed"):
            m.add_source_by_name("ZedSdk", {})
    assert isinstance(mgr.add_processor_by_name("CameraCalibration", {}),
                      CameraCalibrationProcessor)
    mgr.set_camera_configuration(CameraConfig(
        number=0, model="fisheye", fx=100.0, fy=100.0, cx=80.0, cy=60.0,
        distortion=np.zeros(4, np.float32), width=160, height=120))
    proc = mgr.add_processor_by_name("Rectify", {})
    assert proc._maps[0].shape == (120, 160, 2)
    # the live view is ported (test_live_view_as_jax): it no longer refuses
    # to start, and where imshow fails it turns itself off; record and
    # replay, JPEG input and the image callback are ported
    # (tests/test_torch_record.py)
    with _stub_cv2(fail=True):
        live = SlamManager(device="cpu")
        live.show_live = True
        live.start()
        live.stop()
        assert cli.main(["--synthetic", "--device", "cpu", "--show-live", "--frames", "12"]) == 0
    mgr = SlamManager(device="cpu")
    mgr.set_recording(True)
    assert mgr.add_image_from_buffer(0.0, None, compressed=b"\xff\xd8") is False
    lm = LpSlamManager(device="cpu")
    lm.set_record(True)
    lm.set_record_images(False)
    assert lm._m.recorder.record_images is False
    assert lm.read_replay_items(str(tmp_path / "missing.pb")) is False
    assert lm.compress_image(np.zeros((4, 4)))[:3] == b"\xff\xd8\xff"
    assert lm.add_image_data_source("ZedSdk", {}) is False    # the facade swallows it
    assert lm.add_image_data_source("Zed", {}) is True


def test_default_device_is_the_card():
    from lpslam_tpu_torch.eval import run_dataset
    from lpslam_tpu_torch.interface import LpSlamManager
    from lpslam_tpu_torch.pipeline import cli
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    missing = "cuda" if not torch.cuda.is_available() else f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(RuntimeError):
        SlamManager(device=missing)
    if not torch.cuda.is_available():
        for call in (SlamManager, LpSlamManager,
                     lambda: cli.main(["--synthetic", "--frames", "2"]),
                     lambda: run_dataset.main(["--bench", "room", "--frames", "2"])):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
