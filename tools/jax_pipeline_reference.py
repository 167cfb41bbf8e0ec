"""The JAX package on the CPU with the configurations of chip_smoke.py's
phases 9-11: the reference that sets their bounds (JAX_PIPELINE_REF).

    JAX_PLATFORMS=cpu python tools/jax_pipeline_reference.py [--skip-room]

- phase 9: the JAX SlamManager on chip_smoke.pipeline_config (the synthetic
  source, 64 frames at 640x480, VSLAM mono at the operating point with a
  radial mask, loop closure, map emission and a map file), waited on as its
  CLI's config mode waits; the trajectory from its results (the JAX CLI's
  config mode writes no trajectory);
- phase 10: the JAX LpSlamManager localizing in that map from the same
  buffers (chip_smoke.feed_localization) with one laser scan;
- phase 11: `lpslam_tpu.eval.run_dataset` with chip_smoke.ROOM_ARGS, with
  the closures its LoopCloser accepts;
- phase 12: the JAX SlamManager records phase 9's session (OpenCV JPEG at
  quality 90; set_recording(True), as its CLI's --record) and replays the
  stream on phase 9's config without its source (the Replay source, as its
  CLI's --replay); the replay's trajectory from its results, and the
  stream's messages by type;
- phase 13 (--zed-only runs it alone): (a) the JAX SlamManager on
  examples/zed_live_record.json as shipped (recording on), its cv2.VideoCapture
  replaced by chip_smoke.ZedDouble serving chip_smoke.render_zed's frames
  (the port's renderer, so both packages see the same bytes), stopped once
  every frame is processed: tracked frames, Sim3 ATE, the gains its source
  set and the recording's messages; (b) the fisheye pair through the JAX
  `run_dataset.build_rectifier` and a stereo VSLAMTracker with the config's
  tracker options and no vocabulary file (trained lazily): tracked frames,
  ATE without scale, vocabulary words, closures. OpenCV 5.0's
  cv2.fisheye.initUndistortRectifyMap rejects the CV_32FC2 map type the JAX
  package asks for; this tool answers that call with CV_32F's two maps
  stacked (OpenCV 4.x's CV_32FC2 result), inside this process only.

Everything it renders comes from the JAX package (the synthetic sequence of
phases 9-10 from `lpslam_tpu.io.synthetic.make_sequence`, the room from
run_dataset's own benchmark); chip_smoke gives only the configurations and
the feeding. Prints one JSON line {"cli": ..., "localize": ..., "room": ...,
"replay": ..., "zed": ...}: tracked frames, keyframes, landmarks and ATE of
each, the room's accepted closures and the recording's messages. Rerun it
whenever those configurations change. Takes ~10 min and ~3 GB on the CPU
(--replay-only: phase 12 alone; --zed-only: phase 13 alone).
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402  (the phases' configurations and feeding)


def _wait_and_stop(mgr, timeout_s=3600.0):
    """As the CLI's config mode: until the finite sources are done and the
    camera queue is empty, then stop."""
    t0 = time.time()
    finite = [s for s in mgr.sources if hasattr(s, "done")]
    while time.time() - t0 < timeout_s:
        time.sleep(0.2)
        if finite and all(s.done for s in finite) and mgr.camera_queue.empty():
            break
    mgr.stop()


def jax_pipeline_sequence():
    """chip_smoke.pipeline_sequence, rendered by the JAX package: images and
    ground-truth centres."""
    from lpslam_tpu.io.synthetic import make_sequence

    seq = make_sequence(num_frames=smoke.PIPE_FRAMES, h=smoke.PIPE_SIZE[0],
                        w=smoke.PIPE_SIZE[1], seed=0)
    return seq.images, np.stack([np.asarray(p.t, np.float64) for p in seq.poses_wc]), seq.K


def record_replay(tmp, gt, K, SlamManager, ate_rmse) -> dict:
    """Phase 12 in the JAX package: record phase 9's session, replay it."""
    from lpslam_tpu.io import lpslam_pb as pb

    rec_dir, here = os.path.join(tmp, "record12"), os.getcwd()
    os.makedirs(rec_dir)
    cfg = smoke.pipeline_config(K, os.path.join(tmp, "map12.npz"))
    cfg_path = os.path.join(tmp, "phase12a.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    mgr = SlamManager()
    mgr.read_configuration_file(cfg_path)
    mgr.set_recording(True)
    os.chdir(rec_dir)                   # the recording goes to the cwd
    try:
        mgr.start()
        _wait_and_stop(mgr)
    finally:
        os.chdir(here)
    (name,) = [f for f in os.listdir(rec_dir) if f.endswith(".pb")]
    path = os.path.join(rec_dir, name)
    counts = {}
    with pb.ProtoStreamReader(path) as r:
        for t, _ in r:
            counts[t] = counts.get(t, 0) + 1
    cfg["datasources"] = []
    cfg["trackers"][0]["configuration"]["map_file"] = os.path.join(tmp, "map12b.npz")
    cfg_path = os.path.join(tmp, "phase12b.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    mgr = SlamManager()
    mgr.read_configuration_file(cfg_path)
    mgr.add_source_by_name("Replay", {"file": path})
    results = []
    mgr.on_reconstruction = results.append
    t0 = time.perf_counter()
    mgr.start()
    _wait_and_stop(mgr)
    st = mgr.get_status()
    stamped = [(r.timestamp, r.position) for r in results if r.valid]
    met = smoke.trajectory_metrics(stamped, gt, smoke.PIPE_FRAMES, ate_rmse)
    out = {**met, "frames": st.frames_processed, "keyframes": st.keyframes,
           "landmarks": st.landmarks, "state": st.localization, "error": st.error,
           "file_bytes": os.path.getsize(path),
           "messages": {"camera_image": counts.get(pb.MSG_CAMERA_IMAGE, 0),
                        "global_state": counts.get(pb.MSG_SENSOR_GLOBAL_STATE, 0),
                        "imu": counts.get(pb.MSG_SENSOR_IMU, 0),
                        "result": counts.get(pb.MSG_RESULT, 0)},
           "seconds": time.perf_counter() - t0}
    print("replay " + json.dumps(out), file=sys.stderr, flush=True)
    return out


def _fisheye_shim():
    """cv2.fisheye.initUndistortRectifyMap answering CV_32FC2 as OpenCV 4.x
    did, from OpenCV 5.0's CV_32F maps (stacked)."""
    import cv2

    orig = cv2.fisheye.initUndistortRectifyMap

    def init_map(K, D, R, P, size, m1type, *rest):
        if m1type == cv2.CV_32FC2:
            mx, my = orig(K, D, R, P, size, cv2.CV_32F)
            return np.stack([mx, my], axis=-1), None
        return orig(K, D, R, P, size, m1type, *rest)

    cv2.fisheye.initUndistortRectifyMap = init_map


def zed_reference(tmp) -> dict:
    """Phase 13 in the JAX package: (a) the config's session, (b) the
    rectified pair with lazy vocabulary training."""
    import cv2

    from lpslam_tpu.eval import ate_rmse
    from lpslam_tpu.eval.run_dataset import build_rectifier
    from lpslam_tpu.loop.detector import LoopCloser
    from lpslam_tpu.pipeline.manager import SlamManager
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker

    _fisheye_shim()
    left, right, gt = smoke.render_zed()
    n = len(left)
    out = {}

    double = smoke.ZedDouble(left, right)
    cv2.VideoCapture = double.capture
    rec_dir, here = os.path.join(tmp, "zed13a"), os.getcwd()
    os.makedirs(rec_dir)
    mgr = SlamManager()
    mgr.read_configuration_file(smoke.ZED_EXAMPLE)
    mgr.set_recording(mgr._record_enabled)
    results = []
    mgr.on_reconstruction = results.append
    t0 = time.perf_counter()
    os.chdir(rec_dir)
    try:
        mgr.start()
        last, still = -1, time.time()
        while True:
            time.sleep(0.2)
            done = mgr.get_status().frames_processed
            if done != last:
                last, still = done, time.time()
            if (len(double.served) >= n and mgr.camera_queue.empty()
                    and (done >= n or time.time() - still > 10.0)):
                break
        mgr.stop()
    finally:
        os.chdir(here)
    st = mgr.get_status()
    valid = [r for r in results if r.valid]
    idx = np.array([double.frame_of(r.timestamp) for r in valid], np.int64)
    est = np.array([r.position for r in valid], np.float64)
    first = int(idx.min()) if len(idx) else n
    (name,) = [f for f in os.listdir(rec_dir) if f.endswith(".pb")]
    counts = smoke.pb_counts(os.path.join(rec_dir, name))["counts"]
    out["cli"] = {"frames": st.frames_processed, "tracked": len(idx), "first_valid": first,
                  "after": n - first, "ate_m_sim3": float(ate_rmse(est, gt[idx])[0]),
                  "gains": [int(g) for g in double.gains], "messages": counts,
                  "keyframes": st.keyframes, "state": st.localization, "error": st.error,
                  "seconds": time.perf_counter() - t0}
    print("zed cli " + json.dumps(out["cli"]), file=sys.stderr, flush=True)

    K, D = smoke.zed_camera()
    h, w = smoke.ZED_SIZE
    intr = {"model": "fisheye", "fx": K[0, 0], "fy": K[1, 1], "cx": K[0, 2], "cy": K[1, 2],
            "dist": D, "width": w, "height": h, "baseline": smoke.ZED_BASELINE}
    proc, cam, fxb = build_rectifier(intr, "stereo",
                                     (np.eye(3), np.array([-smoke.ZED_BASELINE, 0.0, 0.0])))
    cfg = dict(smoke.zed_tracker_config(), focal_x_baseline=fxb,
               vocab_file=os.path.join(tmp, "no_vocabulary.npz"))
    tracker = VSLAMTracker(cam, cfg)
    verdicts, undo = smoke.record_closures(LoopCloser)
    t0 = time.perf_counter()
    try:
        for i in range(n):
            entry = CameraQueueEntry(timestamp=i / smoke.ZED_FPS,
                                     image=left[i].astype(np.float32),
                                     image_second=right[i].astype(np.float32))
            tracker.process_image(proc.process_image(entry))
        tracker.flush()
    finally:
        undo()
    eng = tracker.engine
    fids, est = [], []
    for fid, pose, _ in eng.trajectory:
        if pose is not None:
            fids.append(fid)
            est.append(-np.asarray(pose.R).T @ np.asarray(pose.t))
    lc = tracker.loop_closer
    tracker.stop()
    fids = np.asarray(fids, np.int64)
    out["rectified"] = {
        "K_new": np.asarray(proc.K_new).tolist(), "focal_x_baseline": float(fxb),
        "tracked": len(fids), "ate_m": float(ate_rmse(np.asarray(est), gt[fids],
                                                      with_scale=False)[0]),
        "keyframes": int(eng.n_keyframes), "state": eng.status.name,
        "vocab_words": None if lc is None else int(lc.vocab.words.shape[0]),
        "closures": [list(v[:2] + v[3:4]) for v in verdicts if v[4]],
        "seconds": time.perf_counter() - t0}
    print("zed rectified " + json.dumps(out["rectified"]), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--skip-room", action="store_true", help="no phase 11")
    p.add_argument("--replay-only", action="store_true", help="phase 12 only")
    p.add_argument("--zed-only", action="store_true", help="phase 13 only")
    args = p.parse_args(argv)

    from lpslam_tpu.eval import ate_rmse, run_dataset
    from lpslam_tpu.interface import LpSlamManager
    from lpslam_tpu.loop.detector import LoopCloser
    from lpslam_tpu.pipeline.manager import SlamManager

    images, gt, K = jax_pipeline_sequence()
    out = {"device": "cpu (JAX)"}
    with tempfile.TemporaryDirectory() as tmp:
        if args.zed_only:
            out["zed"] = zed_reference(tmp)
            print(json.dumps(out))
            return 0
        if args.replay_only:
            out["replay"] = record_replay(tmp, gt, K, SlamManager, ate_rmse)
            print(json.dumps(out))
            return 0
        map_file = os.path.join(tmp, "map.npz")
        cfg9 = os.path.join(tmp, "phase9.json")
        with open(cfg9, "w") as f:
            json.dump(smoke.pipeline_config(K, map_file), f)
        mgr = SlamManager()
        mgr.read_configuration_file(cfg9)
        results = []
        mgr.on_reconstruction = results.append
        t0 = time.perf_counter()
        mgr.start()
        _wait_and_stop(mgr)
        st = mgr.get_status()
        stamped = [(r.timestamp, r.position) for r in results if r.valid]
        met = smoke.trajectory_metrics(stamped, gt, smoke.PIPE_FRAMES, ate_rmse)
        out["cli"] = {**met,
                      "frames": st.frames_processed, "keyframes": st.keyframes,
                      "landmarks": st.landmarks, "state": st.localization,
                      "error": st.error, "seconds": time.perf_counter() - t0}
        print("cli " + json.dumps(out["cli"]), file=sys.stderr, flush=True)

        cfg10 = os.path.join(tmp, "phase10.json")
        with open(cfg10, "w") as f:
            json.dump(smoke.pipeline_config(K, map_file, localize=True), f)
        lm = LpSlamManager()
        assert lm.read_configuration_file(cfg10)
        n_kf = lm._m.trackers[0].engine.n_keyframes
        results = []
        lm.set_reconstruction_callback(results.append)
        t0 = time.perf_counter()
        lm.start()
        smoke.feed_localization(lm.add_image_from_buffer, lm._m.camera_queue.qsize, images)
        lm.mapping_add_laser_scan(smoke.PIPE_FRAMES / smoke.PIPE_FPS, np.linspace(1.0, 4.0, 181),
                                  -np.pi / 2, np.pi / 180, 8.0)
        while not lm._m.camera_queue.empty():
            time.sleep(0.05)
        lm.stop()
        st = lm.get_slam_status()
        stamped = [(r.timestamp, r.position) for r in results if r.valid]
        met = smoke.trajectory_metrics(stamped, gt, smoke.PIPE_FRAMES, ate_rmse)
        out["localize"] = {**met,
                           "frames": st.frames_processed, "keyframes": st.keyframes,
                           "keyframes_loaded": n_kf, "landmarks": st.landmarks,
                           "features": lm.mapping_get_features_count(), "error": st.error,
                           "results": len(results),
                           "timestamps_with_two_results": sorted(
                               {r.timestamp for r in results
                                if sum(q.timestamp == r.timestamp for q in results) > 1}),
                           "seconds": time.perf_counter() - t0}
        print("localize " + json.dumps(out["localize"]), file=sys.stderr, flush=True)

        if not args.skip_room:
            path = os.path.join(tmp, "room.json")
            t0 = time.perf_counter()
            verdicts, undo = smoke.record_closures(LoopCloser)
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    run_dataset.main(smoke.ROOM_ARGS + ["--json-out", path])
            finally:
                undo()
            with open(path) as f:
                out["room"] = {**json.loads(f.read()),
                               # accepted (k_new, candidate, n_inliers)
                               "closures": [[v[0], v[1], v[3]] for v in verdicts if v[4]],
                               "seconds": time.perf_counter() - t0}
        out["replay"] = record_replay(tmp, gt, K, SlamManager, ate_rmse)
        out["zed"] = zed_reference(tmp)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
