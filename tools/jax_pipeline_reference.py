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
  the closures its LoopCloser accepts.

Everything it renders comes from the JAX package (the synthetic sequence of
phases 9-10 from `lpslam_tpu.io.synthetic.make_sequence`, the room from
run_dataset's own benchmark); chip_smoke gives only the configurations and
the feeding. Prints one JSON line {"cli": ..., "localize": ..., "room": ...}:
tracked frames, keyframes, landmarks and ATE of each, and the room's
accepted closures. Rerun it whenever those configurations change. Takes
~9 min and ~3 GB on the CPU.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--skip-room", action="store_true", help="phases 9-10 only")
    args = p.parse_args(argv)

    from lpslam_tpu.eval import ate_rmse, run_dataset
    from lpslam_tpu.interface import LpSlamManager
    from lpslam_tpu.loop.detector import LoopCloser
    from lpslam_tpu.pipeline.manager import SlamManager

    images, gt, K = jax_pipeline_sequence()
    out = {"device": "cpu (JAX)"}
    with tempfile.TemporaryDirectory() as tmp:
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
