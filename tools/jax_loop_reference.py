"""The JAX package's loop closing and relocalization on the frames and
configuration of chip_smoke.py's phases 7-8, on the CPU: the reference
that sets their bounds.

    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py [--frames N]

Renders the room (chip_smoke.LOOP_FRAMES frames) with the port's numpy copy of the renderer and
takes the port's numpy undistortion grid, so both packages see the same
bytes. A JAX `VSLAMTracker` with chip_smoke.LOOP_CONFIG (mono, 1200
keypoints, 3 levels, MapConfig(128, 24576, 1200), loop closure with the
shipped vocabulary and 5 global-BA iterations, synchronous, chunks of 16)
gets the grid through `attach_device_rectify`; frames headed for its host
path are undistorted with the JAX `remap_bilinear` on the same grid
(chip_smoke.drive_room). Then phase 8: each of chip_smoke.KIDNAP_FRAMES
with the engine set LOST, through the host path.

Prints one JSON line: accepted closures as (k_new, candidate, n_inliers),
every verdict that named a candidate as (k_new, candidate, n_matches,
n_inliers, accepted), tracked frames, keyframes, Sim3 ATE over the
trajectory, and the relocalization outcomes.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402  (the phases' constants and frame feeding)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=smoke.LOOP_FRAMES)
    args = p.parse_args(argv)

    import jax.numpy as jnp

    from lpslam_tpu.frontend.tracker import TrackerStatus
    from lpslam_tpu.geometry import SE3, PinholeCamera
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.loop.detector import LoopCloser
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker

    t0 = time.perf_counter()
    raw, gt, K, grid = smoke.render_room(args.frames)
    print(f"rendered {len(raw)} frames in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    grid_j = jnp.asarray(grid)

    def rectified(t):
        return np.asarray(remap_bilinear(jnp.asarray(raw[t], jnp.float32), grid_j))

    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    tracker = VSLAMTracker(cam, dict(smoke.LOOP_CONFIG))
    tracker.attach_device_rectify(grid)
    verdicts, undo = smoke.record_closures(LoopCloser)
    t1 = time.perf_counter()
    try:
        fed = smoke.drive_room(tracker, TrackerStatus.TRACKING, CameraQueueEntry,
                               raw, rectified)
    finally:
        undo()
    loop_s = time.perf_counter() - t1
    eng = tracker.engine
    met = smoke.room_metrics(eng, gt)
    state = eng.status.name
    def blind_pose(pose):
        return SE3(pose.R, jnp.asarray([0.0, 0.0, -1e4], jnp.float32))

    reloc = smoke.kidnap(tracker, TrackerStatus.LOST, CameraQueueEntry, rectified, gt,
                         met["align"], np.asarray, blind_pose,
                         frames=[f for f in smoke.KIDNAP_FRAMES if f < len(raw)])
    print(json.dumps({
        "frames": fed,
        "turns": 1.08 * args.frames / 600.0,
        "tracked": met["tracked"],
        "keyframes": int(eng.n_keyframes),
        "landmarks": int(eng.n_landmarks),
        "closures": [v[:2] + v[3:4] for v in verdicts if v[4]],
        "verdicts": verdicts,
        "ate_m_sim3": met["ate_m"],
        "state": state,
        "relocalization": reloc,
        "loop_seconds": loop_s,
        "device": "cpu (JAX)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
