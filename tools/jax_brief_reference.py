"""The JAX package's descriptor modes on the frames and configuration of
chip_smoke.py's phase 16, on the CPU: the reference that sets its bounds.

    JAX_PLATFORMS=cpu python tools/jax_brief_reference.py [--modes binned,gather,exact]

Renders the room of phases 7-8 (chip_smoke.LOOP_FRAMES frames, the port's
numpy renderer and undistortion grid, so both packages see the same bytes)
and drives its first chip_smoke.BRIEF_FRAMES frames through a JAX
`VSLAMTracker` with chip_smoke.BRIEF_CONFIG (mono, 1200 keypoints, 3
levels, MapConfig(128, 24576, 1200), chunks of 16, no loop closure) and
each `brief_mode`; the grid goes to its chunk path through
`attach_device_rectify`, and frames headed for its host path are
undistorted with the JAX `remap_bilinear` (chip_smoke.drive_room). Prints
one JSON line {mode: chip_smoke.brief_metrics(...)}: frames fed, the
initialization frame, tracked frames and their share after it, keyframes
and the Sim3 ATE over the trajectory. Some minutes and ~3 GB.
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

import chip_smoke as smoke  # noqa: E402  (the phase's constants and frame feeding)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--modes", default=",".join(smoke.BRIEF_MODES))
    args = p.parse_args(argv)

    import jax.numpy as jnp

    from lpslam_tpu.frontend.tracker import TrackerStatus
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker

    t0 = time.perf_counter()
    raw, gt, K, grid = smoke.render_room()
    raw = raw[:smoke.BRIEF_FRAMES]
    print(f"rendered the room in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    grid_j = jnp.asarray(grid)

    def rectified(t):
        return np.asarray(remap_bilinear(jnp.asarray(raw[t], jnp.float32), grid_j))

    out = {}
    for mode in args.modes.split(","):
        cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        tracker = VSLAMTracker(cam, dict(smoke.BRIEF_CONFIG, brief_mode=mode))
        tracker.attach_device_rectify(grid)
        t0 = time.perf_counter()
        fed = smoke.drive_room(tracker, TrackerStatus.TRACKING, CameraQueueEntry, raw, rectified)
        out[mode] = {**smoke.brief_metrics(tracker.engine, gt, fed),
                     "seconds_cpu": time.perf_counter() - t0}
        tracker.stop()
        print(mode + " " + json.dumps(out[mode]), file=sys.stderr, flush=True)
    print(json.dumps({**out, "device": "cpu (JAX)"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
