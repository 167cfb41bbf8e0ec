"""The JAX package's long-run soak on the CPU, on the bytes the port's soak
drives: the reference for tools/soak_torch_long_run.py.

    JAX_PLATFORMS=cpu python tools/jax_soak_reference.py [--frames 2048] [--out FILE]

(The port tool's options, but --device.)

Renders the room with the port's numpy renderer (soak_torch_long_run.render:
uint8 frames, the same bytes as on the card) and undistorts every frame
with the JAX `remap_bilinear` on the port's grid (the RectifyProcessor that
eval/run_dataset.py::build_rectifier(intr, "mono") builds, taken on the
CPU), then drives a JAX `VSLAMTracker` with soak_torch_long_run.soak_config
(mono, 1200 keypoints, 3 levels, MapConfig(128, 24576), chunks of 16, loop
closure with the shipped vocabulary, synchronous) over them once. Prints
the port tool's keys (its checks on this drive; the fps windows are the
CPU's host clock, not a device's). ~20-40 min and a few GB on the CPU.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import soak_torch_long_run as soak  # noqa: E402  (configuration, drive, summary)


def main(argv=None) -> int:
    args = soak.parser(device=False).parse_args(argv)

    import jax
    import jax.numpy as jnp

    import chip_smoke as smoke
    from lpslam_tpu.backend import ba
    from lpslam_tpu.eval import ate_rmse
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.loop import detector
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker
    from lpslam_tpu_torch.eval.run_dataset import build_rectifier

    t0 = time.perf_counter()
    ds, raw = soak.render(args.frames, args.height, args.width)
    render_s = time.perf_counter() - t0
    print(f"rendered {len(raw)} frames in {render_s:.1f} s", file=sys.stderr, flush=True)
    proc, _, _ = build_rectifier(ds.intr, "mono", device="cpu")
    grid = jnp.asarray(proc._maps[0].numpy())
    remap = jax.jit(lambda im: remap_bilinear(im, grid))

    def frame(i):
        return np.asarray(remap(jnp.asarray(raw[i], jnp.float32)))

    K = proc.K_new
    tracker = VSLAMTracker(PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                           soak.soak_config(args.keypoints))
    timed = smoke._Timed(None)
    soak.timed_loop_calls(timed, {"detector": detector, "ba": ba})
    verdicts, undo = smoke.record_closures(detector.LoopCloser)
    try:
        windows, occupancy, wall = soak.soak_drive(tracker, frame, len(raw), args.window,
                                                   lambda: None, CameraQueueEntry, ds.fps)
    finally:
        undo()
        timed.undo()
    r = soak.summarize(tracker.engine, ds.ground_truth().positions, len(raw), windows,
                       occupancy, wall, ate_rmse, np.asarray)
    r["closures"] = [list(v[:2] + v[3:4]) for v in verdicts if v[4]]
    r["verdicts_named_candidate"] = len(verdicts)
    r["loop_calls"] = timed.summary()
    r["map"] = soak.map_bytes(tracker.engine.map, r["closures"], np.asarray)
    tracker.stop()
    out = soak.report([r], args, "cpu (JAX)", f"jax {jax.__version__}", render_s)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
