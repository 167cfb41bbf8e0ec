"""Standalone runner (port of lpslam_tpu/pipeline/cli.py): a config file or
the built-in synthetic demo, on `--device` (default cuda).

    python -m lpslam_tpu_torch.pipeline.cli --config cfg.json [--device cpu]
    python -m lpslam_tpu_torch.pipeline.cli --synthetic [--frames N] [--mode mono]

Both modes run until the finite sources are done and their frames are
processed, then print one JSON line: frames processed, valid results, the
final keyframe and landmark counts, the tracking state, the frame rate and
the last worker error ("" when none; the exit code is then 1). Both honour
--export-trajectory (TUM format, lpslam frame) and --export-map-csv.
--replay, --record, --record-no-video and --show-live are refused (ROADMAP
Queue 1 item 20).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def _refuse(flag: str):
    raise NotImplementedError(
        f"{flag} is not ported to lpslam_tpu_torch yet (ROADMAP Queue 1 item 20)")


def _wait_until_done(mgr, timeout_s: float, log=None):
    """Until every finite source is done and the camera queue is empty, or
    `timeout_s` passed."""
    t0 = time.time()
    finite = [s for s in mgr.sources if hasattr(s, "done")]
    while time.time() - t0 < timeout_s:
        time.sleep(0.1 if log is None else 1.0)
        if log is not None:
            st = mgr.get_status()
            log.info("state=%s kf=%d lm=%d fps=%.1f", st.localization, st.keyframes,
                     st.landmarks, st.fps)
        if finite and all(s.done for s in finite) and mgr.camera_queue.empty():
            return


def main(argv=None):
    p = argparse.ArgumentParser(description="lpslam_tpu_torch standalone runner")
    p.add_argument("--config", help="JSON configuration file")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--replay", help="replay a recorded .pb stream (refused)")
    p.add_argument("--record", action="store_true", help="record the session (refused)")
    p.add_argument("--record-no-video", action="store_true", help="(refused)")
    p.add_argument("--show-live", action="store_true", help="(refused)")
    p.add_argument("--store-images", metavar="DIR",
                   help="dump every 10th raw frame as PNG into DIR")
    p.add_argument("--logfile", help="log to file")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--verbose-debug", action="store_true")
    p.add_argument("--synthetic", action="store_true", help="run the built-in synthetic demo")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--mode", default="mono", choices=["mono", "stereo", "rgbd"])
    p.add_argument("--export-trajectory", help="write the trajectory (TUM format)")
    p.add_argument("--export-map-csv", help="write the landmark CSV")
    args = p.parse_args(argv)

    for flag, on in (("--replay", args.replay), ("--record", args.record),
                     ("--record-no-video", args.record_no_video),
                     ("--show-live", args.show_live)):
        if on:
            _refuse(flag)

    level = (logging.DEBUG if args.verbose_debug
             else logging.INFO if args.verbose else logging.WARNING)
    logging.basicConfig(level=level, filename=args.logfile,
                        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    log = logging.getLogger("lpslam")

    from .config import CameraConfig
    from .manager import SlamManager

    results = []
    mgr = SlamManager(device=args.device)
    if args.synthetic:
        src = mgr.add_source_by_name("Synthetic", {
            "num_frames": args.frames,
            "stereo_baseline": 0.2 if args.mode == "stereo" else 0.0,
            "with_depth": args.mode == "rgbd",
        })
        K = src.K
        mgr.set_camera_configuration(CameraConfig(
            number=0, model="no_distortion", fx=float(K[0, 0]), fy=float(K[1, 1]),
            cx=float(K[0, 2]), cy=float(K[1, 2]), focal_x_baseline=float(K[0, 0]) * 0.2,
        ))
        mgr.add_tracker_by_name("VSLAM", {"mode": args.mode})
    elif args.config:
        mgr.read_configuration_file(args.config)
    else:
        p.error("--config or --synthetic required")
    mgr.on_reconstruction = results.append
    mgr.store_images_dir = args.store_images
    mgr.start()
    log.info("running")
    try:
        # the synthetic demo gives up after 900 s; a config runs until its
        # finite sources are done (or Ctrl-C)
        if args.synthetic:
            _wait_until_done(mgr, 900.0)
        else:
            _wait_until_done(mgr, float("inf"), log)
    except KeyboardInterrupt:
        pass
    mgr.stop()
    st = mgr.get_status()
    print(json.dumps({
        "frames": st.frames_processed,
        "tracked": sum(1 for r in results if r.valid),
        "keyframes": st.keyframes,
        "landmarks": st.landmarks,
        "state": st.localization,
        "fps": round(st.fps, 2),
        "error": st.error,
    }))
    if args.export_trajectory:
        with open(args.export_trajectory, "w") as f:
            for r in results:
                if r.valid:
                    q = r.orientation_wxyz
                    f.write(f"{r.timestamp} {r.position[0]} {r.position[1]} "
                            f"{r.position[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")
    if args.export_map_csv:
        mgr.mapping_export_csv(args.export_map_csv)
    return 1 if st.error else 0


if __name__ == "__main__":
    sys.exit(main())
