"""Dataset evaluation runner (port of lpslam_tpu/eval/run_dataset.py), on
`--device` (default cuda):

    python -m lpslam_tpu_torch.eval.run_dataset --bench room --mode stereo --loop --chunk 16
    python -m lpslam_tpu_torch.eval.run_dataset --euroc DIR --mode stereo
    python -m lpslam_tpu_torch.eval.run_dataset --tum DIR --mode rgbd

Drives the tracker stage (VSLAMTracker: engine, loop closing and
relocalization) with undistortion or rectification in the frame path
(RectifyProcessor, the grids on the device), aligns the trajectory with the
ground truth and prints one JSON line: ATE RMSE (Sim3 for mono, without
scale otherwise) and frames/s. `--bench room` is the ray-cast room of
io/benchmark.py. `--brief-mode` picks the descriptor path (polar, binned,
gather, exact: kernels/orb.py).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_rectifier(intr, mode, stereo_extrinsics=None, *, device):
    """In-path undistortion or rectification from dataset intrinsics.
    Returns (processor or None, camera for the tracker, focal_x_baseline)."""
    from ..geometry import PinholeCamera
    from ..pipeline.config import CameraConfig
    from ..pipeline.rectify import RectifyProcessor

    dist = np.asarray(intr.get("dist", np.zeros(5)), np.float64)
    has_dist = np.any(dist != 0)
    fxb = intr.get("fx", 0.0) * intr.get("baseline", 0.0)

    if mode == "stereo":
        R_rl, t_rl = (
            stereo_extrinsics if stereo_extrinsics is not None
            else (np.eye(3), np.array([-intr.get("baseline", 0.11), 0.0, 0.0]))
        )
        cam_l = CameraConfig(
            number=0, model=intr.get("model", "perspective"),
            fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
            distortion=dist, width=intr["width"], height=intr["height"],
            rotation=np.asarray(R_rl), translation=np.asarray(t_rl),
        )
        intr_r = dict(intr.get("right", intr))
        cam_r = CameraConfig(
            number=1, model=intr.get("model", "perspective"),
            fx=intr_r["fx"], fy=intr_r["fy"], cx=intr_r["cx"], cy=intr_r["cy"],
            distortion=np.asarray(intr_r.get("dist", dist), np.float64),
            width=intr["width"], height=intr["height"],
        )
        proc = RectifyProcessor(camera=cam_l, camera_right=cam_r, device=device)
        K = proc.K_new
        cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device=device)
        return proc, cam, proc.focal_x_baseline
    if has_dist:
        proc = RectifyProcessor(camera=CameraConfig(
            number=0, model=intr.get("model", "perspective"),
            fx=intr["fx"], fy=intr["fy"], cx=intr["cx"], cy=intr["cy"],
            distortion=dist, width=intr["width"], height=intr["height"],
        ), device=device)
        K = proc.K_new
        cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device=device)
        return proc, cam, fxb
    cam = PinholeCamera.make(intr["fx"], intr["fy"], intr["cx"], intr["cy"], device=device)
    return None, cam, fxb


def parse_range(spec):
    if not spec:
        return None
    a, b = spec.split(":")
    return int(a), int(b)


def degrade(img, idx, blackout, low_tex):
    """Zero the frame inside `blackout`; inside `low_tex` wipe the detail
    (a 13x13 box blur from two cumulative sums) and crush the contrast."""
    if blackout and blackout[0] <= idx <= blackout[1]:
        return np.zeros_like(img)
    if low_tex and low_tex[0] <= idx <= low_tex[1]:
        k = 13
        pad = np.pad(img.astype(np.float32), k // 2, mode="edge")
        c = np.cumsum(np.cumsum(pad, 0), 1)
        c = np.pad(c, ((1, 0), (1, 0)))
        h_, w_ = img.shape
        blur = (c[k:k + h_, k:k + w_] - c[:h_, k:k + w_]
                - c[k:k + h_, :w_] + c[:h_, :w_]) / (k * k)
        return (128.0 + (blur - 128.0) * 0.2).astype(img.dtype)
    return img


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tum", help="TUM RGB-D sequence directory")
    p.add_argument("--euroc", help="EuRoC MAV sequence directory")
    p.add_argument("--bench", help="synthetic benchmark name: room")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--mode", default="mono", choices=["mono", "stereo", "rgbd"])
    p.add_argument("--keypoints", type=int, default=1200)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--brief-mode", default="polar", dest="brief_mode",
                   choices=["polar", "binned", "gather", "exact"])
    p.add_argument("--frames", type=int, default=0, dest="max_frames")
    p.add_argument("--max-keyframes", type=int, default=128)
    p.add_argument("--max-landmarks", type=int, default=24576)
    p.add_argument("--loop", action="store_true", help="enable loop closure")
    p.add_argument("--global-ba", type=int, default=5, dest="global_ba",
                   help="LM iterations of full-map BA after an accepted loop; 0 "
                        "disables; only with --loop")
    p.add_argument("--local-ba-iters", type=int, default=0, dest="local_ba_iters",
                   help="LM iterations of windowed local BA (0 = engine default)")
    p.add_argument("--vocab", default="", help="vocabulary file (default: the shipped one)")
    p.add_argument("--chunk", type=int, default=0,
                   help="chunk size: >= 2 runs steady tracking through the chunk "
                        "loop; 0 = per-frame host loop")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--no-distortion", action="store_true")
    p.add_argument("--turns", type=float, default=1.08,
                   help="benchmark orbit turns (1.08 closes the loop)")
    p.add_argument("--export-trajectory", help="TUM-format trajectory output")
    p.add_argument("--json-out", help="also write the result JSON to this path")
    p.add_argument("--blackout", metavar="A:B", help="zero frames A..B")
    p.add_argument("--low-texture", metavar="A:B", dest="low_texture",
                   help="degrade frames A..B to low texture")
    args = p.parse_args(argv)

    from ..eval import ate_rmse
    from ..io.datasets import (
        EUROC_CAM0, EUROC_CAM1, TUM_FR1, EurocDataset, TumRgbdDataset,
        euroc_stereo_extrinsics,
    )
    from ..pipeline.manager import require_device
    from ..pipeline.queues import CameraQueueEntry
    from ..pipeline.trackers import VSLAMTracker

    device = require_device(args.device)
    stereo_ext = None
    if args.tum:
        ds = TumRgbdDataset(args.tum, with_depth=args.mode == "rgbd")
        intr = TUM_FR1
    elif args.euroc:
        ds = EurocDataset(args.euroc, stereo=args.mode == "stereo")
        intr = dict(EUROC_CAM0)
        intr["right"] = EUROC_CAM1
        stereo_ext = euroc_stereo_extrinsics()
    elif args.bench:
        from ..io.benchmark import SyntheticBenchmark

        nf = args.max_frames or 600
        ds = SyntheticBenchmark(
            num_frames=nf, h=args.height, w=args.width, seed=args.seed,
            stereo=args.mode == "stereo", with_depth=args.mode == "rgbd",
            distortion=not args.no_distortion,
            # --turns is for the 600-frame design length: keep the per-frame
            # motion rate on other lengths
            turns=args.turns * nf / 600.0,
        )
        intr = ds.intr
    else:
        p.error("--tum, --euroc or --bench required")

    proc, cam, fxb = build_rectifier(intr, args.mode, stereo_ext, device=device)
    tracker = VSLAMTracker(cam, {
        "mode": args.mode,
        "keypoints": args.keypoints,
        "levels": args.levels,
        "brief_mode": args.brief_mode,
        "max_keyframes": args.max_keyframes,
        "max_landmarks": args.max_landmarks,
        "focal_x_baseline": fxb if args.mode == "stereo" else 0.0,
        "loop_closure": bool(args.loop),
        "loop_global_ba_iters": args.global_ba if args.loop else 0,
        "vocab_file": args.vocab,
        "chunk_size": args.chunk,
        "local_ba_iters": args.local_ba_iters,
    }, device=device)
    blackout = parse_range(args.blackout)
    low_tex = parse_range(args.low_texture)

    timestamps = []
    rectify_s = read_s = 0.0
    t_start = time.perf_counter()
    n = 0
    frames = iter(ds)
    while True:
        t0 = time.perf_counter()
        frame = next(frames, None)
        read_s += time.perf_counter() - t0
        if frame is None:
            break
        entry = CameraQueueEntry(
            timestamp=frame.timestamp,
            image=degrade(frame.image, n, blackout, low_tex),
            image_second=(degrade(frame.image_right, n, blackout, low_tex)
                          if frame.image_right is not None else None),
            aux=frame.depth,
        )
        if proc is not None:
            t0 = time.perf_counter()
            entry = proc.process_image(entry)
            rectify_s += time.perf_counter() - t0
        tracker.process_image(entry)
        timestamps.append(frame.timestamp)
        n += 1
        if n % 100 == 0:
            print(f"[eval] {n} frames, {n / (time.perf_counter() - t_start):.1f} fps",
                  file=sys.stderr, flush=True)
        if args.max_frames and n >= args.max_frames:
            break
    tracker.flush()  # deferred chunk results into the trajectory
    wall = time.perf_counter() - t_start
    tracker.stop()

    engine = tracker.engine
    est, ts_tracked = [], []
    for fid, pose, _st in engine.trajectory:
        if pose is None:
            continue
        est.append(-np.asarray(pose.R).T @ np.asarray(pose.t))
        ts_tracked.append(timestamps[fid] if fid < len(timestamps) else timestamps[-1])
    est = np.asarray(est)

    result = {
        "mode": args.mode,
        "loop_closure": bool(args.loop),
        "global_ba_iters": args.global_ba if args.loop else 0,
        "keypoints": args.keypoints,
        "frames": n,
        "tracked": len(est),
        "keyframes": engine.n_keyframes,
        "landmarks": engine.n_landmarks,
        "fps": round(n / max(wall, 1e-9), 2),
        # the dataset's own time (rendering or PNG decoding), inside `fps`
        "read_ms_per_frame": round(1e3 * read_s / max(n, 1), 3),
        "device": str(device),
    }
    if proc is not None:
        # host clock over the processor calls: upload, remap, read back
        result["rectify_ms_per_frame"] = round(1e3 * rectify_s / max(n, 1), 3)
    if blackout:
        result["blackout_frames"] = list(blackout)
    if low_tex:
        result["low_texture_frames"] = list(low_tex)
    gt = ds.ground_truth()
    if gt is not None and len(est) > 10:
        gt_pos = gt.positions_at(np.asarray(ts_tracked))
        rmse, _ = ate_rmse(est, gt_pos, with_scale=args.mode == "mono")
        result["ate_rmse"] = round(float(rmse), 4)

    if args.export_trajectory:
        with open(args.export_trajectory, "w") as f:
            for ts, c in zip(ts_tracked, est):
                f.write(f"{ts} {c[0]} {c[1]} {c[2]} 0 0 0 1\n")

    line = json.dumps(result)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
