"""The long-run soak of the PyTorch port: tools/soak_long_run.py's drive,
through lpslam_tpu_torch on the card.

    python3 tools/soak_torch_long_run.py [--frames 2048] [--out FILE]
    python3 tools/soak_torch_long_run.py --device cpu --frames 96 --width 160 \\
        --height 120 --keypoints 256 --window 16

Renders the room once as uint8 frames (`SyntheticBenchmark(seed=0,
turns=1.08 * frames / 600)`, 640x480 by default; the ray casting spread
over processes, the bytes those of iterating the sequence), then
drives it twice. Each drive feeds every frame through
eval/run_dataset.py::build_rectifier(intr, "mono") (the RectifyProcessor
undistorts it on the device) into a VSLAMTracker: mono, 1200 keypoints, 3
levels, MapConfig(128, 24576), chunks of 16, loop closure with the shipped
vocabulary. That is the JAX tool's configuration with one change: loop
closing runs synchronously (`loop_async=False`), because a verdict from the
background worker lands at whichever chunk boundary finds it done, and
then two drives cannot be compared bit for bit.

Checks, the JAX tool's one for one, on every drive: no NaN pose, the map
finite (keyframe poses and valid landmarks), keyframe and landmark
occupancy under capacity at every --window-frame sample, tracked >= 0.95
of the frames, last-quartile frames/s >= 0.7 x the first quartile's. Each
window's clock reading follows a device synchronize. Added: the drives'
final maps (kf_R, kf_t, lm_pos, accepted closures) equal bit for bit, and
at the default frames, size and keypoints every drive's tracked fraction
within 0.02 of JAX's soak on the same bytes (JAX_SOAK_REF, pinned from
tools/jax_soak_reference.py; rerun it if the drive changes). The
last line is one JSON object (the JAX tool's keys for the first drive,
unrounded, plus the accepted closures, the loop calls' synchronized ms,
every drive's windows and the equality); --out writes it too. Exits 1 when
a check fails. On an H100 the render and two drives take ~5 min; without
--device it needs CUDA.

--save-closure DIR: in the first drive, the state just before its first
accepted closure is applied, saved with chip_smoke.save_closure_states
(`DIR/soak_k<k_new>_{map,verdict,engine}.npz`), for
`tools/jax_closure_reference.py --track-on` to track on from it on the CPU
in both packages. The save wraps LoopCloser.apply outside its timer, but
inside the drive: that drive's windows include its seconds
(`closure_state_saved` in the drive's line).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

MAP_KEYS = ("kf_R", "kf_t", "lm_pos")
DRIVES = 2   # the second drive must leave the first's map bit for bit
MAX_KEYFRAMES, MAX_LANDMARKS = 128, 24576   # MapConfig(128, 24576)
CHUNK = 16
# the loop closer's calls timed per drive: (owner path, attribute, key)
LOOP_CALLS = (("detector.LoopCloser", "add_keyframe", "bow_add"),
              ("detector.LoopCloser", "detect", "bow_detect"),
              ("detector.LoopCloser", "verify", "verify"),
              ("detector", "correct_loop", "correct_loop"),
              ("ba", "global_ba", "global_ba"))
# tools/jax_soak_reference.py on the CPU at the default configuration, on
# the bytes this tool renders (jax 0.9.0): the card's tracked fraction must
# lie within TRACKED_TOL of it; the rest is reported beside the card's
TRACKED_TOL = 0.02
JAX_SOAK_REF = {"frames": 2048, "size": [480, 640], "keypoints": 1200,
                "tracked": 2045, "closures": [[100, 6, 75], [119, 53, 122], [120, 22, 44]],
                "max_keyframes_seen": 122, "max_landmarks_seen": 16203,
                "ate_rmse_sim3": 0.3730419550469622}


def soak_config(keypoints: int) -> dict:
    """tools/soak_long_run.py's VSLAMTracker configuration, closing loops
    synchronously."""
    return {"mode": "mono", "keypoints": keypoints, "levels": 3,
            "max_keyframes": MAX_KEYFRAMES, "max_landmarks": MAX_LANDMARKS,
            "loop_closure": True, "loop_async": False, "chunk_size": CHUNK}


def quartile_fps(windows) -> tuple:
    """Mean frames/s of the first and the last quarter of the windows (at
    least one window each), as tools/soak_long_run.py takes them."""
    q = max(len(windows) // 4, 1)
    return float(np.mean(windows[:q])), float(np.mean(windows[-q:]))


def jax_reference(args):
    """JAX_SOAK_REF when the run has its configuration, else None."""
    ref = JAX_SOAK_REF
    same = (args.frames == ref["frames"] and [args.height, args.width] == ref["size"]
            and args.keypoints == ref["keypoints"])
    return ref if same else None


def soak_checks(r: dict, ref=None) -> dict:
    """tools/soak_long_run.py's five checks on one drive's summary; with a
    JAX reference also the tracked fraction within TRACKED_TOL of its."""
    checks = {
        "no_nan_poses": r["nan_poses"] == 0,
        "map_finite": r["map_finite"],
        "capacity_held": (len(r["occupancy"]) > 0
                          and r["max_keyframes_seen"] < MAX_KEYFRAMES
                          and r["max_landmarks_seen"] < MAX_LANDMARKS),
        "tracked_frac_ge_095": r["tracked_frac"] >= 0.95,
        "fps_stable": r["fps_last_quartile"] >= 0.7 * r["fps_first_quartile"],
    }
    if ref is not None:
        checks["tracked_within_002_of_jax"] = (
            abs(r["tracked_frac"] - ref["tracked"] / ref["frames"]) <= TRACKED_TOL)
    return checks


def maps_equal(a: dict, b: dict) -> dict:
    """Per part, whether two drives' final maps are equal bit for bit."""
    return {k: a[k] == b[k] for k in a}


def map_bytes(m, closures, to_np) -> dict:
    return {**{k: to_np(getattr(m, k)).tobytes() for k in MAP_KEYS},
            "closures": json.dumps(closures)}


def summarize(eng, gt_pos, frames: int, windows, occupancy, wall_s, ate_rmse, to_np) -> dict:
    """A drive's readings, under tools/soak_long_run.py's keys (unrounded)."""
    est, fids, n_bad = [], [], 0
    for fid, pose, _ in eng.trajectory:
        if pose is None:
            continue
        c = -np.asarray(pose.R).T @ np.asarray(pose.t)
        if not np.all(np.isfinite(c)):
            n_bad += 1
            continue
        est.append(c)
        fids.append(fid)
    m = eng.map
    n_kf = int(m.n_kf)
    valid = to_np(m.lm_valid).astype(bool)
    map_finite = bool(np.all(np.isfinite(to_np(m.kf_R)[:n_kf]))
                      and np.all(np.isfinite(to_np(m.kf_t)[:n_kf]))
                      and np.all(np.isfinite(to_np(m.lm_pos)[valid])))
    first, last = quartile_fps(windows) if windows else (float("nan"), float("nan"))
    ate = None
    if len(est) > 10:
        ate = float(ate_rmse(np.asarray(est), gt_pos[np.asarray(fids)], with_scale=True)[0])
    return {
        "wall_s": wall_s,
        "mean_fps": frames / wall_s,
        "fps_windows": windows,
        "fps_first_quartile": first,
        "fps_last_quartile": last,
        "tracked": len(est),
        "tracked_frac": len(est) / frames,
        "nan_poses": n_bad,
        "occupancy": occupancy,
        "max_keyframes_seen": max((o["n_kf"] for o in occupancy), default=0),
        "max_landmarks_seen": max((o["n_lm"] for o in occupancy), default=0),
        "final_keyframes": int(eng.n_keyframes),
        "final_landmarks": int(eng.n_landmarks),
        "map_finite": map_finite,
        "ate_rmse_sim3": ate,
    }


def soak_drive(tracker, frame, n: int, window: int, sync, entry_cls, fps: float) -> tuple:
    """Feed frames 0..n-1 (`frame(i)`: the undistorted image) to the tracker
    and flush it; every `window` frames a synchronized clock reading and
    the map's occupancy. Returns (windows frames/s, occupancy, wall s)."""
    windows, occupancy = [], []
    sync()
    t_start = win_t0 = time.perf_counter()
    for i in range(n):
        tracker.process_image(entry_cls(timestamp=i / fps, image=frame(i)))
        if (i + 1) % window == 0:
            sync()
            now = time.perf_counter()
            windows.append(window / (now - win_t0))
            win_t0 = now
            eng = tracker.engine
            occupancy.append({"frame": i + 1, "n_kf": int(eng.n_keyframes),
                              "n_lm": int(eng.n_landmarks)})
            print(f"frame {i + 1}/{n}: {windows[-1]:.2f} frames/s, kf "
                  f"{occupancy[-1]['n_kf']}/{MAX_KEYFRAMES}, lm "
                  f"{occupancy[-1]['n_lm']}/{MAX_LANDMARKS}",
                  file=sys.stderr, flush=True)
    tracker.flush()
    sync()
    return windows, occupancy, time.perf_counter() - t_start


def render(frames: int, h: int, w: int):
    """(dataset, uint8 frames (T, H, W)) of the soak's room."""
    from lpslam_tpu_torch.io import SyntheticBenchmark

    ds = SyntheticBenchmark(num_frames=frames, h=h, w=w, seed=0, turns=1.08 * frames / 600.0)
    return ds, ds.render_uint8()


def timed_loop_calls(timed, modules) -> None:
    """Wrap LOOP_CALLS of the given {name: module} in chip_smoke._Timed."""
    for path, name, key in LOOP_CALLS:
        head, *rest = path.split(".")
        owner = modules[head]
        for part in rest:
            owner = getattr(owner, part)
        timed.wrap(owner, name, key)


def run_port(raw, ds, device, args) -> dict:
    """Every drive of the port: a summary each, with the map's bytes."""
    import torch

    import chip_smoke as smoke
    from lpslam_tpu_torch.backend import ba
    from lpslam_tpu_torch.eval import ate_rmse
    from lpslam_tpu_torch.eval.run_dataset import build_rectifier
    from lpslam_tpu_torch.loop import detector
    from lpslam_tpu_torch.mapstore.checkpoint import save_map
    from lpslam_tpu_torch.pipeline import CameraQueueEntry, VSLAMTracker

    def to_np(x):
        return x.detach().cpu().numpy()

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    proc, cam, _ = build_rectifier(ds.intr, "mono", device=device)

    def frame(i):
        return proc.process_image(CameraQueueEntry(timestamp=i / ds.fps, image=raw[i])).image

    gt = ds.ground_truth().positions
    drives = []
    for d in range(DRIVES):
        tracker = VSLAMTracker(cam, soak_config(args.keypoints), device=device)
        timed = smoke._Timed(device)
        timed_loop_calls(timed, {"detector": detector, "ba": ba})
        verdicts, undo = smoke.record_closures(detector.LoopCloser)
        saved, undo_save = [], (lambda: None)
        if d == 0 and getattr(args, "save_closure", ""):
            os.makedirs(args.save_closure, exist_ok=True)
            room = {"kind": "soak", "frames": len(raw), "size": [args.height, args.width]}
            saved, undo_save = smoke.save_closure_states(
                detector.LoopCloser, args.save_closure, "soak", gt, save_map, to_np,
                tracker_of=lambda: tracker, room=room)
        try:
            windows, occupancy, wall = soak_drive(tracker, frame, len(raw), args.window, sync,
                                                  CameraQueueEntry, ds.fps)
        finally:
            undo_save()
            undo()
            timed.undo()
        r = summarize(tracker.engine, gt, len(raw), windows, occupancy, wall, ate_rmse, to_np)
        r["closures"] = [list(v[:2] + v[3:4]) for v in verdicts if v[4]]
        r["verdicts_named_candidate"] = len(verdicts)
        if saved:
            r["closure_state_saved"] = saved
        r["loop_calls"] = timed.summary()
        r["map"] = map_bytes(tracker.engine.map, r["closures"], to_np)
        tracker.stop()
        del tracker
        print(f"drive {d + 1}: " + json.dumps({k: v for k, v in r.items() if k != "map"}),
              file=sys.stderr, flush=True)
        drives.append(r)
    return drives


def report(drives, args, platform: str, device_name: str, render_s: float,
           ref=None) -> dict:
    """The last line: the first drive's readings under the JAX tool's keys,
    the checks over every drive (against `ref`, JAX's soak, where given),
    and the maps' equality."""
    head = drives[0]
    checks_each = [soak_checks(r, ref) for r in drives]
    checks = {k: all(c[k] for c in checks_each) for k in checks_each[0]}
    same = [maps_equal(head["map"], r["map"]) for r in drives[1:]]
    if same:
        checks["drives_maps_equal"] = all(all(s.values()) for s in same)
    out = {
        "metric": "long_run_soak",
        "platform": platform,
        "device": device_name,
        "frames": args.frames,
        "size": [args.height, args.width],
        "chunk": CHUNK,
        "keypoints": args.keypoints,
        "orbit_turns": 1.08 * args.frames / 600.0,
        "map_capacity": {"max_keyframes": MAX_KEYFRAMES, "max_landmarks": MAX_LANDMARKS},
        "loop_async": False,
        "render_s": render_s,
        **{k: v for k, v in head.items() if k != "map"},
        "drives": [{k: r[k] for k in ("wall_s", "fps_windows", "fps_first_quartile",
                                      "fps_last_quartile", "tracked", "closures",
                                      "max_keyframes_seen", "max_landmarks_seen",
                                      "ate_rmse_sim3", "loop_calls")} for r in drives],
        "maps_equal": same,
        "jax_ref": ref,
        "checks_per_drive": checks_each,
        "checks": checks,
    }
    out["ok"] = all(checks.values())
    return out


def parser(device: bool = True) -> argparse.ArgumentParser:
    """The soak's options (tools/jax_soak_reference.py takes them too, but
    --device)."""
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=2048)
    p.add_argument("--keypoints", type=int, default=1200)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--window", type=int, default=128, help="frames per fps sample")
    if device:
        p.add_argument("--device", default="cuda")
        p.add_argument("--save-closure", default="", help="directory for the first closure's state")
    p.add_argument("--out", default="")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("soak_torch_long_run: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)

    name = "cpu"
    if device.type == "cuda":
        from lpslam_tpu_torch import _cuda

        name = smoke.card_line()
        print(name, flush=True)
        _cuda.load_libraries(["patch.cu", "fast_nms.cu", "hamming.cu"])
    t0 = time.perf_counter()
    ds, raw = render(args.frames, args.height, args.width)
    render_s = time.perf_counter() - t0
    print(f"rendered {len(raw)} frames in {render_s:.1f} s", file=sys.stderr, flush=True)
    out = report(run_port(raw, ds, device, args), args, device.type, name, render_s,
                 jax_reference(args))
    ref = out["jax_ref"] or {}
    for d, r in enumerate(out["drives"]):
        print(f"drive {d + 1}: closures (k_new, candidate, inliers) {r['closures']} (JAX CPU "
              f"{ref.get('closures', 'not pinned at this configuration')})", flush=True)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
