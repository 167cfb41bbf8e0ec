"""The BA damping x guarded-inverse ablation of the port, end to end on the
stereo room: tools/ablate_ba_robustness.py through lpslam_tpu_torch on the
card.

    python3 tools/ablate_ba_robustness_torch.py [--frames 600] [--out FILE]
    python3 tools/ablate_ba_robustness_torch.py --device cpu --mode mono \\
        --frames 16 --width 160 --height 120 --keypoints 256 \\
        --max-landmarks 2048 --out /tmp/ablation.json

Runs the eval of `python -m lpslam_tpu_torch.eval.run_dataset --bench room
--mode stereo --frames 600 --loop` once per configuration of CONFIGS (the
JAX tool's three: the shipped absolute damping with inv3x3_guarded's 1e12
gate, absolute with a tight 1e-2 gate, relative (Marquardt) damping with the
1e12 gate), each in a fresh process with LPSLAM_BA_DAMPING and
LPSLAM_BA_GUARD_TOL set, which backend/ba.py reads once at import. The
child (this file with --child) runs run_dataset's main and adds to its JSON
the values its backend/ba.py read (`ba_damping_read`, `ba_guard_tol_read`:
a hook that is not read cannot pass unseen) and the loop closures it
accepted, as (k_new, candidate, inliers). Each row holds the configuration,
the child's wall seconds and that JSON. The artifact goes to --out
(default chiprun_out/ABLATION_BA_torch.json) and to stdout as the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = [
    # (name, damping, guard_tol)
    ("shipped_absolute_tol1e12", "absolute", "1e12"),
    ("absolute_tight_tol1e-2", "absolute", "1e-2"),
    ("relative_marquardt_tol1e12", "relative", "1e12"),
]


def child(json_out: str, argv: list) -> int:
    """run_dataset's main in this process, then the hooks' values as read
    and the accepted closures added to its JSON."""
    from lpslam_tpu_torch.backend import ba
    from lpslam_tpu_torch.eval import run_dataset
    from lpslam_tpu_torch.loop.detector import LoopCloser

    closures = []
    orig = LoopCloser.apply

    def apply(self, m, verdict, cam=None):
        out = orig(self, m, verdict, cam=cam)
        r = verdict.result
        if bool(r.detected):
            closures.append([int(verdict.k_new), int(r.candidate), int(r.n_inliers)])
        return out

    LoopCloser.apply = apply
    try:
        rc = run_dataset.main(argv + ["--json-out", json_out])
    finally:
        LoopCloser.apply = orig
    with open(json_out) as f:
        res = json.load(f)
    res.update(ba_damping_read=ba._BA_DAMPING, ba_guard_tol_read=ba._BA_GUARD_TOL,
               closures=closures)
    with open(json_out, "w") as f:
        json.dump(res, f)
    return rc


def run_one(name, damping, tol, args) -> dict:
    env = dict(os.environ, LPSLAM_BA_DAMPING=damping, LPSLAM_BA_GUARD_TOL=tol)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    fd, out_path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    argv = ["--bench", "room", "--mode", args.mode, "--frames", str(args.frames),
            "--loop", "--device", args.device, "--width", str(args.width),
            "--height", str(args.height), "--keypoints", str(args.keypoints),
            "--max-keyframes", str(args.max_keyframes),
            "--max-landmarks", str(args.max_landmarks)]
    if args.vocab:
        argv += ["--vocab", args.vocab]
    cmd = [sys.executable, os.path.abspath(__file__), "--child", out_path, "--", *argv]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=5400)
    wall = time.perf_counter() - t0
    row = {"config": name, "damping": damping, "guard_tol": float(tol), "wall_s": wall}
    try:
        with open(out_path) as f:
            row.update(json.load(f))
    except (OSError, ValueError):
        row["error"] = (r.stderr or r.stdout)[-2000:]
    finally:
        os.unlink(out_path)
    if r.returncode != 0:
        row["rc"] = r.returncode
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        return child(argv[1], argv[3:])
    from lpslam_tpu_torch.eval import bench_point as bp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--mode", default="stereo")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--keypoints", type=int, default=1200)
    ap.add_argument("--max-keyframes", type=int, default=bp.MAX_KEYFRAMES,
                    dest="max_keyframes")
    ap.add_argument("--max-landmarks", type=int, default=bp.MAX_LANDMARKS,
                    dest="max_landmarks")
    ap.add_argument("--vocab", default="", help="vocabulary file (default: the shipped one)")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ABLATION_BA_torch.json"))
    args = ap.parse_args(argv)
    device = bp.open_device(args.device)

    rows = []
    for name, damping, tol in CONFIGS:
        print(f"== {name} (damping={damping}, tol={tol}) ==", file=sys.stderr, flush=True)
        row = run_one(name, damping, tol, args)
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    artifact = {
        "benchmark": f"room {args.mode} {args.frames} frames, loop closure on"
                     " (the round-4 NaN-explosion configuration)",
        "platform": device.type,
        "hardware": bp.hardware(device),
        "knobs": "LPSLAM_BA_DAMPING / LPSLAM_BA_GUARD_TOL read at import by"
                 " lpslam_tpu_torch/backend/ba.py; fresh process per config",
        "rows": rows,
    }
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())
