"""pose_only_optimize's CUDA graphs on one card: what each of track_frame's
two calls costs the device and the host.

    python3 tools/time_pose_opt_graph.py [--n 4096] [--replays 200] [--out FILE]

For each of track_frame's two signatures (N landmarks, variances of three
pyramid levels; 6 iterations, then 4 from the first call's pose), on a pose
problem made as the card tests make it:
  first_call_s        the first public call, which captures the graph;
  replay_device_ms    device time of one ``graph.replay()``, from CUDA
                      events around --replays back-to-back replays;
  kernels_per_replay, kernel_busy_ms
                      the kernels one replay runs and the sum of their
                      device times, from torch.profiler over 20 replays;
  public_host_ms, public_wall_ms
                      one public call (copy-in, replay, clones) as the host
                      sees it, without and with a synchronize after it;
  eager_host_ms, eager_wall_ms
                      the same for the eager body.
replay_device_ms over kernel_busy_ms says how far the graph's kernels run
back to back: near 1, the call is bound by its ~2,900 tiny kernels' device
time, which only fewer, larger kernels would cut. Prints one JSON object
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def pose_problem(device, n: int, seed: int):
    """A pose off the one that projects n landmarks to their pixels, with
    pixel noise, a tenth outliers, invalid rows and three variance levels."""
    from lpslam_tpu_torch.geometry.camera import PinholeCamera
    from lpslam_tpu_torch.geometry.se3 import SE3
    from lpslam_tpu_torch.geometry.so3 import so3_exp

    rng = np.random.default_rng(seed)
    p_w = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 6, (n, 1))], 1)
    uv = p_w[:, :2] / p_w[:, 2:] * 380.0 + [320.0, 240.0] + rng.normal(0, 0.7, (n, 2))
    uv[: n // 10] += rng.uniform(-40, 40, (n // 10, 2))

    def T(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    pose0 = SE3(so3_exp(T(rng.normal(0, 0.02, 3))), T(rng.normal(0, 0.04, 3)))
    cam = PinholeCamera.make(380.0, 380.0, 320.0, 240.0, device=device)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.05).to(device)
    return pose0, cam, T(p_w), T(uv), valid, T(1.44 ** rng.integers(0, 3, n))


def _host_and_wall_ms(fn, reps: int = 50):
    """Median ms of fn() as the host returns from it, and with a synchronize."""
    host, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def measure_signature(pose_opt, args_, iters: int, replays: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    pose0, cam, p_w, uv, valid, s2 = args_
    call = (pose0, cam, p_w, uv, valid, s2, iters)
    n_graphs = len(pose_opt._GRAPHS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pose_opt.pose_only_optimize(*call[:5], sigma2=s2, iters=iters)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    assert len(pose_opt._GRAPHS) == n_graphs + 1, "the first call did not capture"
    graph = next(reversed(pose_opt._GRAPHS.values()))[0]

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    replay_ms = start.elapsed_time(end) / replays

    n_prof = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)

    pub = _host_and_wall_ms(lambda: pose_opt.pose_only_optimize(*call[:5], sigma2=s2,
                                                                 iters=iters))
    eager = _host_and_wall_ms(lambda: pose_opt._pose_only_optimize_eager(*call), reps=10)
    return {"first_call_s": first_s, "replay_device_ms": replay_ms,
            "kernels_per_replay": len(kernels) / n_prof,
            "kernel_busy_ms": busy_us / n_prof / 1e3,
            "public_host_ms": pub[0], "public_wall_ms": pub[1],
            "eager_host_ms": eager[0], "eager_wall_ms": eager[1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096, help="landmarks (track_local_cap)")
    ap.add_argument("--replays", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_pose_opt_graph: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from lpslam_tpu_torch.frontend import pose_opt

    device = torch.device("cuda")
    problem = pose_problem(device, args.n, seed=2)
    out = {"card": smoke.card_line(), "torch": torch.__version__, "n": args.n}
    for iters in (6, 4):
        out[f"iters{iters}"] = measure_signature(pose_opt, problem, iters, args.replays)
    out["frame_device_ms"] = out["iters6"]["replay_device_ms"] + out["iters4"]["replay_device_ms"]
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
