"""The JAX package's keyframe-sharded global BA on the CPU at the scaling
tool's default problem, the reference that chip_smoke.py phase 15b holds the
port's world of one to (constant JAX_SCALING_REF there).

    JAX_PLATFORMS=cpu python tools/jax_dist_reference.py [--meshes 1,8]

Builds eval/scaling.py's problem (256 keyframes, 16,384 landmarks, 512
observations per keyframe; 6 LM x 15 CG iterations) and solves it with
lpslam_tpu.dist.sharded_map.sharded_global_ba_problem on virtual CPU meshes
of the given sizes. Prints one JSON line: the initial and final cost per
mesh size, and the spread of the final cost and of cam_t across the sizes
(JAX's own reduction-order spread, which bounds the tolerance).

--room: the same spread on a room map instead. The JAX package drives
chip_smoke.py phase 7's 740 room frames and configuration (as
tools/jax_loop_reference.py does; ~4 min, ~3 GB), then solves
sharded_global_ba over its map on the virtual meshes (phase 15c's solve);
the port solves it too on the CPU in gloo worlds of 1 and 2. Prints each
one's kf_t spread against the JAX mesh of 1.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--keyframes", type=int, default=256)
    p.add_argument("--landmarks", type=int, default=16384)
    p.add_argument("--obs", type=int, default=512)
    p.add_argument("--iters", type=int, default=6)
    p.add_argument("--cg-iters", type=int, default=15)
    p.add_argument("--meshes", default="1,8")
    p.add_argument("--room", action="store_true", help="the spread on phase 7's room map")
    args = p.parse_args(argv)
    if args.room:
        return room_spread([int(s) for s in args.meshes.split(",")])

    import jax

    from lpslam_tpu.dist import make_mesh
    from lpslam_tpu.dist.sharded_map import sharded_global_ba_problem
    from lpslam_tpu.eval.scaling import build_problem
    from lpslam_tpu.geometry import PinholeCamera

    cam = PinholeCamera.make(460.0, 460.0, 376.0, 240.0)
    prob = build_problem(args.keyframes, args.landmarks, args.obs)
    runs, sols = {}, []
    for n in (int(s) for s in args.meshes.split(",")):
        t0 = time.perf_counter()
        res = sharded_global_ba_problem(prob, cam, mesh=make_mesh(n), iters=args.iters,
                                        cg_iters=args.cg_iters)
        jax.block_until_ready(res.cam_t)
        runs[n] = {"initial_cost": float(res.initial_cost), "final_cost": float(res.final_cost),
                   "seconds_with_compile": time.perf_counter() - t0}
        sols.append(np.asarray(res.cam_t))
    finals = [r["final_cost"] for r in runs.values()]
    print(json.dumps({
        "problem": {"keyframes": args.keyframes, "landmarks": args.landmarks,
                    "obs_per_kf": args.obs, "iters": args.iters, "cg_iters": args.cg_iters},
        "platform": jax.devices()[0].platform,
        "jax": jax.__version__,
        "meshes": runs,
        "final_cost_rel_spread": (max(finals) - min(finals)) / min(finals),
        "cam_t_max_diff": float(max(np.abs(s - sols[0]).max() for s in sols)),
    }))
    return 0


def _port_room_world(mesh, map_np, cam_args):
    """The port's sharded_global_ba of the room map in one rank (CPU)."""
    import torch

    from lpslam_tpu_torch import convert
    from lpslam_tpu_torch.dist import sharded_global_ba
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    torch.set_num_threads(2)
    m2, res = sharded_global_ba(convert.map_from_numpy(map_np, "cpu"),
                                PinholeCamera.make(*cam_args, "cpu"), mesh=mesh)
    return {"kf_t": m2.kf_t.numpy(), "initial_cost": float(res.initial_cost),
            "final_cost": float(res.final_cost)}


def room_spread(meshes) -> int:
    import jax.numpy as jnp

    import chip_smoke as smoke
    from lpslam_tpu.dist import make_mesh
    from lpslam_tpu.dist.sharded_map import sharded_global_ba
    from lpslam_tpu.frontend.tracker import TrackerStatus
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker
    from lpslam_tpu_torch.dist.mesh import run_world

    raw, _, K, grid = smoke.render_room()
    grid_j = jnp.asarray(grid)

    def rectified(t):
        return np.asarray(remap_bilinear(jnp.asarray(raw[t], jnp.float32), grid_j))

    cam_args = (K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    tracker = VSLAMTracker(PinholeCamera.make(*cam_args), dict(smoke.LOOP_CONFIG))
    tracker.attach_device_rectify(grid)
    smoke.drive_room(tracker, TrackerStatus.TRACKING, CameraQueueEntry, raw, rectified)
    m = tracker.engine.map
    n_kf = int(m.n_kf)
    out, ref = {"n_kf": n_kf, "jax": {}, "port_cpu": {}}, None
    for n in meshes:
        m2, res = sharded_global_ba(m, PinholeCamera.make(*cam_args), mesh=make_mesh(n))
        kf_t = np.asarray(m2.kf_t)[:n_kf]
        ref = kf_t if ref is None else ref
        out["jax"][n] = {"initial_cost": float(res.initial_cost),
                         "final_cost": float(res.final_cost),
                         "kf_t_max_diff_vs_mesh1": float(np.abs(kf_t - ref).max())}
    map_np = {k: np.asarray(v) for k, v in m._asdict().items()}
    port = {}
    for n in (1, 2):
        port[n] = run_world(_port_room_world, n, map_np, tuple(float(v) for v in cam_args),
                            backend="gloo", device="cpu")[0]
        out["port_cpu"][n] = {"initial_cost": port[n]["initial_cost"],
                              "final_cost": port[n]["final_cost"],
                              "kf_t_max_diff_vs_jax_mesh1":
                                  float(np.abs(port[n]["kf_t"][:n_kf] - ref).max()),
                              "kf_t_max_diff_vs_port_world1":
                                  float(np.abs(port[n]["kf_t"][:n_kf]
                                               - port[1]["kf_t"][:n_kf]).max())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
