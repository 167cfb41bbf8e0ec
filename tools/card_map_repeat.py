"""Does the card give the same room map twice, and how often does
chip_smoke.py phase 15c's comparison leave its bounds on that map?

    python3 tools/card_map_repeat.py [--maps 5] [--world1 2] [--world2 1] [--out FILE]

On the card only. Renders chip_smoke.py phase 7's 740-frame room once, then
`--maps` times: drives phase 7 (VSLAMTracker, loop closure) and phase 8
(the kidnapped frames) over it exactly as chip_smoke.py does, and runs phase
15c's comparison on the map phase 8 leaves: sharded_global_ba `--world1`
times in a world of one over NCCL (in this process) and `--world2` times in
a spawned world of 2 (gloo, sharing the card).

Per map it prints whether phase 7's map (kf_R, kf_t, lm_pos, the accepted
closures) and phase 8's equal the first drive's bit for bit, the global BA
and correct_loop times of the drive, the world of one against itself (kf_t
max difference) and every world-2 solve against every world-1 solve (kf_t
max difference, relative initial and final cost differences), each against
15c's bounds (chip_smoke.RESIDENT_*). The last line is one JSON object
with every reading; `--out` writes the same object to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

MAP_KEYS = ("kf_R", "kf_t", "lm_pos")


def _sgba_repeats(mesh, map_np, cam_args, repeats):
    """sharded_global_ba of one map `repeats` times: [(kf_t, initial, final)]."""
    from lpslam_tpu_torch import convert
    from lpslam_tpu_torch.dist import sharded_global_ba
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    dev = mesh.device
    m = convert.map_from_numpy(map_np, dev)
    cam = PinholeCamera.make(*cam_args, dev)
    out = []
    for _ in range(repeats):
        m2, res = sharded_global_ba(m, cam, mesh=mesh)
        out.append((m2.kf_t.cpu().numpy(), float(res.initial_cost), float(res.final_cost)))
    return out


def _same(a: dict, b: dict) -> bool:
    return all(a[k].tobytes() == b[k].tobytes() for k in a)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--maps", type=int, default=5)
    p.add_argument("--world1", type=int, default=2)
    p.add_argument("--world2", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("card_map_repeat: no CUDA device; this tool runs only on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as smoke
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)
    from lpslam_tpu_torch import _cuda, convert
    from lpslam_tpu_torch.dist.mesh import run_world

    device = torch.device("cuda")
    card = smoke.card_line()
    print(card, flush=True)
    _cuda.load_libraries(["patch.cu", "fast_nms.cu", "hamming.cu"])
    t0 = time.perf_counter()
    raw, gt, K, grid = smoke.render_room()
    print(f"rendered the room in {time.perf_counter() - t0:.1f} s", flush=True)
    first7 = first8 = None
    rows = []
    for i in range(args.maps):
        t0 = time.perf_counter()
        res7, tracker, align, rectified = smoke.run_loop_room(device, raw, gt, K, grid)
        map7 = {k: getattr(tracker.engine.map, k).cpu().numpy() for k in MAP_KEYS}
        map7["closures"] = np.array(res7["closures"], dtype=np.float64)
        res8 = smoke.run_kidnap(device, tracker, gt, align, rectified)
        map_np = convert.map_to_numpy(tracker.engine.map)
        map8 = {k: map_np[k] for k in MAP_KEYS}
        cam_args = tuple(float(v) for v in tracker.engine.cam)
        del tracker
        drive_s = time.perf_counter() - t0
        first7 = first7 or map7
        first8 = first8 or map8
        n_kf = int(map_np["n_kf"])
        one = smoke.nccl_world_of_one(_sgba_repeats, map_np, cam_args, args.world1)
        two = run_world(_sgba_repeats, 2, map_np, cam_args, args.world2, backend="gloo",
                        device="cuda", timeout=900.0)[0]

        def dt(a, b):
            return float(np.abs(a[0][:n_kf] - b[0][:n_kf]).max())

        def rel(a, b, j):
            return abs(a[j] - b[j]) / abs(b[j])

        pairs = [{"kf_t": dt(a, b), "cost0_rel": rel(a, b, 1), "cost_rel": rel(a, b, 2)}
                 for a in two for b in one]
        for q in pairs:
            q["within_15c"] = (q["kf_t"] <= smoke.RESIDENT_SOL_ATOL
                               and q["cost_rel"] <= smoke.RESIDENT_COST_RTOL
                               and q["cost0_rel"] <= smoke.RESIDENT_COST0_RTOL)
        row = {"map": i, "n_kf": n_kf, "drive_s": drive_s,
               "phase7_equal_first": _same(map7, first7),
               "phase8_equal_first": _same(map8, first8),
               "closures": res7["closures"], "tracked": res7["tracked"],
               "ate_m_sim3": res7["ate_m_sim3"], "fps": res7["fps"],
               "times": {k: res7["times"][k] for k in ("global_ba", "correct_loop")
                         if k in res7["times"]},
               "relocalized": res8["relocalized"],
               "world1_costs": [r[1:] for r in one], "world2_costs": [r[1:] for r in two],
               "world1_vs_itself_kf_t": [dt(a, one[0]) for a in one[1:]],
               "world2_vs_world1": pairs}
        rows.append(row)
        print(json.dumps(row), flush=True)
    pairs = [q for r in rows for q in r["world2_vs_world1"]]
    first = [r["world2_vs_world1"][0] for r in rows]
    out = {"card": card, "maps": rows,
           "phase7_all_equal": all(r["phase7_equal_first"] for r in rows),
           "phase8_all_equal": all(r["phase8_equal_first"] for r in rows),
           "world1_vs_itself_max": max((x for r in rows for x in r["world1_vs_itself_kf_t"]),
                                       default=None),
           "pairs_outside_15c": sum(not q["within_15c"] for q in pairs),
           "pairs": len(pairs),
           "maps_failing_15c": sum(not q["within_15c"] for q in first)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
