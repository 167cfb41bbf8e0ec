"""One loop closure applied to the same map in both packages, on the CPU:
is the ATE gap after a mono closure born in the closing step?

    JAX_PLATFORMS=cpu python tools/jax_closure_reference.py --save DIR [--at 100]
    JAX_PLATFORMS=cpu python tools/jax_closure_reference.py --apply PREFIX [PREFIX ...]
                                                            [--ulp] [--out FILE]

--save: renders phase 7's room (chip_smoke.render_room, the bytes the card
sees) and drives the JAX `VSLAMTracker` in binned mode with
chip_smoke.LOOP_CONFIG over it, as `tools/jax_brief_reference.py --loop`
does, saving the map just before its first accepted closure is applied
and before the verdicts of the keyframes in --at (the port's closure on
the card), with chip_smoke.save_closure_states:
`DIR/jax_binned_k<k_new>_{map,verdict}.npz`. Prints every verdict that
named a candidate, (k_new, candidate, n_matches, n_inliers, accepted).
~5 min and ~3 GB.

--apply: for each saved (map, verdict) with an accepted verdict (from this
tool or from `tools/card_loop_modes.py --save-closure` on the card), what
`LoopCloser.apply` does with LOOP_CONFIG's gates: `correct_loop` (10
pose-graph iterations), then `global_ba` at `loop_global_ba_iters` (5), in
the JAX package and in the port, both on the CPU. Reports per package the
Sim3 ATE of the valid keyframes' centres against ground truth before,
after correct_loop and after global BA, global BA's initial and final
cost, and between the packages the largest difference of kf_R, kf_t and
the valid landmarks after each step and the final cost's relative
difference. --ulp adds each package's own spread: the same map with kf_t
moved by one ulp (np.nextafter away from zero) through the same two steps.
One JSON line per closure (--out appends them to FILE). ~1-2 min a closure.

--verify: for each saved map, `LoopCloser.verify`'s geometric part on the
saved verdict's (k_new, candidate) in both packages on the CPU (detection
and the consistency gate passed as given): mutual-NN matches, robust Sim3
inliers, accepted or not, and the Sim3; again with the landmarks moved by
one ulp in each package. One JSON line per map.

--maps A B: two saved maps side by side (the packages' maps at the same
keyframe): keyframes and landmarks, the keyframes' frames that only one
has, the first shared keyframe frames whose centres part by more than
1e-4 and 1e-3 map units, and each map's Sim3 ATE of its keyframe centres.
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

import chip_smoke as smoke  # noqa: E402  (the room, its configuration and feeding)

MODE = "binned"


def save(directory: str, at) -> dict:
    import jax.numpy as jnp

    from lpslam_tpu.frontend.tracker import TrackerStatus
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.loop.detector import LoopCloser
    from lpslam_tpu.mapstore.checkpoint import save_map
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker

    Path(directory).mkdir(parents=True, exist_ok=True)
    raw, gt, K, grid = smoke.render_room()
    grid_j = jnp.asarray(grid)

    def rectified(t):
        return np.asarray(remap_bilinear(jnp.asarray(raw[t], jnp.float32), grid_j))

    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    tracker = VSLAMTracker(cam, dict(smoke.LOOP_CONFIG, brief_mode=MODE))
    tracker.attach_device_rectify(grid)
    saved, undo_save = smoke.save_closure_states(LoopCloser, directory, f"jax_{MODE}", gt,
                                                 save_map, np.asarray, at=set(at))
    verdicts, undo = smoke.record_closures(LoopCloser)
    try:
        fed = smoke.drive_room(tracker, TrackerStatus.TRACKING, CameraQueueEntry, raw,
                               rectified)
    finally:
        undo()
        undo_save()
    out = {**smoke.brief_metrics(tracker.engine, gt, fed), "verdicts": verdicts,
           "saved": saved}
    tracker.stop()
    return out


def room_K() -> np.ndarray:
    """The room's intrinsics, as chip_smoke.render_room builds them."""
    from lpslam_tpu_torch.io import SyntheticBenchmark

    intr = SyntheticBenchmark(num_frames=smoke.LOOP_FRAMES, h=480, w=640, seed=0,
                              turns=1.08 * smoke.LOOP_FRAMES / 600.0, fps=smoke.LOOP_FPS).intr
    return np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])


def _centres(R, t, valid):
    return np.einsum("kji,kj->ki", R[valid], -t[valid])


def _ate(R, t, valid, kf_gt) -> float:
    from lpslam_tpu_torch.eval.ate import ate_rmse

    return float(ate_rmse(_centres(R, t, valid).astype(np.float64), kf_gt[valid])[0])


def apply_jax(map_path: str, v: dict, K, perturb: bool) -> dict:
    import jax.numpy as jnp

    from lpslam_tpu.backend.ba import global_ba
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.loop.detector import LoopConfig, correct_loop
    from lpslam_tpu.mapstore.checkpoint import load_map

    cfg = LoopConfig(global_ba_iters=smoke.LOOP_CONFIG["loop_global_ba_iters"])
    m = load_map(map_path)
    if perturb:
        m = m._replace(kf_t=jnp.asarray(_ulp(np.asarray(m.kf_t))))
    m = correct_loop(m, jnp.int32(int(v["k_new"])), jnp.int32(int(v["candidate"])),
                     jnp.asarray(v["R"]), jnp.asarray(v["t"]),
                     jnp.asarray(v["s"], jnp.float32), iters=cfg.pose_graph_iters)
    after_pg = {k: np.asarray(getattr(m, k)) for k in ("kf_R", "kf_t", "lm_pos")}
    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    m, r = global_ba(m, cam, iters=cfg.global_ba_iters)
    after_ba = {k: np.asarray(getattr(m, k)) for k in ("kf_R", "kf_t", "lm_pos")}
    return {"pg": after_pg, "ba": after_ba, "initial_cost": float(r.initial_cost),
            "final_cost": float(r.final_cost)}


def apply_torch(map_path: str, v: dict, K, perturb: bool) -> dict:
    import torch

    from lpslam_tpu_torch.backend.ba import global_ba
    from lpslam_tpu_torch.geometry import PinholeCamera
    from lpslam_tpu_torch.loop.detector import LoopConfig, correct_loop
    from lpslam_tpu_torch.mapstore.checkpoint import load_map

    cpu = torch.device("cpu")
    cfg = LoopConfig(global_ba_iters=smoke.LOOP_CONFIG["loop_global_ba_iters"])
    m = load_map(map_path, cpu)
    if perturb:
        m = m._replace(kf_t=torch.from_numpy(_ulp(m.kf_t.numpy())))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    m = correct_loop(m, int(v["k_new"]), int(v["candidate"]), f32(v["R"]), f32(v["t"]),
                     f32(v["s"]), iters=cfg.pose_graph_iters)
    after_pg = {k: getattr(m, k).numpy().copy() for k in ("kf_R", "kf_t", "lm_pos")}
    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device=cpu)
    m, r = global_ba(m, cam, iters=cfg.global_ba_iters)
    after_ba = {k: getattr(m, k).numpy().copy() for k in ("kf_R", "kf_t", "lm_pos")}
    return {"pg": after_pg, "ba": after_ba, "initial_cost": float(r.initial_cost),
            "final_cost": float(r.final_cost)}


def _ulp(kf_t: np.ndarray) -> np.ndarray:
    """kf_t one ulp further from zero (a zero moves to the smallest normal's
    direction, +)."""
    away = np.where(kf_t < 0, -np.inf, np.inf).astype(np.float32)
    return np.nextafter(kf_t.astype(np.float32), away)


def verify_in(pkg: str, map_path: str, k_new: int, cand: int, perturb: bool) -> dict:
    """LoopCloser.verify with detect() answering `cand` and the consistency
    gate already met."""
    if pkg == "jax":
        import jax.numpy as jnp

        from lpslam_tpu.loop.detector import LoopCloser, LoopConfig
        from lpslam_tpu.mapstore.checkpoint import load_map

        m = load_map(map_path)
        if perturb:
            m = m._replace(lm_pos=jnp.asarray(_ulp(np.asarray(m.lm_pos))))
        read = np.asarray
    else:
        import torch

        from lpslam_tpu_torch.loop.detector import LoopCloser, LoopConfig
        from lpslam_tpu_torch.mapstore.checkpoint import load_map

        m = load_map(map_path, torch.device("cpu"))
        if perturb:
            m = m._replace(lm_pos=torch.from_numpy(_ulp(m.lm_pos.numpy())))
        read = lambda x: x.detach().numpy()  # noqa: E731
    lc = LoopCloser.__new__(LoopCloser)
    lc.cfg = LoopConfig(global_ba_iters=smoke.LOOP_CONFIG["loop_global_ba_iters"])
    lc._recent_cands = [cand] * (lc.cfg.consistency - 1)
    lc.detect = lambda m_, k_: cand
    v = lc.verify(m, k_new)
    r = v.result
    out = {"n_matches": int(r.n_matches), "n_inliers": int(r.n_inliers),
           "accepted": bool(r.detected)}
    if r.detected:
        out.update(s=float(read(v.S_corr.s)), t=read(v.S_corr.t).tolist())
    return out


def verify_both(prefix: str) -> dict:
    with np.load(prefix + "_verdict.npz") as f:
        k_new, cand = int(f["k_new"]), int(f["candidate"])
    out = {"map": prefix, "k_new": k_new, "candidate": cand}
    for pkg in ("jax", "torch"):
        for p in (False, True):
            out[pkg + ("_lm_ulp" if p else "")] = verify_in(pkg, prefix + "_map.npz", k_new,
                                                            cand, p)
    return out


def maps_side_by_side(prefix_a: str, prefix_b: str) -> dict:
    out = {"maps": [prefix_a, prefix_b]}
    maps, frames, centres = [], [], []
    for prefix in (prefix_a, prefix_b):
        with np.load(prefix + "_map.npz") as f, np.load(prefix + "_verdict.npz") as v:
            m = {k: f[k] for k in ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "lm_valid")}
            kf_gt = v["kf_gt"]
        valid = m["kf_valid"]
        maps.append(m)
        frames.append(m["kf_frame_id"][valid])
        centres.append(dict(zip(m["kf_frame_id"][valid].tolist(),
                                _centres(m["kf_R"], m["kf_t"], valid))))
        out.setdefault("keyframes", []).append(int(valid.sum()))
        out.setdefault("landmarks", []).append(int(m["lm_valid"].sum()))
        out.setdefault("kf_ate_sim3", []).append(_ate(m["kf_R"], m["kf_t"], valid, kf_gt))
    out["frames_only_in"] = [np.setdiff1d(frames[0], frames[1]).tolist(),
                             np.setdiff1d(frames[1], frames[0]).tolist()]
    shared = np.intersect1d(frames[0], frames[1]).tolist()
    d = [float(np.linalg.norm(centres[0][f] - centres[1][f])) for f in shared]
    for tol in (1e-4, 1e-3):
        out[f"first_frame_centres_part_{tol:g}"] = next(
            ([f, x] for f, x in zip(shared, d) if x > tol), None)
    out["centres_max_apart"] = max(d)
    return out


def _diff(a: dict, b: dict, lm_valid) -> dict:
    return {"kf_R": float(np.abs(a["kf_R"] - b["kf_R"]).max()),
            "kf_t": float(np.abs(a["kf_t"] - b["kf_t"]).max()),
            "lm_pos": float(np.abs(a["lm_pos"][lm_valid] - b["lm_pos"][lm_valid]).max())}


def compare(prefix: str, ulp: bool) -> dict:
    K = room_K()
    with np.load(prefix + "_verdict.npz") as f:
        v = {k: f[k] for k in f.files}
    if not bool(v["detected"]):
        return {"closure": prefix, "skipped": "verdict not accepted"}
    map_path = prefix + "_map.npz"
    with np.load(map_path) as f:
        kf_valid, lm_valid = f["kf_valid"], f["lm_valid"]
        before = {k: f[k] for k in ("kf_R", "kf_t")}
    kf_gt = v["kf_gt"]
    out = {"closure": prefix, "k_new": int(v["k_new"]), "candidate": int(v["candidate"]),
           "n_inliers": int(v["n_inliers"]), "s": float(v["s"]),
           "keyframes": int(kf_valid.sum()), "landmarks": int(lm_valid.sum()),
           "ate_before": _ate(before["kf_R"], before["kf_t"], kf_valid, kf_gt)}
    runs = {}
    for name, fn in (("jax", apply_jax), ("torch", apply_torch)):
        for p in ((False, True) if ulp else (False,)):
            t0 = time.perf_counter()
            r = fn(map_path, v, K, p)
            key = name + ("_ulp" if p else "")
            runs[key] = r
            out[key] = {"ate_after_correct_loop": _ate(r["pg"]["kf_R"], r["pg"]["kf_t"],
                                                       kf_valid, kf_gt),
                        "ate_after_global_ba": _ate(r["ba"]["kf_R"], r["ba"]["kf_t"],
                                                    kf_valid, kf_gt),
                        "ba_initial_cost": r["initial_cost"], "ba_final_cost": r["final_cost"],
                        "seconds": time.perf_counter() - t0}
            print(f"{prefix} {key}: {json.dumps(out[key])}", file=sys.stderr, flush=True)
    pairs = [("torch", "jax")] + ([("jax_ulp", "jax"), ("torch_ulp", "torch")] if ulp else [])
    for a, b in pairs:
        ra, rb = runs[a], runs[b]
        out[f"{a}_vs_{b}"] = {
            "after_correct_loop": _diff(ra["pg"], rb["pg"], lm_valid),
            "after_global_ba": _diff(ra["ba"], rb["ba"], lm_valid),
            "final_cost_rel": abs(ra["final_cost"] - rb["final_cost"]) / abs(rb["final_cost"]),
        }
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--save", default="", help="directory for the JAX run's closure states")
    p.add_argument("--at", default="", help="comma-separated k_new to save as well")
    p.add_argument("--apply", nargs="*", default=[], help="saved closure prefixes")
    p.add_argument("--ulp", action="store_true")
    p.add_argument("--verify", nargs="*", default=[], help="saved map prefixes")
    p.add_argument("--maps", nargs=2, default=[], help="two saved map prefixes")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    lines = []
    if args.save:
        at = [int(k) for k in args.at.split(",") if k]
        lines.append(json.dumps({"jax_cpu": save(args.save, at)}))
    if args.maps:
        lines.append(json.dumps(maps_side_by_side(*args.maps)))
    for prefix in args.verify:
        lines.append(json.dumps(verify_both(prefix)))
    for prefix in args.apply:
        lines.append(json.dumps(compare(prefix, args.ulp)))
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
