"""One loop closure applied to the same map in both packages, on the CPU:
is the ATE gap after a mono closure born in the closing step, or in the
tracking that follows it?

    JAX_PLATFORMS=cpu python tools/jax_closure_reference.py --save DIR [--at 100]
    JAX_PLATFORMS=cpu python tools/jax_closure_reference.py --apply PREFIX [PREFIX ...]
                                                            [--ulp] [--out FILE]
    JAX_PLATFORMS=cpu python tools/jax_closure_reference.py --track-on PREFIX [PREFIX ...]
                                      [--frames N] [--ulp [--bisect]] [--out FILE]

--save: renders phase 7's room (chip_smoke.render_room, the bytes the card
sees) and drives the JAX `VSLAMTracker` in binned mode with
chip_smoke.LOOP_CONFIG over it, as `tools/jax_brief_reference.py --loop`
does, saving the map just before its first accepted closure is applied
and before the verdicts of the keyframes in --at (the port's closure on
the card), with chip_smoke.save_closure_states:
`DIR/jax_binned_k<k_new>_{map,verdict,engine}.npz`. Prints every verdict that
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

--track-on PREFIX [PREFIX ...] [--frames N] [--ulp [--bisect]]: for each
state saved with its engine file (`<prefix>_engine.npz`: this tool's
--save, `tools/card_loop_modes.py --save-closure`,
`tools/soak_torch_long_run.py --save-closure`), chip_smoke.track_on in both
packages on the CPU: the state loaded into a fresh VSLAMTracker with the
saved configuration (mapstore/checkpoint.py::load_map and the engine's
host state), the saved verdict applied as `_loop_apply` does
(LoopCloser.apply, `_loop_resync_pose`, `discard_carry`), then the next N
frames of the run's room (default: to its end) through process_image in
its chunks with loop closing off. Per package: each frame's status,
camera centre and inliers, the keyframes inserted, the Sim3 ATE binned by
100 frames; between them: the largest centre distance per 16-frame
window (no alignment) and the first frame whose status or keyframe
decision differs.

--ulp adds each package's drives under chip_smoke.TRACK_MOVES: from kf_t
one ulp further from zero (a move that does not reach the features), and
on frames undistorted through the grid one ulp further from and nearer to
zero (moves that do, through the tie-decided descriptor bits). It reports
each move's spread per window, the parting rule's verdict with the kf_t
move's spreads (`verdict`: chip_smoke.parting, two consecutive windows
beyond 2 x the larger spread + 1e-4, a TRACKING / LOST split no moved
drive shows, or keyframe counts beyond the moved drives' difference + 1)
and with the largest spread over every move (`verdict_all_moves`), and
the chip_smoke.JAX_TRACK_ON_REF constant of the state (`ref_constant`,
every move). Where the card tracked on from the state
(`<prefix>_track_card.json`), its drive against both.

--bisect (with --ulp), where the packages part by the kf_t verdict: JAX's
state before the first window over loaded into both packages and that
frame's stages compared (features, the local map's top-k, either
projected matching, the pose after each pose_only_optimize, track_frame,
the keyframe decision, local BA); and both packages driven again, each
also from kf_t one ulp moved, on the same undistorted frames (JAX's
remap_bilinear output, no grid attached), with the kf_t verdict on those
drives (`same_frames`): what is left once the image rounding is shared.

One JSON line per state (--out appends it with the drives' per-frame
records). ~0.5 s a frame per drive at 640x480 (8 drives with --ulp, 12
where --bisect drives the same frames), a few GB.

--maps A B: two saved maps side by side (the packages' maps at the same
keyframe): keyframes and landmarks, the keyframes' frames that only one
has, the first shared keyframe frames whose centres part by more than
1e-4 and 1e-3 map units, and each map's Sim3 ATE of its keyframe centres.
"""
from __future__ import annotations

import argparse
import json
import os
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
    saved, undo_save = smoke.save_closure_states(
        LoopCloser, directory, f"jax_{MODE}", gt, save_map, np.asarray, at=set(at),
        tracker_of=lambda: tracker, room={"kind": "loop", "frames": len(raw)})
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


def jax_api():
    """What chip_smoke.track_on needs of the JAX package (chip_smoke.port_api
    builds the port's), on the CPU."""
    from types import SimpleNamespace

    import jax.numpy as jnp

    from lpslam_tpu.frontend.tracker import TrackerStatus
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.geometry.se3 import SE3
    from lpslam_tpu.geometry.sim3 import Sim3
    from lpslam_tpu.loop.detector import LoopCloser, LoopResult, LoopVerdict
    from lpslam_tpu.mapstore.checkpoint import load_map
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker

    return SimpleNamespace(
        name="jax", device=None, tracker=VSLAMTracker, camera=PinholeCamera.make,
        load_map=load_map, arr=jnp.asarray, to_np=np.asarray, SE3=SE3, Sim3=Sim3,
        TrackerStatus=TrackerStatus, Entry=CameraQueueEntry, LoopCloser=LoopCloser,
        LoopResult=LoopResult, LoopVerdict=LoopVerdict, sync=lambda: None)


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


class _Lazy:
    """frames[t] = fn(t), for t < n."""

    def __init__(self, fn, n: int):
        self.fn, self.n = fn, n

    def __getitem__(self, t):
        return self.fn(t)

    def __len__(self):
        return self.n


_ROOMS = {}


def room_frames(room: dict, grid_sign: int = 0, same: bool = False) -> tuple:
    """(ground truth, {package: chip_smoke.Frames}) of a saved state's room,
    rendered once per process. "loop": phase 7's room (chip_smoke.render_room
    at its length), raw frames to the chunk path with the grid attached, each
    package's remap_bilinear for the host path; "soak": the soak's room
    (soak_torch_long_run.render), every frame undistorted first as the soak
    tools do (each package's remap_bilinear on the grid of
    build_rectifier's RectifyProcessor, which is what that processor runs).
    `grid_sign` 1 / -1: the undistortion grid one ulp further from / nearer
    to zero (chip_smoke.one_ulp). `same`: both packages fed JAX's
    undistorted frames, no grid attached."""
    key = json.dumps(room, sort_keys=True)
    if key not in _ROOMS:
        t0 = time.perf_counter()
        if room["kind"] == "loop":
            raw, gt, _, grid = smoke.render_room(room["frames"])
            chunk_grid = True
        elif room["kind"] == "soak":
            sys.path.insert(0, str(REPO / "tools"))
            import soak_torch_long_run as soak

            from lpslam_tpu_torch.eval.run_dataset import build_rectifier

            h, w = room["size"]
            ds, raw = soak.render(room["frames"], h, w)
            gt = ds.ground_truth().positions
            grid = build_rectifier(ds.intr, "mono", device="cpu")[0]._maps[0].numpy()
            chunk_grid = False
        else:
            raise ValueError(f"no frames for the room {room}")
        print(f"rendered the {room['kind']} room, {len(raw)} frames, in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        _ROOMS[key] = raw, gt, grid, chunk_grid
    raw, gt, grid, chunk_grid = _ROOMS[key]
    if grid_sign:
        grid = smoke.one_ulp(grid, grid_sign)
    if same:
        undistorted = _frames_jax(raw, grid, False)
        return gt, {"jax": undistorted, "torch": undistorted}
    return gt, {"jax": _frames_jax(raw, grid, chunk_grid),
                "torch": _frames_torch(raw, grid, chunk_grid)}


def _frames_jax(raw, grid, chunk_grid: bool):
    import jax
    import jax.numpy as jnp

    from lpslam_tpu.kernels.remap import remap_bilinear

    remap = jax.jit(lambda im, g=jnp.asarray(grid): remap_bilinear(im, g))

    def host(t):
        return np.asarray(remap(jnp.asarray(raw[t], jnp.float32)))

    return smoke.Frames(raw, host, grid) if chunk_grid else smoke.Frames(_Lazy(host, len(raw)),
                                                                         host)


def _frames_torch(raw, grid, chunk_grid: bool):
    import torch

    from lpslam_tpu_torch.kernels.remap import remap_bilinear

    cpu = torch.device("cpu")
    if chunk_grid:
        return smoke.room_frames_on(cpu, raw, grid)
    grid_t = torch.from_numpy(grid)

    def host(t):
        return remap_bilinear(torch.from_numpy(raw[t].astype(np.float32)), grid_t).numpy()

    return smoke.Frames(_Lazy(host, len(raw)), host)


def drive_summary(run: dict, gt) -> dict:
    """A track-on drive's tracked frames, keyframes and Sim3 ATE over its
    tracked frames, binned by 100 frames as chip_smoke.room_metrics bins."""
    ok = [s == "TRACKING" for s in run["status"]]
    met = smoke.trajectory_error([f for f, o in zip(run["fid"], ok) if o],
                                 [c for c, o in zip(run["centre"], ok) if o], gt)
    return {"frames": len(run["fid"]), "tracked": sum(ok), "lost_frames": smoke.lost_frames(run),
            "keyframes_inserted": run["keyframes_inserted"],
            "keyframes_final": run.get("keyframes_final"), "ate_m_sim3": met["ate_m"],
            "sim3_scale_m_per_unit": float(met["align"][0]),
            "err_by_100_frames": met["err_by_100_frames"],
            "bins_from_frame": met["bins_from_frame"],
            "inliers_median": float(np.median(run["inliers"])) if run["inliers"] else None,
            "seconds": run.get("seconds")}


def pair_summary(a: dict, b: dict) -> dict:
    return {"dist_per_window": smoke.window_distances(a, b),
            "first_status_difference": smoke.first_difference(a, b, "status"),
            "first_keyframe_difference": smoke.first_difference(a, b, "kf")}


def ref_constant(prefix: str, runs: dict, gt) -> dict:
    """chip_smoke.JAX_TRACK_ON_REF from the drives of one state: JAX's
    centres (7 decimals), lost frames and keyframes; over every move of
    chip_smoke.TRACK_MOVES both packages' spreads per window (the largest
    over the moves), the frames where a moved JAX drive's status differs,
    the moved JAX drives' keyframe difference; the same for each move alone
    (`by_move`); whether the port's CPU drive parts from JAX's by either;
    and the state's digest."""
    j = runs["jax"]
    kinds = ["_" + k for k in smoke.TRACK_MOVES]
    spread, unstable, kf_diff = smoke.move_spread(runs, "jax", kinds)
    by_move = {}
    for k in kinds:
        sj, uj, kj = smoke.move_spread(runs, "jax", [k])
        by_move[k.lstrip("_")] = {"jax": sj, "torch_cpu": smoke.move_spread(runs, "torch", [k])[0],
                                  "unstable_frames": sorted(uj), "keyframes_move_diff": kj}
    with np.load(prefix + "_verdict.npz") as f:
        closure = [int(f["k_new"]), int(f["candidate"]), int(f["n_inliers"])]
    summ = drive_summary(j, gt)
    return {"state_digest": smoke.state_digest(prefix), "closure": closure,
            "start_frame": j["start_frame"], "end_frame": j["end_frame"],
            "keyframes_inserted": len(j["keyframes_inserted"]), "lost_frames": smoke.lost_frames(j),
            "unstable_frames": sorted(unstable), "keyframes_move_diff": kf_diff,
            "moves": list(smoke.TRACK_MOVES),
            "torch_cpu_parts": smoke.parting_of_runs(runs, kinds=kinds)["parts"],
            "torch_cpu_parts_kf_t_only": smoke.parting_of_runs(runs)["parts"],
            "ate_m_sim3": summ["ate_m_sim3"], "err_by_100_frames": summ["err_by_100_frames"],
            "spread": {"jax": spread, "torch_cpu": smoke.move_spread(runs, "torch", kinds)[0]},
            "by_move": by_move,
            "centres": [None if not np.all(np.isfinite(c)) else [round(x, 7) for x in c]
                        for c in j["centre"]]}


def track_on_both(prefix: str, n_frames: int, ulp: bool, bisect: bool = False) -> dict:
    """--track-on for one saved state: chip_smoke.track_on in both packages
    on the CPU (and, with `ulp`, under each of chip_smoke.TRACK_MOVES), each
    drive's summary, the distances between them per window, the parting
    rule's verdicts (the kf_t move's spreads; every move's), the card's
    drive where the card saved one (`<prefix>_track_card.json`), and, with
    `bisect` where the kf_t verdict parts, bisect_window and the drives on
    the same frames (same_frames)."""
    import torch

    with np.load(prefix + "_engine.npz") as f:
        room = json.loads(str(f["room"]))
        start = int(f["next_frame"])
    with np.load(prefix + "_verdict.npz") as f:
        closure = [int(f["k_new"]), int(f["candidate"]), int(f["n_inliers"])]
    gt, frames = room_frames(room)
    plan = [("", frames, False)]
    if ulp:
        plan.append(("_ulp", frames, True))
        plan += [("_" + k, room_frames(room, grid_sign=sign)[1], False)
                 for k, sign in smoke.GRID_MOVES.items()]
    stop = start + n_frames if n_frames else None
    apis = {"jax": jax_api(), "torch": smoke.port_api(torch.device("cpu"))}
    runs = _drives(prefix, apis, plan, stop, start)
    out = {"closure": prefix, "k_new_candidate_inliers": closure, "room": room,
           "start_frame": start, "end_frame": runs["jax"]["end_frame"],
           **{k: drive_summary(r, gt) for k, r in runs.items()},
           "torch_vs_jax": pair_summary(runs["torch"], runs["jax"])}
    if ulp:
        out["spread_per_window"] = {
            k: {pkg: smoke.window_distances(runs[f"{pkg}_{k}"], runs[pkg])
                for pkg in ("jax", "torch")} for k in smoke.TRACK_MOVES}
        out["verdict"] = smoke.parting_of_runs(runs)
        out["verdict_all_moves"] = smoke.parting_of_runs(
            runs, kinds=["_" + k for k in smoke.TRACK_MOVES])
        out["ref_constant"] = ref_constant(prefix, runs, gt)
    card = prefix + "_track_card.json"
    if os.path.exists(card):
        with open(card) as f:
            c = json.load(f)
        d = c["drives"][""] if isinstance(c["drives"], dict) else c["drives"][0]
        out["card"] = {"on": c["card"], **drive_summary(d, gt),
                       "vs_torch_cpu": pair_summary(d, runs["torch"]),
                       "vs_jax": pair_summary(d, runs["jax"])}
        if ulp:
            ref = out["ref_constant"]
            for key, r in (("parting_vs_jax", ref), ("parting_vs_jax_kf_t_only", ref["by_move"]["ulp"])):
                spreads = r["spread"] if key == "parting_vs_jax" else r
                out["card"][key] = smoke.parting(
                    out["card"]["vs_jax"]["dist_per_window"], spreads["jax"],
                    spreads["torch_cpu"], smoke.lost_frames(d), ref["lost_frames"],
                    r["unstable_frames"], len(d["keyframes_inserted"]),
                    ref["keyframes_inserted"], r["keyframes_move_diff"])
    if bisect:
        w = out["verdict"]["first_two_windows_over"]
        if w is None:
            out["bisect"] = {"window": None, "note": "the packages do not part"}
        else:
            out["bisect"] = bisect_window(prefix, w, apis, frames, start)
            out["same_frames"] = same_frames(prefix, room, apis, stop, start, gt)
    out["drives"] = runs
    return out


def _drives(prefix: str, apis: dict, plan, stop, start: int, tag: str = "") -> dict:
    """chip_smoke.track_on in each package for each (kind, frames, perturb)
    of `plan`, keyed package + tag + kind."""
    runs = {}
    for pkg in ("jax", "torch"):
        for kind, fr, p in plan:
            key = pkg + tag + kind
            runs[key] = smoke.track_on(apis[pkg], prefix, fr[pkg], perturb=p, stop=stop)
            print(f"{prefix} {key}: {runs[key]['end_frame'] - start} frames in "
                  f"{runs[key]['seconds']:.1f} s, keyframes {runs[key]['keyframes_inserted']}",
                  file=sys.stderr, flush=True)
    return runs


def same_frames(prefix: str, room: dict, apis: dict, stop, start: int, gt) -> dict:
    """Both packages' drives, each also from kf_t one ulp moved, on the same
    undistorted frames (JAX's remap_bilinear output, no grid attached): the
    distance per window, the kf_t spreads and the kf_t verdict once the
    packages share the image rounding."""
    fr = room_frames(room, same=True)[1]
    runs = _drives(prefix, apis, [("", fr, False), ("_ulp", fr, True)], stop, start)
    return {**{k: drive_summary(r, gt) for k, r in runs.items()},
            "torch_vs_jax": pair_summary(runs["torch"], runs["jax"]),
            "spread_per_window": {pkg: smoke.window_distances(runs[pkg + "_ulp"], runs[pkg])
                                  for pkg in ("jax", "torch")},
            "verdict": smoke.parting_of_runs(runs)}


def _kf_decision(eng, n_inl: int, n_kf: int, n_lm: int, frame: int) -> tuple:
    """The chunk step's keyframe decision and BA gate for a frame with
    `n_inl` inliers, on the engine's counters (the carry rebuilt from them:
    last_ba_frame = last_kf_frame)."""
    cfg, mc = eng.cfg, eng.cfg.map_cfg
    since = frame - eng.last_kf_frame
    want = since >= cfg.kf_min_interval and (
        since >= cfg.kf_max_interval
        or n_inl < np.float32(cfg.kf_inlier_ratio) * np.float32(eng.inliers_at_last_kf))
    kf = (n_inl >= cfg.min_inliers and want and eng.mapping_enabled
          and n_kf < mc.max_keyframes and n_lm < mc.max_landmarks - mc.num_keypoints)
    interval = cfg.scan_ba_min_interval
    ba = kf and cfg.local_ba_window > 0 and (interval <= 0 or since >= interval)
    return bool(kf), bool(ba)


def _stages_jax(eng, img, frame: int) -> dict:
    """track_frame's stages for one frame in the JAX package, as the chunk
    step runs them (tracker.py:133-230, device_loop.py's step), from the
    engine's state."""
    import jax
    import jax.numpy as jnp

    from lpslam_tpu.backend.ba import local_ba
    from lpslam_tpu.frontend.pose_opt import pose_only_optimize
    from lpslam_tpu.frontend.tracker import insert_keyframe, track_frame
    from lpslam_tpu.geometry.camera import project_pinhole
    from lpslam_tpu.geometry.se3 import se3_compose
    from lpslam_tpu.kernels.match import match_projected
    from lpslam_tpu.kernels.orb import extract_orb

    cfg, cam, m = eng.cfg, eng.cam, eng.map
    out = {"image": np.asarray(img, np.float32)}
    feats = jax.tree.map(lambda x: x[0], jax.jit(jax.vmap(lambda im: extract_orb(im, cfg.orb)))(
        jnp.asarray(img, jnp.float32)[None]))
    out["keypoints"] = {k: np.asarray(getattr(feats, k)) for k in ("xy", "level", "valid")}
    out["descriptor_bits"] = np.asarray(feats.desc)
    lost = eng.status.name == "LOST"
    pred = eng.pose if lost else se3_compose(eng.velocity, eng.pose)
    radius = cfg.match_radius_lost if lost else cfg.match_radius
    M, cap = m.lm_pos.shape[0], cfg.track_local_cap
    local_cap = cap if cap and cap < M else None
    p_c = jnp.einsum("ij,nj->ni", pred.R, m.lm_pos) + pred.t
    uv = project_pinhole(cam, p_c)
    vis = m.lm_valid & (p_c[:, 2] > 1e-3) & (uv[:, 0] >= 0.0) & (uv[:, 1] >= 0.0)
    sel = jnp.arange(M, dtype=jnp.int32)
    if local_cap is not None:
        found = m.lm_n_found.astype(jnp.float32) / (m.lm_n_visible.astype(jnp.float32) + 1.0)
        sel = jax.lax.top_k(vis.astype(jnp.float32) * 2.0 + found, local_cap)[1]
    out["top_k"] = np.asarray(sel)
    lm_pos, lm_desc, lm_valid = m.lm_pos[sel], m.lm_desc[sel], m.lm_valid[sel]
    idx, ok = match_projected(lm_desc, uv[sel], vis[sel], feats.desc, feats.xy, feats.valid,
                              radius=radius, max_distance=cfg.match_max_hamming)
    out["match_1"] = np.asarray(jnp.where(ok, idx, -1))
    s2 = jnp.float32(1.2) ** (2.0 * feats.level[idx].astype(jnp.float32))
    r = pose_only_optimize(pred, cam, lm_pos, feats.xy[idx], ok, sigma2=s2, iters=6)
    out["pose_1"] = np.concatenate([np.asarray(r.pose.R).ravel(), np.asarray(r.pose.t)])
    p_c2 = jnp.einsum("ij,nj->ni", r.pose.R, lm_pos) + r.pose.t
    idx, ok = match_projected(lm_desc, project_pinhole(cam, p_c2), lm_valid & (p_c2[:, 2] > 1e-3),
                              feats.desc, feats.xy, feats.valid, radius=6.0,
                              max_distance=cfg.match_max_hamming)
    out["match_2"] = np.asarray(jnp.where(ok, idx, -1))
    s2 = jnp.float32(1.2) ** (2.0 * feats.level[idx].astype(jnp.float32))
    r = pose_only_optimize(r.pose, cam, lm_pos, feats.xy[idx], ok, sigma2=s2, iters=4)
    out["pose_2"] = np.concatenate([np.asarray(r.pose.R).ravel(), np.asarray(r.pose.t)])
    tr = track_frame(m, pred, cam, feats, radius, cfg.match_max_hamming,
                     local_cap=local_cap)
    n_inl = int(tr.n_inliers)
    out["track_frame"] = np.concatenate([np.asarray(tr.pose.R).ravel(), np.asarray(tr.pose.t),
                                         [n_inl]])
    kf, ba = _kf_decision(eng, n_inl, int(tr.map.n_kf), int(tr.map.n_lm), frame)
    out["keyframe"] = np.array([kf, ba])
    if kf:
        m2 = insert_keyframe(tr.map, tr.pose, cam, feats, tr.kp_lm_idx, frame, cfg)
        if ba:
            m2 = local_ba(m2, cam, window=cfg.local_ba_window, iters=cfg.local_ba_iters,
                          covisibility=cfg.local_ba_covisibility)[0]
        out["local_ba"] = {"kf_t": np.asarray(m2.kf_t), "lm_pos": np.asarray(m2.lm_pos),
                           "lm_valid": np.asarray(m2.lm_valid)}
    return out


def _stages_torch(eng, img, frame: int) -> dict:
    """_stages_jax in the port (frontend/tracker.py::track_frame,
    device_loop.py's step)."""
    import torch

    from lpslam_tpu_torch.backend.ba import local_ba
    from lpslam_tpu_torch.frontend.pose_opt import pose_only_optimize
    from lpslam_tpu_torch.frontend.tracker import insert_keyframe, track_frame
    from lpslam_tpu_torch.geometry.camera import project_pinhole
    from lpslam_tpu_torch.geometry.se3 import se3_compose
    from lpslam_tpu_torch.kernels.fast import topk_stable
    from lpslam_tpu_torch.kernels.match import match_projected
    from lpslam_tpu_torch.kernels.orb import OrbFeatures, extract_orb

    cfg, cam, m = eng.cfg, eng.cam, eng.map
    out = {"image": np.asarray(img, np.float32)}
    feats = OrbFeatures(*(f[0] for f in extract_orb(
        torch.as_tensor(np.asarray(img, np.float32))[None], cfg.orb)))
    out["keypoints"] = {"xy": feats.xy.numpy(), "level": feats.level.numpy(),
                        "valid": feats.valid.numpy()}
    out["descriptor_bits"] = feats.desc.numpy().view(np.uint32)
    lost = eng.status.name == "LOST"
    pred = eng.pose if lost else se3_compose(eng.velocity, eng.pose)
    radius = cfg.match_radius_lost if lost else cfg.match_radius
    M, cap = m.lm_pos.shape[0], cfg.track_local_cap
    local_cap = cap if cap and cap < M else None
    p_c = m.lm_pos @ pred.R.T + pred.t
    uv = project_pinhole(cam, p_c)
    vis = m.lm_valid & (p_c[:, 2] > 1e-3) & (uv[:, 0] >= 0.0) & (uv[:, 1] >= 0.0)
    sel = torch.arange(M)
    if local_cap is not None:
        found = m.lm_n_found.to(torch.float32) / (m.lm_n_visible.to(torch.float32) + 1.0)
        sel = topk_stable(vis.to(torch.float32) * 2.0 + found, local_cap)[1]
    out["top_k"] = sel.numpy().astype(np.int32)
    lm_pos, lm_desc, lm_valid = m.lm_pos[sel], m.lm_desc[sel], m.lm_valid[sel]
    base = torch.tensor(1.2, dtype=torch.float32)
    idx, ok = match_projected(lm_desc, uv[sel], vis[sel], feats.desc, feats.xy, feats.valid,
                              radius=radius, max_distance=cfg.match_max_hamming)
    out["match_1"] = torch.where(ok, idx, -1).numpy().astype(np.int32)
    r = pose_only_optimize(pred, cam, lm_pos, feats.xy[idx], ok,
                           sigma2=base ** (2.0 * feats.level[idx].to(torch.float32)), iters=6)
    out["pose_1"] = np.concatenate([r.pose.R.numpy().ravel(), r.pose.t.numpy()])
    p_c2 = lm_pos @ r.pose.R.T + r.pose.t
    idx, ok = match_projected(lm_desc, project_pinhole(cam, p_c2), lm_valid & (p_c2[:, 2] > 1e-3),
                              feats.desc, feats.xy, feats.valid, radius=6.0,
                              max_distance=cfg.match_max_hamming)
    out["match_2"] = torch.where(ok, idx, -1).numpy().astype(np.int32)
    r = pose_only_optimize(r.pose, cam, lm_pos, feats.xy[idx], ok,
                           sigma2=base ** (2.0 * feats.level[idx].to(torch.float32)), iters=4)
    out["pose_2"] = np.concatenate([r.pose.R.numpy().ravel(), r.pose.t.numpy()])
    tr = track_frame(m, pred, cam, feats, radius, cfg.match_max_hamming,
                     local_cap=local_cap, image_hw=np.shape(img)[-2:])
    n_inl = int(tr.n_inliers)
    out["track_frame"] = np.concatenate([tr.pose.R.numpy().ravel(), tr.pose.t.numpy(), [n_inl]])
    kf, ba = _kf_decision(eng, n_inl, int(tr.map.n_kf), int(tr.map.n_lm), frame)
    out["keyframe"] = np.array([kf, ba])
    if kf:
        m2 = insert_keyframe(tr.map, tr.pose, cam, feats, tr.kp_lm_idx, frame, cfg)
        if ba:
            m2 = local_ba(m2, cam, window=cfg.local_ba_window, iters=cfg.local_ba_iters,
                          covisibility=cfg.local_ba_covisibility)[0]
        out["local_ba"] = {"kf_t": m2.kf_t.numpy(), "lm_pos": m2.lm_pos.numpy(),
                           "lm_valid": m2.lm_valid.numpy()}
    return out


# the order --bisect compares the stages in, and the largest difference it
# takes for rounding: 0 for what must be bit-equal (keypoints, selections,
# matches, decisions); descriptor bits as the share that differs, which the
# packages' polar taps leave at ties (tests/test_torch_orb.py bounds the
# ties to 5% of the bits)
STAGES = (("image", 1e-3), ("keypoints", 0.0), ("descriptor_bits", 0.05), ("top_k", 0.0),
          ("match_1", 0.0),
          ("pose_1", 1e-5), ("match_2", 0.0), ("pose_2", 1e-5), ("track_frame", 1e-5),
          ("keyframe", 0.0), ("local_ba", smoke.PART_FLOOR))


def _max_diff(a, b) -> float:
    if isinstance(a, dict):
        if "lm_valid" in a:   # the map after local BA: positions of landmarks valid in both
            both = a["lm_valid"] & b["lm_valid"]
            return max(_max_diff(a["kf_t"], b["kf_t"]),
                       _max_diff(a["lm_pos"][both], b["lm_pos"][both]),
                       float(np.sum(a["lm_valid"] != b["lm_valid"])))
        return max(_max_diff(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    if a.dtype.kind in "biu":
        return float(np.sum(a != b))   # entries that differ
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def bisect_window(prefix: str, window: int, apis: dict, frames: dict, start: int) -> dict:
    """--bisect: JAX's track-on up to the window's first frame, its state
    saved there (map and engine) and loaded into both packages, then that
    frame's stages in each package from it (_stages_jax, _stages_torch).
    Reports per stage the largest difference (floats), the entries that
    differ (integers, flags) or the share of descriptor bits that differ,
    the first stage past its tolerance (STAGES), and descriptor_ties on
    JAX's undistorted frame (`same_image`)."""
    import tempfile

    from lpslam_tpu.mapstore.checkpoint import save_map

    frame = start + smoke.TRACK_WINDOW * window
    keep = {}
    smoke.track_on(apis["jax"], prefix, frames["jax"], stop=frame, keep=keep)
    pre = os.path.join(tempfile.mkdtemp(), f"pre_f{frame}")
    save_map(keep["tracker"].engine.map, pre + "_map.npz")
    smoke.save_engine_state(keep["tracker"], pre + "_engine.npz", np.asarray)
    with np.load(prefix + "_engine.npz") as f:
        config = dict(json.loads(str(f["config"])), loop_closure=False)
        cam = [float(c) for c in f["cam"]]
    stages, orb = {}, {}
    for pkg, fn in (("jax", _stages_jax), ("torch", _stages_torch)):
        api = apis[pkg]
        tracker = api.tracker(api.camera(*cam), config)
        smoke.load_engine_state(api, tracker, pre)
        img = api.to_np(frames[pkg].host(frame))
        stages[pkg] = fn(tracker.engine, img, frame)
        orb[pkg] = tracker.engine.cfg.orb
    out = {"window": window, "frame": frame, "stages": {},
           "same_image": descriptor_ties(stages["jax"]["image"], orb["jax"], orb["torch"])}
    for name, tol in STAGES:
        a, b = stages["jax"].get(name), stages["torch"].get(name)
        if a is None or b is None:
            out["stages"][name] = None if a is None and b is None else "in one package only"
            d = 0.0 if a is None and b is None else float("inf")
        elif name == "descriptor_bits":
            d = out["stages"][name] = float(np.mean(
                np.unpackbits(np.ascontiguousarray(a).view(np.uint8))
                != np.unpackbits(np.ascontiguousarray(b).view(np.uint8))))
        else:
            d = out["stages"][name] = _max_diff(a, b)
        if d > tol and "first_stage_differs" not in out:
            out["first_stage_differs"] = name
    out.setdefault("first_stage_differs", None)
    return out


def descriptor_ties(img, params_jax, params_torch) -> dict:
    """Both packages' ORB features of one image: the keypoints whose
    position differs, the share of descriptor bits that differ on the
    keypoints both found, and how many of those lie outside the ties that
    tests/test_torch_orb.py allows (the bit's two polar taps within 1e-3 of
    each other in JAX's exact tap values, or the angle within 1e-4 rad of a
    12-degree bin boundary). Polar descriptors only (None otherwise)."""
    if params_jax.brief_mode != "polar":
        return None
    import jax
    import jax.numpy as jnp
    import torch

    from lpslam_tpu.kernels import orb as jorb
    from lpslam_tpu.kernels.pyramid import build_pyramid, gaussian_blur
    from lpslam_tpu_torch.kernels import orb as torb

    img = np.array(img, np.float32)
    fj = [np.asarray(x) for x in jax.jit(lambda im: jorb.extract_orb(im, params_jax))(
        jnp.asarray(img))]
    ft = [x[0].numpy() for x in torb.extract_orb(torch.from_numpy(img)[None], params_torch)]
    scale = params_jax.scale_factor
    pyr = build_pyramid(jnp.asarray(img), params_jax.num_levels, scale)
    bits = lambda d: np.unpackbits(np.ascontiguousarray(d).view(np.uint8), axis=1,  # noqa: E731
                                   bitorder="little").astype(bool)
    off = moved = n_bits = n_diff = n_outside = 0
    for lvl, k in enumerate(jorb._level_budgets(params_jax.num_keypoints,
                                                params_jax.num_levels, scale)):
        sl = slice(off, off + k)
        off += k
        both = fj[5][sl] & ft[5][sl]
        m = both & (fj[0][sl] == ft[0][sl]).all(1)
        moved += int((both & ~m).sum())
        angle = fj[2][sl][m]
        blurred = gaussian_blur(pyr[lvl], sigma=2.0, radius=3)
        patches = jorb.extract_patches(blurred, jnp.asarray(fj[0][sl][m] / np.float32(scale ** lvl)))
        vals = np.asarray(jorb.polar_tap_values_reference(patches, jnp.asarray(angle)))
        tie = np.abs(vals[:, :256] - vals[:, 256:]) < 1e-3
        pos = (angle + np.pi) / (2 * np.pi / jorb.N_ANGLE_BINS)
        near_bin = np.abs(pos - np.floor(pos) - 0.5) < 1e-4 * jorb.N_ANGLE_BINS / (2 * np.pi)
        diff = bits(ft[4][sl][m].view(np.uint32)) != bits(fj[4][sl][m])
        n_bits += diff.size
        n_diff += int(diff.sum())
        n_outside += int((diff & ~tie & ~near_bin[:, None]).sum())
    return {"keypoints_moved": moved, "bits_differ": n_diff / max(n_bits, 1),
            "bits_differ_outside_ties": n_outside}


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
    p.add_argument("--track-on", nargs="*", default=[], help="saved closure state prefixes")
    p.add_argument("--frames", type=int, default=0,
                   help="frames to track on (0: to the end of the run)")
    p.add_argument("--bisect", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if args.bisect and not args.ulp:
        p.error("--bisect needs --ulp (it starts where the kf_t verdict parts)")
    lines, full = [], []
    if args.save:
        at = [int(k) for k in args.at.split(",") if k]
        lines.append(json.dumps({"jax_cpu": save(args.save, at)}))
    if args.maps:
        lines.append(json.dumps(maps_side_by_side(*args.maps)))
    for prefix in args.verify:
        lines.append(json.dumps(verify_both(prefix)))
    for prefix in args.apply:
        lines.append(json.dumps(compare(prefix, args.ulp)))
    for prefix in args.track_on:
        out = track_on_both(prefix, args.frames, args.ulp, args.bisect)
        full.append(json.dumps(out))
        print(json.dumps({k: v for k, v in out.items() if k != "drives"}), flush=True)
    for line in lines:
        print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("".join(line + "\n" for line in lines + full))
    return 0


if __name__ == "__main__":
    sys.exit(main())
