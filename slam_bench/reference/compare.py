"""The comparison that decides `correct`: what the timed window produced,
worked out again or measured against the generator's ground truth, in
plain numpy and float32 torch on the host. Imports nothing of the program.

Every number is lower-is-better; a cell holds those that its limits file
(slam_bench/limits/<cell>.json) names to their limits, and prints the rest:
- ``feat_bits_mean``: over the keypoints that the reference's own
  rectification and ORB extraction find on a sample of the window's
  keyframes, the mean number of descriptor bits (of 256) in which the
  keyframe stored by the program differs, a keypoint it lacks (no valid
  keypoint within 0.01 px) counting all 256;
- ``feat_missing_share``, ``desc_bits_mean``: the two parts of that, the
  share of keypoints missing and the mean bits over those found;
- ``traj_seg_rmse_m``: the window's tracked camera centres in segments of
  ``SEGMENT`` frames, each aligned to the ground truth on its own (Sim3;
  SE3 where the configuration states metric scale), the worst segment's
  RMSE in metres; a segment with fewer than ``SEGMENT // 4`` tracked frames
  reads inf;
- ``rot_rpe_deg``: the RMS, over the window's pairs of tracked frames
  ``RPE_STEP`` frames apart, of the angle between the tracked and the true
  relative rotation (no alignment);
- ``lost_share``: frames handed in during the window whose result did not
  come back TRACKING;
- ``map_reproj_p50_px``, ``map_reproj_p90_px``: the median and 90th
  percentile reprojection error, in float64, of every observation in the
  final map (keyframe pose, landmark, stored keypoint);
- ``lm_depth_err_p50``: the median relative error of each observation's
  landmark depth against the ray-cast depth of the room at that keypoint,
  from the keyframe's true pose; per keyframe scaled by the median ratio
  (mono) or not scaled (metric scale);
- ``kf_rot_rpe_deg``: the RMS angle between the map's and the true relative
  rotation of keyframes neighbouring in frame order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..room import box_depth, orbit_pose

from . import camera, orb

NUMBERS = ("feat_bits_mean", "feat_missing_share", "desc_bits_mean", "traj_seg_rmse_m",
           "rot_rpe_deg", "lost_share", "map_reproj_p50_px", "map_reproj_p90_px",
           "lm_depth_err_p50", "kf_rot_rpe_deg")
SEGMENT = 64
RPE_STEP = 8
FEATURE_SAMPLE = 4
XY_TOL = 0.01


def reference_camera(intr: dict, mode: str, baseline: float):
    """(K (3, 3) float64 of the tracked view, the left eye's remap grid)."""
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1.0]])
    size = (intr["height"], intr["width"])
    dist = np.asarray(intr["dist"], np.float64)
    if mode == "stereo":
        res = camera.rectify_maps_stereo(K, dist, K, dist, np.eye(3),
                                         np.array([-baseline, 0.0, 0.0]), size)
        return res["K_new"].astype(np.float64), res["map_l"]
    return K, camera.undistort_map_radtan(K, dist, size)


def quat_lp_to_R_wc(q_lp) -> np.ndarray:
    """A result's orientation (w, -y, x, z of the optical q_cw, as the
    pipeline tracker reports it) -> optical R_wc, (..., 3, 3)."""
    q = np.asarray(q_lp, np.float64)
    w, x, y, z = q[..., 0], q[..., 2], -q[..., 1], q[..., 3]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    R_cw = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return np.swapaxes(R_cw, -1, -2)


def lp_to_optical(p) -> np.ndarray:
    """lpslam (x, y, z) -> optical (y, -x, z)."""
    p = np.asarray(p, np.float64)
    return np.stack([p[..., 1], -p[..., 0], p[..., 2]], -1)


def umeyama(src, dst, with_scale: bool):
    """dst ~ s R src + t for (N, 3) point sets: (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / max((xs ** 2).sum() / len(src), 1e-12) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def rot_angle_deg(Ra, Rb) -> np.ndarray:
    """Angle between rotations, from |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2),
    which keeps its precision near zero (arccos of the trace does not)."""
    d = np.sqrt(np.sum((np.asarray(Ra) - np.asarray(Rb)) ** 2, axis=(-2, -1)))
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))


def trajectory_numbers(frames, lap: int, metric: bool) -> dict:
    """frames: dict of arrays over the window's frames in hand-in order:
    lap_idx, tracked (bool), position_lp (N, 3), quat_lp (N, 4)."""
    n = len(frames["lap_idx"])
    tracked = np.asarray(frames["tracked"], bool)
    out = {"lost_share": float(1.0 - tracked.mean()) if n else math.inf}
    gt = [orbit_pose(int(i), lap) for i in frames["lap_idx"]]
    R_gt = np.stack([g[0] for g in gt]) if n else np.zeros((0, 3, 3))
    C_gt = np.stack([g[1] for g in gt]) if n else np.zeros((0, 3))
    C_est = lp_to_optical(np.asarray(frames["position_lp"]).reshape(-1, 3))
    R_est = quat_lp_to_R_wc(np.asarray(frames["quat_lp"]).reshape(-1, 4))
    worst = 0.0
    starts = list(range(0, max(n - SEGMENT // 2, 1), SEGMENT))
    for k, s in enumerate(starts):
        e = n if k == len(starts) - 1 else s + SEGMENT
        sel = np.flatnonzero(tracked[s:e]) + s
        if len(sel) < SEGMENT // 4:
            return dict(out, traj_seg_rmse_m=math.inf, rot_rpe_deg=math.inf)
        sc, Ra, ta = umeyama(C_est[sel], C_gt[sel], with_scale=not metric)
        err = np.linalg.norm((sc * C_est[sel] @ Ra.T + ta) - C_gt[sel], axis=1)
        worst = max(worst, float(np.sqrt(np.mean(err ** 2))))
    i = np.flatnonzero(tracked[:-RPE_STEP] & tracked[RPE_STEP:]) if n > RPE_STEP else []
    if len(i) == 0:
        return dict(out, traj_seg_rmse_m=worst, rot_rpe_deg=math.inf)
    j = i + RPE_STEP
    rel_gt = np.einsum("nji,njk->nik", R_gt[i], R_gt[j])
    rel_est = np.einsum("nji,njk->nik", R_est[i], R_est[j])
    ang = rot_angle_deg(rel_gt, rel_est)
    return dict(out, traj_seg_rmse_m=worst, rot_rpe_deg=float(np.sqrt(np.mean(ang ** 2))))


def map_numbers(m: dict, K: np.ndarray, lap_of_fid, lap: int, metric: bool) -> dict:
    """m: the final map as numpy (kf_R, kf_t, kf_valid, kf_frame_id, kf_uv,
    kf_kp_valid, kf_lm_idx, lm_pos, lm_valid)."""
    kk, nn = np.nonzero(m["kf_valid"][:, None] & m["kf_kp_valid"] & (m["kf_lm_idx"] >= 0))
    lm = m["kf_lm_idx"][kk, nn].astype(np.int64)
    keep = m["lm_valid"][lm]
    kk, nn, lm = kk[keep], nn[keep], lm[keep]
    if len(kk) == 0:
        return dict.fromkeys(("map_reproj_p50_px", "map_reproj_p90_px", "lm_depth_err_p50",
                              "kf_rot_rpe_deg"), math.inf)
    R = m["kf_R"].astype(np.float64)[kk]
    t = m["kf_t"].astype(np.float64)[kk]
    p_c = np.einsum("nij,nj->ni", R, m["lm_pos"].astype(np.float64)[lm]) + t
    uv = m["kf_uv"].astype(np.float64)[kk, nn]
    z = p_c[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        proj = np.stack([K[0, 0] * p_c[:, 0] / z + K[0, 2], K[1, 1] * p_c[:, 1] / z + K[1, 2]], 1)
        reproj = np.where(z > 1e-6, np.linalg.norm(proj - uv, axis=1), np.inf)
    # ground-truth depth along each keypoint's ray from the keyframe's true pose
    fids = m["kf_frame_id"][kk].astype(np.int64)
    z_gt = np.empty(len(kk))
    Kinv = np.linalg.inv(K)
    ray = np.concatenate([uv, np.ones((len(uv), 1))], 1) @ Kinv.T
    for f in np.unique(fids):
        sel = fids == f
        R_wc, C = orbit_pose(int(lap_of_fid[f]), lap)
        z_gt[sel] = box_depth(C, ray[sel] @ R_wc.T)
    rel = np.full(len(kk), np.inf)
    for k in np.unique(kk):
        sel = (kk == k) & (z > 1e-6) & np.isfinite(z_gt)
        if not sel.any():
            continue
        s = 1.0 if metric else float(np.median(z_gt[sel] / z[sel]))
        rel[sel] = np.abs(s * z[sel] - z_gt[sel]) / z_gt[sel]
    ks = np.flatnonzero(m["kf_valid"])
    ks = ks[np.argsort(m["kf_frame_id"][ks], kind="stable")]
    R_wc = np.swapaxes(m["kf_R"].astype(np.float64)[ks], 1, 2)
    R_gt = np.stack([orbit_pose(int(lap_of_fid[f]), lap)[0] for f in m["kf_frame_id"][ks]])
    ang = rot_angle_deg(np.einsum("nji,njk->nik", R_gt[:-1], R_gt[1:]),
                        np.einsum("nji,njk->nik", R_wc[:-1], R_wc[1:]))
    return {"map_reproj_p50_px": float(np.median(reproj)),
            "map_reproj_p90_px": float(np.quantile(reproj, 0.9, method="higher")),
            "lm_depth_err_p50": float(np.median(rel)),
            "kf_rot_rpe_deg": float(np.sqrt(np.mean(ang ** 2))) if len(ang) else math.inf}


def feature_numbers(m: dict, raw_left, grid, orb_params: orb.Orb, lap_of_fid, fids_allowed,
                    seed: int) -> dict:
    """raw_left(lap_idx) -> (H, W) uint8 raw left frame."""
    cand = [k for k in np.flatnonzero(m["kf_valid"]) if int(m["kf_frame_id"][k]) in fids_allowed]
    if not cand:
        return dict.fromkeys(("feat_bits_mean", "feat_missing_share", "desc_bits_mean"), math.inf)
    rng = np.random.default_rng(int(seed) % 2**63)
    pick = rng.choice(cand, size=min(FEATURE_SAMPLE, len(cand)), replace=False)
    grid_t = torch.from_numpy(np.ascontiguousarray(grid, np.float32))
    missing = total = 0
    bits = []
    for k in sorted(int(x) for x in pick):
        raw = torch.from_numpy(np.asarray(raw_left(int(lap_of_fid[int(m["kf_frame_id"][k])])),
                                          np.float32))
        ref = orb.extract_orb(camera.remap_bilinear(raw, grid_t), orb_params)
        r_xy = ref.xy.numpy()[ref.valid.numpy()]
        r_desc = ref.desc.numpy()[ref.valid.numpy()]
        pv = m["kf_kp_valid"][k]
        p_xy, p_desc = m["kf_uv"][k][pv], m["kf_desc"][k][pv]
        total += len(r_xy)
        if len(p_xy) == 0:
            missing += len(r_xy)
            continue
        d2 = ((r_xy[:, None, :] - p_xy[None, :, :]) ** 2).sum(-1)
        ri, pj = np.nonzero(d2 <= XY_TOL ** 2)
        # where keypoints of two levels share a position, the nearer descriptor
        x = r_desc[ri].view(np.uint32) ^ p_desc[pj].view(np.uint32)
        pair_bits = np.unpackbits(x.view(np.uint8), axis=1).sum(1)
        best = np.full(len(r_xy), 257)
        np.minimum.at(best, ri, pair_bits)
        found = best <= 256
        missing += int((~found).sum())
        bits.extend(best[found].tolist())
    return {"feat_bits_mean": (float(np.sum(bits)) + 256.0 * missing) / max(total, 1),
            "feat_missing_share": missing / max(total, 1),
            "desc_bits_mean": float(np.mean(bits)) if bits else math.inf}


def compare(outputs: dict, cfg: dict, intr: dict, seed: int) -> dict:
    """Every number of the comparison from the run's outputs (see
    harness.collect_outputs) and the configuration."""
    mode = cfg["sensor"]["mode"]
    metric = bool(cfg["sensor"].get("metric_scale", False))
    lap = cfg["lap_frames"]
    K, grid = reference_camera(intr, mode, cfg["sensor"].get("baseline", 0.0))
    t = cfg["tracker"]
    orb_params = orb.Orb(num_keypoints=t["keypoints"], num_levels=t["levels"],
                         scale_factor=t["scale_factor"], fast_threshold=t["fast_threshold"],
                         fast_min_threshold=t["fast_min_threshold"])
    nums = {}
    nums.update(feature_numbers(outputs["map"], outputs["raw_left"], grid, orb_params,
                                outputs["lap_of_fid"], outputs["fids_after_setup"], seed))
    nums.update(trajectory_numbers(outputs["frames"], lap, metric))
    nums.update(map_numbers(outputs["map"], K, outputs["lap_of_fid"], lap, metric))
    return nums
