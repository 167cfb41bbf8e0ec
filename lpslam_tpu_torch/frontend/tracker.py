"""Monocular tracking frontend (port of lpslam_tpu/frontend/tracker.py).

Device steps — ``track_frame``, ``insert_keyframe``,
``triangulate_new_landmarks`` — are tensor code on the MonoTracker's device.
``MonoTracker`` is the host state machine (NOT_INITIALIZED -> INITIALIZING
-> TRACKING <-> LOST) with constant-velocity prediction, the keyframe policy,
two-view initialization and the async-mapping double buffer.

The depth trackers (frontend/stereo.py) subclass ``MonoTracker`` through
its hooks: ``_needs_two_frames``, ``_try_initialize(feats, aux)`` and
``_make_keyframe_map``. ``relocalize_with_candidates`` places a LOST engine
against candidate keyframes (frontend/relocalize.py); the pipeline tracker
(pipeline/trackers.py) supplies BoW candidates. ``process(..., nav_prior=)``
takes a navigation pose prediction in place of the constant-velocity one;
``set_mask`` installs a keypoint mask and ``mapping_enabled = False`` stops
keyframe insertion (localization only).

Compaction results are queued with a CUDA event recorded right behind the
compaction on the current stream (``_queue_compaction``): "ready" means that
event has completed, the meaning JAX's ``is_ready()`` has for the culled
count. On the CPU the work is done when the call returns, so a queued result
is always ready.
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry.camera import PinholeCamera, project_pinhole
from ..geometry.se3 import (
    SE3, se3_compose, se3_exp, se3_identity, se3_inverse, se3_log,
)
from ..kernels.fast import topk_stable
from ..kernels.match import match_mutual_nn, match_projected, orientation_consistency
from ..kernels.orb import OrbFeatures, OrbParams, extract_orb
from ..mapstore.store import (
    MapConfig,
    MapStore,
    cull_and_compact,
    empty_map,
    insert_keyframe_slots,
    scatter_drop,
    set_row,
)
from ..utils import timing
from .init2v import two_view_init_homography
from .pose_opt import pose_only_optimize
from .triangulate import triangulate_midpoint


class TrackerStatus(IntEnum):
    NOT_INITIALIZED = 0
    INITIALIZING = 1
    TRACKING = 2
    LOST = 3


class TrackerConfig(NamedTuple):
    """The JAX package's tracker configuration."""

    orb: OrbParams = OrbParams()
    map_cfg: MapConfig = MapConfig()
    match_radius: float = 25.0
    match_radius_lost: float = 50.0
    match_max_hamming: int = 80
    min_inliers: int = 25
    init_min_matches: int = 60
    init_min_flow_px: float = 20.0
    kf_min_interval: int = 3
    kf_max_interval: int = 5
    kf_inlier_ratio: float = 0.85
    tri_max_reproj_px: float = 4.0
    tri_min_parallax_cos: float = 0.99998
    tri_min_depth: float = 0.05
    tri_max_depth: float = 1e4
    local_ba_window: int = 6
    local_ba_iters: int = 6
    local_ba_covisibility: bool = True
    scan_ba_min_interval: int = 8
    # the depth modes' in-loop BA rate cap; 0 = BA on every keyframe
    scan_ba_min_interval_depth: int = 0
    kf_culling: bool = True
    kf_cull_redundancy: float = 0.9
    kf_cull_min_other_obs: int = 3
    kf_cull_keep_latest: int = 3
    async_mapping: bool = True
    track_local_cap: int = 4096
    velocity_gain: float = 0.5


class TrackResult(NamedTuple):
    pose: SE3
    n_inliers: torch.Tensor
    kp_lm_idx: torch.Tensor   # (N,) landmark id per frame keypoint, -1 = none
    n_visible: torch.Tensor
    map: MapStore             # with updated visibility statistics
    sigma_pos: torch.Tensor = None
    sigma_rot: torch.Tensor = None


def _row(arr, k):
    """arr[k] for a 0-d index tensor, without a host round trip."""
    return arr.index_select(0, k.reshape(1).to(torch.int64))[0]


# ---------------------------------------------------------------------------
# Device steps
# ---------------------------------------------------------------------------


def track_frame(m: MapStore, pose_pred: SE3, cam: PinholeCamera,
                feats: OrbFeatures, radius, max_hamming: int,
                local_cap: Optional[int] = None, *, image_hw) -> TrackResult:
    """Project the map into the predicted view, match in windows, optimize
    the pose, re-project and re-match in a tight window, optimize again.

    local_cap: match against at most this many landmarks — visible first,
    then by found ratio, ties to the lowest slot (a stable sort).
    "Visible" is in front with u, v >= 0 (the JAX package's test). When more
    landmarks pass it than the cap holds, those projecting inside the frame
    of size image_hw = (H, W) rank first, so that the cap does not cut
    landmarks in view for ones off the frame's right or bottom edge. Below
    the cap the order is the JAX package's, which has no image_hw."""
    with timing.span("track_frame"):
        P = m.lm_pos.shape[0]
        dev = m.lm_pos.device
        p_c = m.lm_pos @ pose_pred.R.T + pose_pred.t
        uv_pred_full = project_pinhole(cam, p_c)
        visible_full = (
            m.lm_valid
            & (p_c[:, 2] > 1e-3)
            & (uv_pred_full[:, 0] >= 0.0)
            & (uv_pred_full[:, 1] >= 0.0)
        )
        if local_cap is not None and local_cap < P:
            found_ratio = m.lm_n_found.to(torch.float32) / (
                m.lm_n_visible.to(torch.float32) + 1.0
            )
            score = visible_full.to(torch.float32) * 2.0 + found_ratio
            in_view = (visible_full & (uv_pred_full[:, 0] < image_hw[1])
                       & (uv_pred_full[:, 1] < image_hw[0]))
            # a device-side choice: below the cap the order is unchanged
            score = torch.where(torch.sum(visible_full) > local_cap,
                                score + in_view.to(torch.float32), score)
            _, sel = topk_stable(score, local_cap)
        else:
            sel = torch.arange(P, device=dev)
        lm_pos = m.lm_pos[sel]
        lm_desc = m.lm_desc[sel]
        lm_valid = m.lm_valid[sel]
        visible = visible_full[sel]
        uv_pred = uv_pred_full[sel]
        base = torch.tensor(1.2, dtype=torch.float32, device=dev)

        idx, ok = match_projected(
            lm_desc, uv_pred, visible, feats.desc, feats.xy, feats.valid,
            radius=radius, max_distance=max_hamming,
        )
        sigma2 = base ** (2.0 * feats.level[idx].to(torch.float32))
        res = pose_only_optimize(
            pose_pred, cam, lm_pos, feats.xy[idx], ok, sigma2=sigma2, iters=6
        )
        # second stage: re-project with the optimized pose, tight window
        p_c2 = lm_pos @ res.pose.R.T + res.pose.t
        uv_pred2 = project_pinhole(cam, p_c2)
        visible2 = lm_valid & (p_c2[:, 2] > 1e-3)
        idx, ok = match_projected(
            lm_desc, uv_pred2, visible2, feats.desc, feats.xy, feats.valid,
            radius=6.0, max_distance=max_hamming,
        )
        sigma2 = base ** (2.0 * feats.level[idx].to(torch.float32))
        res = pose_only_optimize(
            res.pose, cam, lm_pos, feats.xy[idx], ok, sigma2=sigma2, iters=4
        )
        # invert the association: frame keypoint -> store landmark id. Where two
        # landmarks claim one keypoint the later row wins, as JAX's sequential
        # CPU scatter does.
        n_kp = feats.xy.shape[0]
        good_lm = ok & res.inlier
        rows = torch.arange(sel.shape[0], device=dev)
        winner = torch.full((n_kp + 1,), -1, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(
            0, torch.where(good_lm, idx, n_kp), torch.where(good_lm, rows, -1),
            reduce="amax",
        )
        winner = winner[:n_kp]
        kp_lm = torch.where(
            winner >= 0, sel[torch.clamp(winner, min=0)], -1
        ).to(torch.int32)
        vis_upd = torch.zeros((P,), dtype=torch.int32, device=dev)
        vis_upd.index_add_(0, sel, visible2.to(torch.int32))
        found_upd = torch.zeros((P,), dtype=torch.int32, device=dev)
        found_upd.index_add_(0, sel, good_lm.to(torch.int32))
        m = m._replace(
            lm_n_visible=m.lm_n_visible + vis_upd,
            lm_n_found=m.lm_n_found + found_upd,
        )
        return TrackResult(
            pose=res.pose,
            n_inliers=res.n_inliers,
            kp_lm_idx=kp_lm,
            n_visible=torch.sum(visible2).to(torch.int32),
            map=m,
            sigma_pos=res.sigma_pos,
            sigma_rot=res.sigma_rot,
        )


def insert_keyframe(m: MapStore, pose: SE3, cam: PinholeCamera,
                    feats: OrbFeatures, kp_lm_idx, frame_id,
                    cfg: TrackerConfig) -> MapStore:
    """Cull poorly matched landmarks, write the frame as a keyframe and
    triangulate new landmarks against the previous keyframe."""
    with timing.span("insert_keyframe"):
        poor = (m.lm_n_visible >= 8) & (
            m.lm_n_found.to(torch.float32) < 0.25 * m.lm_n_visible.to(torch.float32)
        )
        m = m._replace(lm_valid=m.lm_valid & ~poor)
        m = insert_keyframe_slots(
            m, pose.R, pose.t, feats.xy, feats.desc, feats.valid, kp_lm_idx, frame_id
        )
        return triangulate_new_landmarks(m, cam, cfg)


def triangulate_new_landmarks(m: MapStore, cam: PinholeCamera,
                              cfg: TrackerConfig) -> MapStore:
    """Triangulate the newest keyframe's unassociated keypoints against the
    previous keyframe and append the survivors as landmarks."""
    k_new = m.n_kf - 1
    ref = torch.clamp(m.n_kf - 2, min=0)
    feats_xy = _row(m.kf_uv, k_new)
    feats_desc = _row(m.kf_desc, k_new)
    pose = SE3(_row(m.kf_R, k_new), _row(m.kf_t, k_new))
    kp_lm_new = _row(m.kf_lm_idx, k_new)
    kp_lm_ref = _row(m.kf_lm_idx, ref)

    new_unassoc = _row(m.kf_kp_valid, k_new) & (kp_lm_new < 0)
    ref_unassoc = _row(m.kf_kp_valid, ref) & (kp_lm_ref < 0)
    idx_ref, ok = match_mutual_nn(
        feats_desc, _row(m.kf_desc, ref), new_unassoc, ref_unassoc,
        max_distance=cfg.match_max_hamming, ratio=0.9,
    )
    T_ref = SE3(_row(m.kf_R, ref), _row(m.kf_t, ref))
    uv_ref = _row(m.kf_uv, ref)[idx_ref]
    pts, info = triangulate_midpoint(T_ref, pose, cam, uv_ref, feats_xy)

    e1 = torch.sum((project_pinhole(cam, pts @ T_ref.R.T + T_ref.t) - uv_ref) ** 2, -1)
    e2 = torch.sum((project_pinhole(cam, pts @ pose.R.T + pose.t) - feats_xy) ** 2, -1)
    good = (
        ok
        & (info["z1"] > cfg.tri_min_depth)
        & (info["z2"] > cfg.tri_min_depth)
        & (info["z1"] < cfg.tri_max_depth)
        & (info["z2"] < cfg.tri_max_depth)
        & (info["cos_parallax"] < cfg.tri_min_parallax_cos)
        & (e1 < cfg.tri_max_reproj_px**2)
        & (e2 < cfg.tri_max_reproj_px**2)
    )

    # landmark slots: n_lm + rank among the good ones; past capacity drops
    M = m.lm_pos.shape[0]
    rank = torch.cumsum(good.to(torch.int64), 0) - 1
    slot = torch.where(good, m.n_lm + rank, M)
    slot = torch.where(slot < M, slot, M)
    made = (slot < M) & good
    n_new = torch.sum(made).to(torch.int32)

    lm_pos = scatter_drop(m.lm_pos, slot, pts)
    lm_desc = scatter_drop(m.lm_desc, slot, feats_desc)
    lm_valid = scatter_drop(m.lm_valid, slot, True)
    lm_n_obs = scatter_drop(m.lm_n_obs, slot, 2)
    lm_first_kf = scatter_drop(m.lm_first_kf, slot, k_new.to(torch.int32))

    n_kp = feats_xy.shape[0]
    new_lm_for_kp = torch.where(made, slot, -1).to(torch.int32)
    kf_lm_new = torch.where(new_lm_for_kp >= 0, new_lm_for_kp, kp_lm_new)
    kf_lm_ref = scatter_drop(
        kp_lm_ref, torch.where(made, idx_ref, n_kp), new_lm_for_kp
    )
    kf_lm_idx = set_row(m.kf_lm_idx, k_new, kf_lm_new)
    kf_lm_idx = set_row(kf_lm_idx, ref, kf_lm_ref)
    return m._replace(
        lm_pos=lm_pos, lm_desc=lm_desc, lm_valid=lm_valid, lm_n_obs=lm_n_obs,
        lm_first_kf=lm_first_kf, kf_lm_idx=kf_lm_idx,
        n_lm=torch.clamp(m.n_lm + n_new, max=M),
    )


def _apply_mask(feats: OrbFeatures, mask) -> OrbFeatures:
    """Invalidate keypoints on masked-out pixels; mask: (H, W) bool, True
    where keypoints may lie."""
    h, w = mask.shape
    xi = torch.clamp(feats.xy[..., 0].to(torch.int32), 0, w - 1).to(torch.int64)
    yi = torch.clamp(feats.xy[..., 1].to(torch.int32), 0, h - 1).to(torch.int64)
    return feats._replace(valid=feats.valid & mask[yi, xi])


# ---------------------------------------------------------------------------
# Host state machine
# ---------------------------------------------------------------------------


class MonoTracker:
    """Host-side orchestration of the device tracking steps on `device`."""

    def __init__(self, cam: PinholeCamera, cfg: TrackerConfig = TrackerConfig(),
                 *, device):
        self.device = torch.device(device)
        self.cam = PinholeCamera(*(v.to(self.device) for v in cam))
        self.cfg = cfg
        self.map = empty_map(cfg.map_cfg, self.device)
        self.status = TrackerStatus.NOT_INITIALIZED
        self.pose = se3_identity(self.device)
        self.velocity = se3_identity(self.device)
        self.frame_id = 0
        self.last_kf_frame = -(10**9)
        self.inliers_at_last_kf = 1
        self._init_feats: Optional[OrbFeatures] = None
        self._init_frame_id = -1
        self.last_sigma_pos = np.zeros(3, np.float32)
        self.last_sigma_rot = 0.0
        self.last_n_inliers = 0
        self.trajectory: list = []  # (frame_id, SE3 Tcw as numpy | None, status)
        self._compactions: list = []
        self._pending_map = None
        self._pending_compacts: list = []
        self._kf_count = 0

    # monocular init needs two frames with a baseline; the depth trackers
    # bootstrap from one
    _needs_two_frames = True
    # False: localization only, track against the map, insert no keyframe
    mapping_enabled = True
    # optional (H, W) bool tensor on the device, True where keypoints may lie
    mask = None

    def set_mask(self, mask) -> None:
        """Install a keypoint mask (nonzero = keep), or None to clear it."""
        if mask is not None and not torch.is_tensor(mask):
            mask = torch.from_numpy(np.asarray(mask))
        self.mask = None if mask is None else mask.to(self.device, torch.bool)

    def _extract(self, image) -> OrbFeatures:
        img = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        feats = extract_orb(img, self.cfg.orb)
        if self.mask is not None:
            feats = _apply_mask(feats, self.mask)
        return feats

    def _try_initialize(self, feats: OrbFeatures, aux=None) -> bool:
        f0 = self._init_feats
        idx, ok = match_mutual_nn(
            f0.desc, feats.desc, f0.valid, feats.valid,
            max_distance=self.cfg.match_max_hamming, ratio=0.85,
        )
        ok = orientation_consistency(f0.angle, feats.angle, idx, ok)
        if int(torch.sum(ok)) < self.cfg.init_min_matches:
            return False
        uv1 = f0.xy
        uv2 = feats.xy[idx]
        # real baseline first: a near-zero-parallax homography decomposes
        # into garbage
        flow = torch.linalg.norm(uv2 - uv1, dim=-1).cpu().numpy()
        okf = ok.cpu().numpy()
        med_flow = float(np.median(flow[okf])) if okf.any() else 0.0
        if med_flow < self.cfg.init_min_flow_px:
            return False
        res = two_view_init_homography(self.cam, uv1, uv2, ok)
        if not bool(res.ok):
            return False

        dev = self.device
        T1 = se3_identity(dev)
        T2 = SE3(res.T2cw[:9].reshape(3, 3), res.T2cw[9:])
        m = empty_map(self.cfg.map_cfg, dev)
        point_ok = res.point_ok
        Mcap = m.lm_pos.shape[0]
        slot = torch.where(point_ok, torch.cumsum(point_ok.to(torch.int64), 0) - 1, Mcap)
        n_new = int(torch.sum(point_ok))
        m = m._replace(
            lm_pos=scatter_drop(m.lm_pos, slot, res.points),
            lm_desc=scatter_drop(m.lm_desc, slot, f0.desc),
            lm_valid=scatter_drop(m.lm_valid, slot, True),
            lm_n_obs=scatter_drop(m.lm_n_obs, slot, 2),
            lm_first_kf=scatter_drop(m.lm_first_kf, slot, 0),
            n_lm=torch.tensor(n_new, dtype=torch.int32, device=dev),
        )
        lm_idx_kf0 = torch.where(point_ok, slot, -1).to(torch.int32)
        m = insert_keyframe_slots(
            m, T1.R, T1.t, f0.xy, f0.desc, f0.valid, lm_idx_kf0, self._init_frame_id
        )
        n_kp = feats.xy.shape[0]
        lm_idx_kf1 = scatter_drop(
            torch.full((n_kp,), -1, dtype=torch.int32, device=dev),
            torch.where(point_ok, idx, n_kp),
            lm_idx_kf0,
        )
        m = insert_keyframe_slots(
            m, T2.R, T2.t, feats.xy, feats.desc, feats.valid, lm_idx_kf1, self.frame_id
        )

        # two-view BA (cam0 fixed), then restore the |t| = 1 scale gauge
        from ..backend.ba import BAProblem, bundle_adjust

        prob = BAProblem(
            cam_R=m.kf_R[:2],
            cam_t=m.kf_t[:2],
            points=m.lm_pos,
            obs_lm=torch.where(m.kf_kp_valid[:2], m.kf_lm_idx[:2], -1),
            obs_uv=m.kf_uv[:2],
            obs_sigma2=torch.ones(m.kf_lm_idx[:2].shape, device=dev),
            cam_fixed=torch.tensor([True, False], device=dev),
            point_valid=m.lm_valid,
        )
        bres = bundle_adjust(prob, self.cam, iters=12)
        scale = 1.0 / torch.clamp(torch.linalg.norm(bres.cam_t[1]), min=1e-9)
        kf_R = m.kf_R.clone()
        kf_R[1] = bres.cam_R[1]
        kf_t = m.kf_t.clone()
        kf_t[:2] = bres.cam_t[:2] * scale
        m = m._replace(
            kf_R=kf_R,
            kf_t=kf_t,
            lm_pos=torch.where(m.lm_valid[:, None], bres.points * scale, m.lm_pos),
        )
        self.map = m
        self.pose = SE3(m.kf_R[1], m.kf_t[1])
        self.velocity = se3_identity(dev)
        self.last_kf_frame = self.frame_id
        self.inliers_at_last_kf = max(n_new, 1)
        self._kf_count = 2
        return True

    def _local_cap(self) -> Optional[int]:
        cap = self.cfg.track_local_cap
        return cap if cap and cap < self.cfg.map_cfg.max_landmarks else None

    def _keyframe_needed(self, n_inliers: int) -> bool:
        since = self.frame_id - self.last_kf_frame
        if since < self.cfg.kf_min_interval:
            return False
        if since >= self.cfg.kf_max_interval:
            return True
        return n_inliers < self.cfg.kf_inlier_ratio * self.inliers_at_last_kf

    def process(self, image, aux=None, nav_prior=None) -> tuple:
        """Feed one frame. Returns (status, pose Tcw as SE3 | None).
        aux: the right eye (stereo) or the depth map (RGB-D); unused here.
        nav_prior: an SE3 Tcw prediction from navigation data, used in place
        of the constant-velocity prediction (TRACKING) or the last pose
        (LOST)."""
        with timing.span("engine_process", self.frame_id):
            self._adopt_pending_map()
            feats = self._extract(image)
            self.last_feats = feats
            st = self.status
            if st == TrackerStatus.NOT_INITIALIZED and self._needs_two_frames:
                self._init_feats = feats
                self._init_frame_id = self.frame_id
                self.status = TrackerStatus.INITIALIZING
                self._record(None)
            elif st == TrackerStatus.NOT_INITIALIZED:
                ok = self._try_initialize(feats, aux)
                if ok:
                    self.status = TrackerStatus.TRACKING
                self._record(self.pose if ok else None)
            elif st == TrackerStatus.INITIALIZING:
                if self._try_initialize(feats, aux):
                    self.status = TrackerStatus.TRACKING
                    self._record(self.pose)
                else:
                    # re-anchor the reference frame now and then
                    if self.frame_id - self._init_frame_id > 20:
                        self._init_feats = feats
                        self._init_frame_id = self.frame_id
                    self._record(None)
            else:  # TRACKING or LOST
                lost = st == TrackerStatus.LOST
                if nav_prior is not None:
                    pred = SE3(*(torch.as_tensor(x, dtype=torch.float32, device=self.device)
                                 for x in nav_prior))
                elif lost:
                    pred = self.pose
                else:
                    pred = se3_compose(self.velocity, self.pose)
                radius = self.cfg.match_radius_lost if lost else self.cfg.match_radius
                tr = track_frame(
                    self.map, pred, self.cam, feats, radius,
                    self.cfg.match_max_hamming, local_cap=self._local_cap(),
                    image_hw=tuple(image.shape[-2:]),
                )
                self.map = tr.map
                n_inl = int(tr.n_inliers)
                self.last_n_inliers = n_inl
                self.last_sigma_pos = tr.sigma_pos.cpu().numpy()
                self.last_sigma_rot = float(tr.sigma_rot)
                if n_inl >= self.cfg.min_inliers:
                    prev_pose = self.pose
                    self.pose = tr.pose
                    v_meas = se3_compose(tr.pose, se3_inverse(prev_pose))
                    self.velocity = se3_exp(self.cfg.velocity_gain * se3_log(v_meas))
                    self.status = TrackerStatus.TRACKING
                    if self._keyframe_needed(n_inl) and self.mapping_enabled:
                        self._adopt_pending_map()
                        self._drain_compact_stats()
                        if self._kf_count >= self.cfg.map_cfg.max_keyframes - 1:
                            self._compact(force_min_one=True)
                            self._drain_compact_stats()
                        if self._kf_count < self.cfg.map_cfg.max_keyframes:
                            self._spawn_keyframe_pipeline(feats, tr, aux)
                            self.last_kf_frame = self.frame_id
                            self.inliers_at_last_kf = max(n_inl, 1)
                    self._record(self.pose)
                else:
                    self.status = TrackerStatus.LOST
                    self.velocity = se3_identity(self.device)
                    self._record(None)
            self.frame_id += 1
            return self.status, (
                self.pose if self.status == TrackerStatus.TRACKING else None
            )

    def _make_keyframe_map(self, m, pose, feats, kp_lm_idx, aux) -> MapStore:
        """The map with this frame written as a keyframe and new landmarks
        made (mono: two-view triangulation)."""
        return insert_keyframe(
            m, pose, self.cam, feats, kp_lm_idx, self.frame_id, self.cfg
        )

    def _spawn_keyframe_pipeline(self, feats, tr, aux):
        """Insert keyframe + new landmarks + local BA + cull/compact. With
        async_mapping the result is adopted at the next frame boundary."""
        m2 = self._make_keyframe_map(self.map, self.pose, feats, tr.kp_lm_idx, aux)
        if self.cfg.local_ba_window > 0:
            from ..backend.ba import local_ba

            m2, _ = local_ba(
                m2, self.cam, window=self.cfg.local_ba_window,
                iters=self.cfg.local_ba_iters,
                covisibility=self.cfg.local_ba_covisibility,
            )
        res = None
        if self.cfg.kf_culling:
            res = cull_and_compact(
                m2, keep_latest=self.cfg.kf_cull_keep_latest,
                redundancy=self.cfg.kf_cull_redundancy,
                min_other_obs=self.cfg.kf_cull_min_other_obs,
            )
            m2 = res.map
        self._kf_count += 1
        if self.cfg.async_mapping:
            self._pending_map = (m2, res)
        else:
            self.map = m2
            if res is not None:
                self._queue_compaction(res)
            if self.cfg.local_ba_window > 0:
                k = self.map.n_kf - 1
                self.pose = SE3(_row(self.map.kf_R, k), _row(self.map.kf_t, k))

    def _adopt_pending_map(self):
        if self._pending_map is None:
            return
        m2, res = self._pending_map
        self._pending_map = None
        self.map = m2
        if res is not None:
            self._queue_compaction(res)

    def _compact(self, force_min_one: bool = False):
        res = cull_and_compact(
            self.map, keep_latest=self.cfg.kf_cull_keep_latest,
            redundancy=self.cfg.kf_cull_redundancy,
            min_other_obs=self.cfg.kf_cull_min_other_obs,
            force_min_one=force_min_one,
        )
        self.map = res.map
        self._queue_compaction(res)

    def _queue_compaction(self, res):
        """Queue a CompactResult for a later read of its culled count, with
        the event that marks it ready (None on the CPU)."""
        ev = None
        if res.n_kf_culled.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        self._pending_compacts.append((res, ev))

    def _drain_compact_stats(self, only_ready: bool = False):
        """Read back n_culled of queued compactions, adjust the host keyframe
        count and record slot permutations for side tables. With only_ready,
        results whose event has not completed stay queued (no blocking)."""
        rest = []
        for res, ev in self._pending_compacts:
            if only_ready and ev is not None and not ev.query():
                rest.append((res, ev))
                continue
            n = int(res.n_kf_culled)
            if n > 0:
                self._kf_count -= n
                self._compactions.append(
                    (res.kf_order.cpu().numpy(), int(res.map.n_kf))
                )
        self._pending_compacts = rest

    @property
    def mapping_in_flight(self) -> bool:
        """True while an async keyframe pipeline result is not adopted yet or
        a queued compaction is not ready: loop-closure bookkeeping waits for
        a quiescent map so keyframe slot indices stay put."""
        if self._pending_map is not None:
            return True
        return any(ev is not None and not ev.query() for _, ev in self._pending_compacts)

    def drain_compactions(self) -> list:
        self._drain_compact_stats()
        ev, self._compactions = self._compactions, []
        return ev

    def relocalize_with_candidates(self, feats: OrbFeatures, candidate_kfs,
                                   min_inliers: int = 20) -> bool:
        """Geometric relocalization against candidate keyframes (BoW
        candidates -> PnP -> pose refinement -> inlier gate). On success the
        best verified pose is adopted; the next frame's wide-window LOST
        matching confirms it and flips the state back to TRACKING."""
        from .relocalize import relocalize_attempt

        best_inl, best_pose = 0, None
        for k in candidate_kfs:
            res = relocalize_attempt(
                self.map, self.cam, feats.desc, feats.xy, feats.valid, int(k),
                min_inliers=min_inliers,
            )
            n, ok = torch.stack([res.n_inliers, res.ok.to(torch.int32)]).tolist()
            if ok and n > best_inl:
                best_inl, best_pose = n, res.pose
        if best_pose is None:
            return False
        self.pose = best_pose
        self.velocity = se3_identity(self.device)
        return True

    def _record(self, pose):
        self.trajectory.append((
            self.frame_id,
            None if pose is None else SE3(pose.R.cpu().numpy(), pose.t.cpu().numpy()),
            self.status,
        ))

    @property
    def n_landmarks(self) -> int:
        self._adopt_pending_map()
        return int(self.map.n_lm)

    @property
    def n_keyframes(self) -> int:
        self._adopt_pending_map()
        return int(self.map.n_kf)
