"""Stereo and RGB-D trackers: depth-seeded landmarks, metric scale (port of
lpslam_tpu/frontend/stereo.py).

Every keypoint may carry a depth. A keyframe turns its unassociated
keypoints with a valid depth into landmarks at once, so there is no two-view
bootstrap and the scale is metric. Stereo depth comes from mutual-best
row matching of the two eyes' ORB features plus a sub-pixel SAD fit; RGB-D
depth from the depth map, sampled bilinearly at each keypoint.
"""
from __future__ import annotations

import torch

from ..geometry.camera import PinholeCamera, unproject_pinhole
from ..geometry.se3 import SE3, se3_identity, se3_inverse
from ..kernels.orb import OrbFeatures, OrbParams, extract_orb
from ..kernels.stereo import (
    depth_from_disparity, match_stereo, refine_disparity_subpixel,
)
from ..mapstore.store import (
    MapStore, empty_map, insert_keyframe_slots, scatter_drop, set_row,
)
from ..utils import timing
from .tracker import (
    MonoTracker, TrackerConfig, _apply_mask, _row, triangulate_new_landmarks,
)


def _extract_two_eyes(imgs, params: OrbParams) -> OrbFeatures:
    """(2, H, W) left/right images -> OrbFeatures with a leading eye axis:
    both eyes share one kernel launch per pyramid level."""
    return extract_orb(imgs, params)


def stereo_depths(left, right, feats: OrbFeatures, rfeats: OrbFeatures,
                  focal_x_baseline: float, y_margin: float, max_depth: float):
    """Depth of each left keypoint from the right eye's features: (z, ok)."""
    disp, idx_r, ok = match_stereo(
        feats.desc, feats.xy, feats.valid,
        rfeats.desc, rfeats.xy, rfeats.valid, y_margin=y_margin,
    )
    # integer-keypoint disparity carries +-1 px error: refine it sub-pixel
    disp = refine_disparity_subpixel(left, right, feats.xy, rfeats.xy[idx_r], ok)
    z = depth_from_disparity(disp, focal_x_baseline)
    return z, ok & (disp > 0.5) & (z > 0.0) & (z < max_depth)


def bilinear_depths(depth_map, feats: OrbFeatures, min_depth: float,
                    max_depth: float):
    """Sub-pixel bilinear depth at each keypoint: (z, ok). A sample whose
    four neighbours spread by 5% or more of its depth straddles a depth
    edge and is rejected."""
    d = depth_map
    h, w = d.shape
    x = torch.clamp(feats.xy[:, 0], 0.0, w - 1.001)
    y = torch.clamp(feats.xy[:, 1], 0.0, h - 1.001)
    x0 = x.to(torch.int64)
    y0 = y.to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = d.reshape(-1)
    i00 = y0 * w + x0
    v00, v01 = flat[i00], flat[i00 + 1]
    v10, v11 = flat[i00 + w], flat[i00 + w + 1]
    z = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
         + v10 * (1 - fx) * fy + v11 * fx * fy)
    vmin = torch.minimum(torch.minimum(v00, v01), torch.minimum(v10, v11))
    vmax = torch.maximum(torch.maximum(v00, v01), torch.maximum(v10, v11))
    ok = (
        feats.valid
        & ((vmax - vmin) < 0.05 * torch.clamp(z, min=1e-6))
        & (vmin > min_depth)
        & (z < max_depth)
    )
    return z, ok


def insert_keyframe_depth(m: MapStore, pose: SE3, cam: PinholeCamera,
                          feats: OrbFeatures, kp_lm_idx, depth, depth_ok,
                          frame_id) -> MapStore:
    """Write a keyframe whose unassociated keypoints with a valid depth
    become landmarks at once.

    First the poorly matched landmarks are culled (the mono insert's rule).
    A candidate within 2% of its depth of an existing valid landmark is a
    duplicate of it and is not made. New landmarks take slots n_lm + rank;
    past capacity they are dropped."""
    with timing.span("insert_keyframe"):
        poor = (m.lm_n_visible >= 8) & (
            m.lm_n_found.to(torch.float32) < 0.25 * m.lm_n_visible.to(torch.float32)
        )
        m = m._replace(lm_valid=m.lm_valid & ~poor)
        m = insert_keyframe_slots(
            m, pose.R, pose.t, feats.xy, feats.desc, feats.valid, kp_lm_idx, frame_id
        )
        k_new = m.n_kf - 1

        good = feats.valid & depth_ok & (kp_lm_idx < 0)
        rays = unproject_pinhole(cam, feats.xy, depth=depth)
        T_wc = se3_inverse(pose)
        pts = rays @ T_wc.R.T + T_wc.t

        # duplicate test against the map: |a|^2 + |b|^2 - 2ab in one matmul
        lm = m.lm_pos
        d2 = (
            torch.sum(pts * pts, -1)[:, None]
            + torch.sum(lm * lm, -1)[None, :]
            - 2.0 * pts @ lm.T
        )
        dup_r = 0.02 * torch.clamp(depth, min=0.5)
        dup = torch.any((d2 < (dup_r ** 2)[:, None]) & m.lm_valid[None, :], dim=1)
        good = good & ~dup

        M = m.lm_pos.shape[0]
        rank = torch.cumsum(good.to(torch.int64), 0) - 1
        slot = torch.where(good, m.n_lm + rank, M)
        slot = torch.where(slot < M, slot, M)
        made = (slot < M) & good
        n_new = torch.sum(made).to(torch.int32)
        K = m.kf_lm_idx.shape[0]
        kf_lm_new = torch.where(
            made, slot.to(torch.int32), _row(m.kf_lm_idx, torch.clamp(k_new, max=K - 1))
        )
        return m._replace(
            lm_pos=scatter_drop(m.lm_pos, slot, pts),
            lm_desc=scatter_drop(m.lm_desc, slot, feats.desc),
            lm_valid=scatter_drop(m.lm_valid, slot, True),
            lm_n_obs=scatter_drop(m.lm_n_obs, slot, 1),
            lm_first_kf=scatter_drop(m.lm_first_kf, slot, k_new.to(torch.int32)),
            kf_lm_idx=set_row(m.kf_lm_idx, k_new, kf_lm_new),
            n_lm=torch.clamp(m.n_lm + n_new, max=M),
        )


class StereoTracker(MonoTracker):
    """Rectified-stereo tracker: ``process(left, aux=right)``.

    Landmarks deeper than ``depth_threshold * baseline`` get no stereo depth
    and fall back to two-view triangulation against the previous keyframe.
    """

    _needs_two_frames = False
    _feats_lr = None  # the current frame's (2, ...) left/right features

    def __init__(self, cam: PinholeCamera, focal_x_baseline: float,
                 cfg: TrackerConfig = TrackerConfig(), y_margin: float = 2.0,
                 depth_threshold: float = 40.0, *, device):
        super().__init__(cam, cfg, device=device)
        self.focal_x_baseline = float(focal_x_baseline)
        self.y_margin = float(y_margin)
        baseline = self.focal_x_baseline / float(self.cam.fx)
        self.max_depth = depth_threshold * baseline

    def _image(self, image):
        return torch.as_tensor(image, dtype=torch.float32, device=self.device)

    def _depths(self, feats: OrbFeatures, right_image):
        right = self._image(right_image)
        if self._feats_lr is not None:
            rfeats = OrbFeatures(*(f[1] for f in self._feats_lr))
        else:
            rfeats = extract_orb(right, self.cfg.orb)
        return stereo_depths(
            self._last_left, right, feats, rfeats,
            self.focal_x_baseline, self.y_margin, self.max_depth,
        )

    def process(self, image, aux=None, nav_prior=None):
        with timing.span("engine_process", self.frame_id):
            self._last_left = self._image(image)
            self._feats_lr = None
            if aux is not None:
                both = torch.stack([self._last_left, self._image(aux)])
                self._feats_lr = _extract_two_eyes(both, self.cfg.orb)
            return super().process(image, aux=aux, nav_prior=nav_prior)

    def _extract(self, image) -> OrbFeatures:
        if self._feats_lr is not None:
            # the mask applies to the left eye, as in the mono extraction
            feats = OrbFeatures(*(f[0] for f in self._feats_lr))
            return feats if self.mask is None else _apply_mask(feats, self.mask)
        return super()._extract(image)

    def _try_initialize(self, feats: OrbFeatures, aux=None) -> bool:
        z, ok = self._depths(feats, aux)
        n_ok = int(torch.sum(ok))
        if n_ok < self.cfg.init_min_matches:
            return False
        dev = self.device
        pose = se3_identity(dev)
        n_kp = feats.xy.shape[0]
        self.map = insert_keyframe_depth(
            empty_map(self.cfg.map_cfg, dev), pose, self.cam, feats,
            torch.full((n_kp,), -1, dtype=torch.int32, device=dev), z, ok,
            self.frame_id,
        )
        self.pose = pose
        self.velocity = se3_identity(dev)
        self.last_kf_frame = self.frame_id
        self.inliers_at_last_kf = max(n_ok, 1)
        self._kf_count = 1
        return True

    def _make_keyframe_map(self, m, pose, feats, kp_lm_idx, aux) -> MapStore:
        z, ok = self._depths(feats, aux)
        m2 = insert_keyframe_depth(
            m, pose, self.cam, feats, kp_lm_idx, z, ok, self.frame_id
        )
        # far points without a depth: two-view triangulation against the
        # previous keyframe (there always is one after initialization)
        return triangulate_new_landmarks(m2, self.cam, self.cfg)


class RGBDTracker(StereoTracker):
    """RGB-D tracker: ``process(gray, aux=depth_map)`` with metric depth."""

    def __init__(self, cam: PinholeCamera, cfg: TrackerConfig = TrackerConfig(),
                 min_depth: float = 0.1, max_depth: float = 12.0, *, device):
        MonoTracker.__init__(self, cam, cfg, device=device)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)

    def process(self, image, aux=None, nav_prior=None):
        # aux is a depth map, not a second eye: extraction as in mono
        self._feats_lr = None
        return MonoTracker.process(self, image, aux=aux, nav_prior=nav_prior)

    def _depths(self, feats: OrbFeatures, depth_map):
        return bilinear_depths(
            self._image(depth_map), feats, self.min_depth, self.max_depth
        )
