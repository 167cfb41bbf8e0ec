"""Chunked tracking loop for the mono, stereo and RGB-D trackers (port of
lpslam_tpu/frontend/device_loop.py).

Per chunk of B raw frames: one upload, one batched remap (undistortion or
rectification) and one batched ``extract_orb`` of the (left) images over the
whole chunk — feature extraction does not depend on tracking state. Then a
per-frame loop replaces the JAX ``lax.scan``: ``track_frame``, the keyframe
policy, the keyframe insert and the rate-capped windowed ``local_ba``. The
depth modes insert keyframes with ``insert_keyframe_depth`` plus a two-view
pass for far points; stereo extracts the right eye only on keyframes. The
keyframe and BA decisions are taken on the host from ONE device read per
frame (``.tolist()`` of the packed inlier and keyframe counters); the JAX
scan takes them on the device under ``lax.cond``. The chunk boundary runs
the keyframe cull/compaction. Capturing the non-keyframe step in a CUDA
graph is later work.

``invalidate_carry`` and ``discard_carry`` hand control back from the host
(relocalization, loop-closure pose resync, host-path frames) to the loop.
The carry's pose and velocity stay on the device; its counters (status,
frame ids, inliers at the last keyframe) are host ints.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..geometry.se3 import (
    SE3, se3_compose, se3_exp, se3_identity, se3_inverse, se3_log,
)
from ..kernels.orb import OrbFeatures, extract_orb
from ..kernels.remap import remap_bilinear
from ..mapstore.store import MapStore, cull_and_compact
from ..utils import timing
from .stereo import (
    RGBDTracker,
    StereoTracker,
    bilinear_depths,
    insert_keyframe_depth,
    stereo_depths,
)
from .tracker import (
    MonoTracker,
    TrackerConfig,
    TrackerStatus,
    _apply_mask,
    insert_keyframe,
    track_frame,
    triangulate_new_landmarks,
)


class ChunkCarry(NamedTuple):
    m: MapStore
    pose_R: torch.Tensor       # (3,3) Tcw
    pose_t: torch.Tensor       # (3,)
    vel_R: torch.Tensor
    vel_t: torch.Tensor
    status: int                # TRACKING / LOST
    frame_id: int
    last_kf_frame: int
    last_ba_frame: int         # in-loop BA rate-cap cursor
    inliers_at_last_kf: int


class FrameOut(NamedTuple):
    status: torch.Tensor       # (B,) int32
    n_inliers: torch.Tensor    # (B,) int32
    pose_R: torch.Tensor       # (B, 3, 3)
    pose_t: torch.Tensor       # (B, 3)
    kf_inserted: torch.Tensor  # (B,) bool
    sigma_pos: torch.Tensor    # (B, 3)
    sigma_rot: torch.Tensor    # (B,)


_EMPTY_OUT = (
    np.zeros(0, np.int32),
    np.zeros(0, np.int32),
    np.zeros((0, 3, 3), np.float32),
    np.zeros((0, 3), np.float32),
    np.zeros(0, bool),
    np.zeros((0, 3), np.float32),
    np.zeros(0, np.float32),
)


def make_chunk_step(cam: PinholeCamera, cfg: TrackerConfig, device, mask=None,
                    mapping_enabled: bool = True, rectify_map=None, mode: str = "mono",
                    focal_x_baseline: float = 0.0, y_margin: float = 2.0,
                    max_depth: float = 12.0, min_depth: float = 0.1,
                    ba_in_scan: bool = True):
    """Build the (carry, frames) -> (carry, FrameOut) step on `device`.

    frames per mode:
      mono   — (B, H, W);
      stereo — (B, 2, H, W) eye pairs; keyframes seed landmarks from
               row-matched, sub-pixel refined disparity;
      rgbd   — a ((B, H, W) gray, (B, H, W) depth) tuple; keyframes seed
               landmarks from bilinear depth.
    mask: optional (H, W) bool keypoint mask, applied after extraction;
    mapping_enabled=False inserts no keyframe (localization only).
    rectify_map: optional remap grid applied to the whole chunk before
    extraction — (H, W, 2), or (2, H, W, 2) for stereo, one per eye; rgbd
    remaps its depth maps with the same grid as the gray images.
    ba_in_scan=False runs no local BA inside the loop; the BA cursor then
    advances on every keyframe, as in the JAX scan."""
    device = torch.device(device)
    K = cfg.map_cfg.max_keyframes
    M = cfg.map_cfg.max_landmarks
    cap = cfg.track_local_cap
    local_cap = cap if cap and cap < M else None
    ratio = np.float32(cfg.kf_inlier_ratio)
    rmap = None if rectify_map is None else torch.as_tensor(
        np.asarray(rectify_map, np.float32), device=device
    )
    ba_interval = (
        cfg.scan_ba_min_interval if mode == "mono" else cfg.scan_ba_min_interval_depth
    )
    # the JAX scan's gate: BA runs, and the rate cap applies, only when the
    # loop maps and runs BA; otherwise every keyframe counts as BA'd
    ba_on = mapping_enabled and ba_in_scan and cfg.local_ba_window > 0

    def _depth_for_keyframe(left, aux, feats):
        """Depth per left keypoint: (z, ok). aux is the right eye (stereo,
        extracted here, only on keyframes) or the depth map (rgbd)."""
        if mode == "stereo":
            rfeats = extract_orb(aux, cfg.orb)
            return stereo_depths(
                left, aux, feats, rfeats, focal_x_baseline, y_margin, max_depth
            )
        return bilinear_depths(aux, feats, min_depth, max_depth)

    def step(carry: ChunkCarry, feats: OrbFeatures, left, aux):
        pose = SE3(carry.pose_R, carry.pose_t)
        vel = SE3(carry.vel_R, carry.vel_t)
        lost = carry.status == TrackerStatus.LOST
        pred = pose if lost else se3_compose(vel, pose)
        radius = cfg.match_radius_lost if lost else cfg.match_radius
        tr = track_frame(
            carry.m, pred, cam, feats, radius, cfg.match_max_hamming,
            local_cap=local_cap, image_hw=tuple(left.shape[-2:]),
        )
        # the frame's one device read: inliers and the keyframe counter
        n_inl, n_kf = torch.stack([tr.n_inliers, tr.map.n_kf]).tolist()
        ok = n_inl >= cfg.min_inliers
        new_pose = tr.pose if ok else pose
        if ok:
            v_meas = se3_compose(tr.pose, se3_inverse(pose))
            new_vel = se3_exp(cfg.velocity_gain * se3_log(v_meas))
        else:
            new_vel = se3_identity(device)

        since = carry.frame_id - carry.last_kf_frame
        want = since >= cfg.kf_min_interval and (
            since >= cfg.kf_max_interval
            or n_inl < ratio * np.float32(carry.inliers_at_last_kf)
        )
        # No landmark-headroom gate, as on the host path: a keyframe at the
        # landmark store's wall makes only the landmarks that fit, and keeps the
        # boundary's cull and compaction running, which free slots. The JAX
        # scan's gate (n_lm < M - N) stops keyframes at the wall for good, since
        # only a chunk that inserted a keyframe compacts: the map then freezes.
        kf = ok and want and mapping_enabled and n_kf < K
        m2 = tr.map
        if kf and mode == "mono":
            m2 = insert_keyframe(
                m2, new_pose, cam, feats, tr.kp_lm_idx, carry.frame_id, cfg
            )
        elif kf:
            z, dok = _depth_for_keyframe(left, aux, feats)
            m2 = insert_keyframe_depth(
                m2, new_pose, cam, feats, tr.kp_lm_idx, z, dok, carry.frame_id
            )
            # far points beyond the depth gate: two-view triangulation
            m2 = triangulate_new_landmarks(m2, cam, cfg)
        ba_due = kf and (
            not ba_on or ba_interval <= 0
            or carry.frame_id - carry.last_ba_frame >= ba_interval
        )
        if ba_due and ba_on:
            from ..backend.ba import local_ba

            m2 = local_ba(
                m2, cam, window=cfg.local_ba_window, iters=cfg.local_ba_iters,
                covisibility=cfg.local_ba_covisibility,
            )[0]
        status = int(TrackerStatus.TRACKING if ok else TrackerStatus.LOST)
        out = (status, tr.n_inliers, new_pose.R, new_pose.t, kf,
               tr.sigma_pos, tr.sigma_rot)
        new_carry = ChunkCarry(
            m=m2,
            pose_R=new_pose.R,
            pose_t=new_pose.t,
            vel_R=new_vel.R,
            vel_t=new_vel.t,
            status=status,
            frame_id=carry.frame_id + 1,
            last_kf_frame=carry.frame_id if kf else carry.last_kf_frame,
            last_ba_frame=carry.frame_id if ba_due else carry.last_ba_frame,
            inliers_at_last_kf=max(n_inl, 1) if kf else carry.inliers_at_last_kf,
        )
        return new_carry, out

    def _prep(x, grid):
        x = x.to(device=device, dtype=torch.float32)
        return x if grid is None else remap_bilinear(x, grid)

    def scan_chunk(carry: ChunkCarry, frames):
        with timing.span("chunk_extract"):
            frames = _upload(frames, device)
            if mode == "mono":
                left, aux = _prep(frames, rmap), None
            elif mode == "stereo":
                left = _prep(frames[:, 0], None if rmap is None else rmap[0])
                aux = _prep(frames[:, 1], None if rmap is None else rmap[1])
            else:
                left, aux = _prep(frames[0], rmap), _prep(frames[1], rmap)
            feats_all = extract_orb(left, cfg.orb)
            if mask is not None:
                feats_all = _apply_mask(feats_all, mask)
        outs = []
        for i in range(left.shape[0]):
            fid = carry.frame_id
            with timing.span("chunk_frame", fid):
                carry, out = step(
                    carry, OrbFeatures(*(f[i] for f in feats_all)), left[i],
                    None if aux is None else aux[i],
                )
            timing.stamp(fid, "pose")
            outs.append(out)
        sts, n_inl, pR, pt, kfs, sp, sr = zip(*outs)
        return carry, FrameOut(
            status=torch.tensor(sts, dtype=torch.int32, device=device),
            n_inliers=torch.stack(n_inl).to(torch.int32),
            pose_R=torch.stack(pR),
            pose_t=torch.stack(pt),
            kf_inserted=torch.tensor(kfs, dtype=torch.bool, device=device),
            sigma_pos=torch.stack(sp),
            sigma_rot=torch.stack(sr),
        )

    return scan_chunk


def _upload(frames, device):
    """Host arrays (or a tuple of them) as tensors on `device`; tensors
    already there pass through."""
    if isinstance(frames, tuple):
        return tuple(_upload(f, device) for f in frames)
    return torch.as_tensor(frames).to(device, non_blocking=True)


def _out_to_numpy(cat: FrameOut):
    return tuple(x.cpu().numpy() for x in cat)


class ChunkedTracker:
    """Drives an initialized MonoTracker, StereoTracker or RGBDTracker
    through the chunk loop on the engine's device; ``mode`` says which.

        eng = MonoTracker(cam, cfg, device="cuda")  # host path initializes
        ct = ChunkedTracker(eng, rectify_map=grid)
        for batch in batches:                       # (B, H, W) uint8 / float
            ct.process_chunk(batch)
        ct.sync()
        statuses, n_inl, poses_R, poses_t, kf, sig_p, sig_r = ct.collect()
    """

    def __init__(self, engine: MonoTracker, local_ba_every_chunk: bool = True,
                 rectify_map=None, boundary_compact: bool = True):
        self.engine = engine
        self.device = engine.device
        # local_ba_every_chunk=False: no local BA inside the loop
        self.local_ba_every_chunk = local_ba_every_chunk
        # the boundary's keyframe cull + compaction, read at every chunk;
        # compact_enabled=False holds the store's slots still (e.g. while a
        # loop-closure snapshot must keep them); the redundancy cull runs
        # every compact_period-th boundary, the capacity cull whenever the
        # store nears its keyframe capacity
        self.boundary_compact = boundary_compact and engine.cfg.kf_culling
        self.compact_enabled = True
        self.compact_period = 8
        self._boundary_count = 0
        if isinstance(engine, RGBDTracker):
            mode, extra = "rgbd", dict(
                max_depth=engine.max_depth, min_depth=engine.min_depth
            )
        elif isinstance(engine, StereoTracker):
            mode, extra = "stereo", dict(
                focal_x_baseline=engine.focal_x_baseline,
                y_margin=engine.y_margin, max_depth=engine.max_depth,
            )
        else:
            mode, extra = "mono", {}
        self.mode = mode
        self._rectify_map, self._mode_kw = rectify_map, extra
        self.rebuild_step()
        self._outs: list = []
        self._pending_carry = None

    def rebuild_step(self) -> None:
        """Build the step with the engine's current mask and mapping switch,
        which the step reads when it is built: call it after changing either.
        Chunks already dispatched keep the switch they ran with."""
        e = self.engine
        self._scan = make_chunk_step(
            e.cam, e.cfg, self.device, mask=e.mask, mapping_enabled=e.mapping_enabled,
            rectify_map=self._rectify_map, mode=self.mode,
            ba_in_scan=self.local_ba_every_chunk, **self._mode_kw,
        )

    @property
    def ready(self) -> bool:
        return self.engine.status in (TrackerStatus.TRACKING, TrackerStatus.LOST)

    def _carry(self) -> ChunkCarry:
        e = self.engine
        if self._pending_carry is not None:
            return self._pending_carry._replace(m=e.map)
        return ChunkCarry(
            m=e.map,
            pose_R=e.pose.R, pose_t=e.pose.t,
            vel_R=e.velocity.R, vel_t=e.velocity.t,
            status=int(e.status),
            frame_id=e.frame_id,
            last_kf_frame=e.last_kf_frame,
            # the host path runs BA on every keyframe
            last_ba_frame=e.last_kf_frame,
            inliers_at_last_kf=e.inliers_at_last_kf,
        )

    def prefetch(self, frames):
        """Stage a chunk on the device; returns a handle for process_chunk.
        rgbd passes a (gray, depth) tuple."""
        return _upload(frames, self.device)

    def process_chunk(self, frames) -> None:
        """Advance tracking over one chunk (host arrays or a prefetch()
        handle): (B, H, W) mono, (B, 2, H, W) stereo eye pairs, or a
        ((B, H, W) gray, (B, H, W) depth) tuple for rgbd."""
        assert self.ready, "initialize via the host path first"
        with timing.span("process_chunk"):
            e = self.engine
            start_frame = e.frame_id
            n_frames = int((frames[0] if isinstance(frames, tuple) else frames).shape[0])
            # the step uploads the frames (a prefetch() handle is on the device already)
            carry, out = self._scan(self._carry(), frames)

            with timing.span("chunk_boundary"):
                e.map = carry.m
                e.pose = SE3(carry.pose_R, carry.pose_t)
                e.velocity = SE3(carry.vel_R, carry.vel_t)
                e.frame_id = start_frame + n_frames
                self._outs.append(out)

                # chunk boundary: multi-pass keyframe cull + compaction when the
                # chunk inserted a keyframe and the store nears capacity or the
                # periodic quality cull is due (local BA, when on, ran inside the loop)
                if self.boundary_compact:
                    max_cull = n_frames // max(e.cfg.kf_min_interval, 1) + 1
                    self._boundary_count += 1
                    periodic = (self._boundary_count % self.compact_period) == 0
                    if bool(out.kf_inserted.any()):
                        kf_cap = e.map.kf_valid.shape[0]
                        near_cap = int(e.map.n_kf) >= kf_cap - (2 * max_cull + 2)
                        if self.compact_enabled and (near_cap or periodic):
                            res = cull_and_compact(
                                e.map, keep_latest=e.cfg.kf_cull_keep_latest,
                                redundancy=e.cfg.kf_cull_redundancy,
                                min_other_obs=e.cfg.kf_cull_min_other_obs,
                                max_cull=max_cull, force_free=max_cull,
                            )
                            e.map = res.map
                            e._queue_compaction(res)
                self._pending_carry = carry

    def invalidate_carry(self) -> None:
        """Call after changing the engine's host state (pose, status,
        keyframe counters) outside the chunk loop, e.g. a relocalization or
        a loop-closure pose resync: folds the pending carry's counters into
        the engine, then makes the next chunk rebuild its carry from the
        engine."""
        self.sync()
        self._pending_carry = None

    def discard_carry(self) -> None:
        """Drop the pending carry without folding it into the engine: the
        host path ran frames after the last chunk, so the engine's state is
        the newer one."""
        self._pending_carry = None

    def sync(self) -> None:
        """Fold the end-of-chunk counters into the engine's host state."""
        c = self._pending_carry
        if c is None:
            return
        with timing.span("chunk_boundary"):
            e = self.engine
            e.status = TrackerStatus(c.status)
            e.last_kf_frame = c.last_kf_frame
            e.inliers_at_last_kf = c.inliers_at_last_kf
            e._kf_count = int(c.m.n_kf)

    def drain(self, keep_last: int = 0):
        """Fetch and clear per-frame outputs, keeping the newest `keep_last`
        chunks. Returns (statuses, n_inliers, poses_R, poses_t, kf_inserted,
        sigma_pos, sigma_rot) as numpy."""
        take = len(self._outs) - keep_last
        if take <= 0:
            return _EMPTY_OUT
        outs, self._outs = self._outs[:take], self._outs[take:]
        with timing.span("chunk_boundary"):
            return _out_to_numpy(FrameOut(*(torch.cat(x) for x in zip(*outs))))

    def collect(self):
        """All per-frame outputs so far, as numpy (see drain)."""
        if not self._outs:
            return _EMPTY_OUT
        return _out_to_numpy(FrameOut(*(torch.cat(x) for x in zip(*self._outs))))
