"""The visual-SLAM tracker stage (port of lpslam_tpu/pipeline/trackers.py):
the engine (Mono/Stereo/RGBD trackers) behind the TrackerBase contract,
with loop closing, BoW relocalization, the chunked frame loop, navigation
priors, keypoint masks, map files, localization-only mode, laser scans with
the occupancy grid, map emission and the landmark exports.

Steady TRACKING frames without a navigation prior ride the chunk loop
(frontend/device_loop.py); initialization, LOST frames and frames with a
prior take the per-frame host path. A prior comes from a map-frame state
(an absolute pose) or from the odometry delta since the last frame composed
onto the tracked pose, in float32, with the odometry's own translation
scale, as in the JAX package. At each chunk
boundary the loop core adds new keyframes to the BoW database and tries to
close a loop; a LOST host frame is relocalized against BoW candidates.
Loop closing runs inline (``loop_async=False``) or on one background worker
that owns the loop closer; a verdict comes back to the frame path and is
applied there, with its keyframe slots remapped through the compactions
that landed meanwhile.

The vocabulary is the JAX package's shipped asset, read as data
(``lpslam_tpu/assets/orb_vocab.npz``) unless ``vocab_file`` names another.
Where that file does not exist, a flat vocabulary is trained on the map's
first 4096 valid keyframe descriptors once there are 4 keyframes (on the
frame path, as the JAX package does).

The descriptor path is the ``brief_mode`` option (kernels/orb.py: "polar",
"binned", "gather" or "exact"; an unknown one raises ValueError at the first
extraction, as in the JAX package). The shipped vocabulary was trained on
polar descriptors, so with another mode BoW scoring is as poor as in the
JAX package. Mask images are read by
io/png.py and resized nearest-neighbour as OpenCV's INTER_NEAREST does.
"""
from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..frontend.stereo import RGBDTracker, StereoTracker
from ..frontend.tracker import MonoTracker, TrackerConfig, TrackerStatus, _row
from ..geometry.camera import PinholeCamera
from ..geometry.frames import optical_to_lpslam
from ..geometry.se3 import SE3, se3_compose, se3_inverse
from ..geometry.so3 import rot_to_quat
from ..kernels.orb import OrbParams
from ..mapstore.store import MapConfig
from ..utils import timing
from .config import ConfigOptions
from .queues import CameraQueueEntry, SensorQueueEntry

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHIPPED_VOCAB = os.path.join(_REPO, "lpslam_tpu", "assets", "orb_vocab.npz")

@dataclass
class TrackerResult:
    timestamp: float
    position: np.ndarray        # lpslam frame
    orientation_wxyz: np.ndarray
    valid: bool
    # position sigmas in the lpslam frame, scalar orientation sigma [rad]
    position_sigma: np.ndarray = None
    orientation_sigma: float = 0.0

    def __post_init__(self):
        if self.position_sigma is None:
            self.position_sigma = np.zeros(3)


@dataclass
class LaserScan:
    timestamp: float
    ranges: np.ndarray          # (N,)
    angle_min: float
    angle_increment: float
    range_max: float
    # laser -> camera extrinsics; None = identity
    extrinsic_R: np.ndarray = None
    extrinsic_t: np.ndarray = None


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize to (h, w) as OpenCV's INTER_NEAREST: source
    index floor(dst * (1 / (dst_size / src_size))), clamped."""
    sh, sw = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / sh))).astype(np.int64), sh - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / sw))).astype(np.int64), sw - 1)
    return img[ys[:, None], xs[None, :]]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sigma_to_lpslam(sigma_xyz) -> np.ndarray:
    """World-frame position sigmas permuted into the lpslam frame: the
    position map is (x,y,z) -> (-y,x,z), so std-devs permute to (sy,sx,sz)."""
    s = np.asarray(sigma_xyz, np.float64)
    return np.array([s[1], s[0], s[2]])


def create_tracker_result_pose(R: np.ndarray, t: np.ndarray):
    """Tcw (optical frame, numpy) -> (position, orientation_wxyz) in the
    lpslam frame: the optical->lpslam swap of the camera centre -Rᵀt, and
    the quaternion of R with components (w, -y, x, z)."""
    center_lp = optical_to_lpslam(-R.T @ t)
    q_cw = rot_to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()
    return center_lp, np.array([q_cw[0], -q_cw[2], q_cw[1], q_cw[3]])


class TrackerBase:
    schema = ConfigOptions()

    def __init__(self, config: Optional[dict] = None):
        self.cfg = self.schema.parse(config)

    def start(self, sensor_queue=None):
        pass

    def stop(self):
        pass

    def process_image(self, entry: CameraQueueEntry, nav_odom=None, nav_map=None,
                      sensor_values=()) -> list:
        """A list of TrackerResults for this frame, or None when the result
        is deferred (chunked trackers emit buffered frames' results at chunk
        boundaries)."""
        raise NotImplementedError

    def flush(self) -> list:
        """Emit any deferred results (end of stream / pipeline stop)."""
        return []

    def add_laser_scan(self, scan):
        pass

    def get_occupancy_map(self):
        return None

    def status(self) -> dict:
        return {}


class VSLAMTracker(TrackerBase):
    """The visual-SLAM tracker stage (mono / stereo / rgbd) on `device`."""

    schema = (
        ConfigOptions()
        .optional("mode", str, "mono")
        .optional("keypoints", int, 512)
        .optional("levels", int, 3)
        .optional("scale_factor", float, 1.2)
        .optional("fast_threshold", float, 20.0)
        .optional("fast_min_threshold", float, 7.0)
        .optional("brief_mode", str, "polar")
        .optional("max_keyframes", int, 128)
        .optional("max_landmarks", int, 16384)
        .optional("focal_x_baseline", float, 0.0)
        .optional("depth_threshold", float, 40.0)
        .optional("y_matching_margin", float, 2.0)
        .optional("max_depth", float, 12.0)       # rgbd
        .optional("wait_for_navigation_data", bool, False)
        .optional("relocalize_with_nav_data", bool, False)
        .optional("time_to_relocalize", float, 3.0)
        .optional("loop_closure", bool, False)
        # > 0: full-map BA after an accepted loop's pose-graph correction
        .optional("loop_global_ba_iters", int, 0)
        # detect + verify on a background worker; False = inline on the
        # keyframe's own frame
        .optional("loop_async", bool, True)
        .optional("mapping", bool, True)
        .optional("map_file", str, "")
        .optional("vocab_file", str, "")
        .optional("occupancy_cell_size", float, 0.1)
        .optional("max_laser_age", float, 0.5)
        .optional("mask_radius", float, 0.0)
        .optional("mask_image", str, "")
        .optional("emit_map_seconds", float, 0.0)
        # when PnP verification fails, jump the pose prior to the best BoW
        # keyframe anyway (off: an unverified jump can latch onto the wrong
        # place in self-similar scenes)
        .optional("unverified_bow_teleport", bool, False)
        # >= 2: steady TRACKING frames go through the chunk loop in chunks of
        # this size; results of buffered frames come at chunk boundaries
        .optional("chunk_size", int, 0)
        # LM iterations of windowed local BA; 0 = TrackerConfig's default
        .optional("local_ba_iters", int, 0)
    )

    def __init__(self, cam: PinholeCamera, config: Optional[dict] = None, *, device):
        super().__init__(config)
        orb = OrbParams(
            num_keypoints=self.cfg["keypoints"],
            num_levels=self.cfg["levels"],
            scale_factor=self.cfg["scale_factor"],
            fast_threshold=self.cfg["fast_threshold"],
            fast_min_threshold=self.cfg["fast_min_threshold"],
            brief_mode=self.cfg["brief_mode"],
        )
        tcfg = TrackerConfig(orb=orb, map_cfg=MapConfig(
            max_keyframes=self.cfg["max_keyframes"],
            max_landmarks=self.cfg["max_landmarks"],
            num_keypoints=self.cfg["keypoints"],
        ))
        if self.cfg["local_ba_iters"] > 0:
            tcfg = tcfg._replace(local_ba_iters=self.cfg["local_ba_iters"])
        mode = self.cfg["mode"]
        if mode == "stereo":
            self.engine = StereoTracker(
                cam, self.cfg["focal_x_baseline"], tcfg,
                y_margin=self.cfg["y_matching_margin"],
                depth_threshold=self.cfg["depth_threshold"], device=device,
            )
        elif mode == "rgbd":
            self.engine = RGBDTracker(cam, tcfg, max_depth=self.cfg["max_depth"],
                                      device=device)
        elif mode == "mono":
            self.engine = MonoTracker(cam, tcfg, device=device)
        else:
            raise ValueError(f"unknown tracker mode '{mode}'")

        self.engine.mapping_enabled = self.cfg["mapping"]
        self._chunk_size = int(self.cfg["chunk_size"] or 0)
        self._chunked = None              # lazily built ChunkedTracker
        self._chunk_buf: list = []        # entries awaiting dispatch
        self._chunk_inflight: list = []   # (frame_id, entry) dispatched, undrained
        self._host_dirty = False          # host path ran since the last chunk
        self._device_rectify = None       # remap grid for the chunk loop
        self.loop_closer = None
        self._loop_pending_kfs = 0
        # asynchronous loop closing: one worker serializes every loop-closer
        # operation (add_keyframe / remap / verify), so the BoW database
        # never races; the frame path only polls the verdict futures
        self._loop_exec = None
        self._loop_verdicts = None        # deque[(future, perm_epoch)]
        self._loop_perm_log: list = []    # compactions since the oldest in flight
        self._lost_since: Optional[float] = None
        self._laser_buffer: list = []
        self._frame_times: list = []
        self._handed_out: list = []       # traced: frame ids whose results this call returns
        self._mask_pending = bool(self.cfg["mask_radius"] or self.cfg["mask_image"])
        self._sensor_queue = None
        self._last_map_emit = 0.0
        # the last odometry state: the next frame's prior is the delta to it
        self._last_nav_odom = None
        # the last reference (ground-truth) pose seen on the sensor stream
        self.ref_pose = None

        if self.cfg["map_file"]:
            from ..mapstore.checkpoint import load_map

            m = load_map(self.cfg["map_file"], self.engine.device)
            if m is not None:
                self.engine.map = m
                self.engine.status = TrackerStatus.LOST  # relocalize into it

    # -- pipeline API -------------------------------------------------------

    def start(self, sensor_queue=None):
        self._sensor_queue = sensor_queue

    def _configure_mask(self, shape):
        """Build the keypoint mask on the first frame (it needs the image
        size): a centred disc of `mask_radius` px, or a mask image whose
        nonzero pixels keep keypoints."""
        self._mask_pending = False
        h, w = shape
        if self.cfg["mask_image"]:
            from ..io.png import imread_gray

            m = imread_gray(self.cfg["mask_image"])
            if m is None:
                return
            if m.shape != (h, w):
                m = resize_nearest(m, h, w)
            self.engine.set_mask(m > 0)
        elif self.cfg["mask_radius"] > 0:
            yy, xx = np.mgrid[0:h, 0:w]
            r2 = (xx - w / 2.0) ** 2 + (yy - h / 2.0) ** 2
            self.engine.set_mask(r2 <= self.cfg["mask_radius"] ** 2)

    def _maybe_emit_map(self, now: float):
        """Every `emit_map_seconds` (of frame time), push the landmarks onto
        the sensor queue as a features entry."""
        interval = self.cfg["emit_map_seconds"]
        if not interval or self._sensor_queue is None:
            return
        if now - self._last_map_emit < interval:
            return
        self._last_map_emit = now
        self._sensor_queue.push(
            SensorQueueEntry(timestamp=now, kind="features", features=self.get_features(2048))
        )

    def _tcw(self, state) -> SE3:
        """A navigation state (position, R_wc) as a float32 Tcw."""
        pos, R_wc = state
        Rn = np.asarray(R_wc, np.float32)
        tn = -Rn.T @ np.asarray(pos, np.float32)
        return SE3(torch.as_tensor(np.ascontiguousarray(Rn.T), device=self.engine.device),
                   torch.as_tensor(tn, device=self.engine.device))

    def process_image(self, entry: CameraQueueEntry, nav_odom=None, nav_map=None,
                      sensor_values=()) -> list:
        if self.cfg["wait_for_navigation_data"] and nav_odom is None:
            return []
        if not timing.ENABLED:
            return self._process_image(entry, nav_odom, nav_map, sensor_values)
        # the engine's id for this frame: buffered chunk frames take the next ones
        fid = self.engine.frame_id + len(self._chunk_buf)
        with timing.span("process_image", fid):
            timing.stamp(fid, "in")
            results = self._process_image(entry, nav_odom, nav_map, sensor_values)
        self._stamp_handed_out()
        return results

    def _process_image(self, entry, nav_odom, nav_map, sensor_values) -> list:
        if self._mask_pending:
            self._configure_mask(np.shape(entry.image)[:2])
        for sv in sensor_values:
            if getattr(sv, "kind", None) == "global_state" and sv.reference \
                    and sv.state is not None:
                self.ref_pose = sv.state

        # the frame's navigation prior: a map-frame state is an absolute Tcw;
        # odometry gives its delta since the last frame, composed onto the
        # tracked pose (the offset between the two worlds cancels)
        nav_prior = None
        if nav_map is not None:
            nav_prior = self._tcw(nav_map)
        elif (nav_odom is not None and self._last_nav_odom is not None
              and self.engine.status == TrackerStatus.TRACKING):
            delta = se3_compose(self._tcw(nav_odom), se3_inverse(self._tcw(self._last_nav_odom)))
            nav_prior = se3_compose(delta, self.engine.pose)
        if nav_odom is not None:
            self._last_nav_odom = nav_odom

        if self._chunk_size >= 2:
            if self.engine.status == TrackerStatus.TRACKING and nav_prior is None:
                return self._chunk_process(entry)
            flushed = self._chunk_drain_all()
            res = self._process_host(entry, nav_odom, nav_prior)
            return flushed + res if flushed else res
        return self._process_host(entry, nav_odom, nav_prior)

    def _stamp_handed_out(self) -> None:
        """Stamp `out` on the frames whose results the returning call hands out."""
        for fid in self._handed_out:
            timing.stamp(fid, "out")
        self._handed_out.clear()

    def _time_frame(self, seconds: float) -> None:
        self._frame_times.append(seconds)
        if len(self._frame_times) > 30:
            self._frame_times.pop(0)

    def _process_host(self, entry: CameraQueueEntry, nav_odom=None,
                      nav_prior=None) -> list:
        """Per-frame host path: one engine.process per frame."""
        self._host_dirty = True
        t0 = time.monotonic()
        aux = entry.image_second if self.cfg["mode"] == "stereo" else entry.aux
        fid = self.engine.frame_id if timing.ENABLED else None
        st, pose = self.engine.process(entry.image, aux=aux, nav_prior=nav_prior)
        if fid is not None:
            timing.stamp(fid, "pose")
            self._handed_out.append(fid)
        self._time_frame(time.monotonic() - t0)
        self._maybe_emit_map(entry.timestamp)

        if self.cfg["loop_closure"]:
            self._ensure_loop_closer()
            self._maybe_close_loop()
        elif not self.engine.mapping_in_flight:
            # no slot-keyed side tables to fix: discard the events
            self.engine._drain_compact_stats(only_ready=True)
            self.engine._compactions.clear()

        if st == TrackerStatus.LOST:
            if self._lost_since is None:
                self._lost_since = entry.timestamp
            if (self.cfg["relocalize_with_nav_data"] and nav_odom is not None
                    and entry.timestamp - self._lost_since > self.cfg["time_to_relocalize"]):
                self._reseed_from_nav(nav_odom)
            elif self.loop_closer is not None:
                self._bow_relocalize()
        else:
            self._lost_since = None

        if pose is None:
            return []
        center_lp, q = create_tracker_result_pose(pose.R.cpu().numpy(), pose.t.cpu().numpy())
        return [TrackerResult(
            timestamp=entry.timestamp,
            position=center_lp,
            orientation_wxyz=q,
            valid=True,
            position_sigma=_sigma_to_lpslam(self.engine.last_sigma_pos),
            orientation_sigma=float(self.engine.last_sigma_rot),
        )]

    # -- chunked frame loop -------------------------------------------------

    def attach_device_rectify(self, rectify_map) -> None:
        """Undistort on the device in the chunk loop: chunk frames are
        uploaded raw and remapped batched over the chunk. rectify_map:
        (H, W, 2) source coordinates; stereo: (2, H, W, 2). Host-path frames
        are taken as given."""
        self._device_rectify = np.asarray(rectify_map, np.float32)
        self._chunked = None  # rebuilt with the grid

    def _chunk_tracker(self):
        if self._chunked is None:
            from ..frontend.device_loop import ChunkedTracker

            self._chunked = ChunkedTracker(self.engine, rectify_map=self._device_rectify)
            self._host_dirty = False
        return self._chunked

    def _stack_chunk(self, entries):
        """Stack buffered entries into the chunk loop's input layout; uint8
        when the data is integral 0..255."""
        def stack(imgs):
            a = np.stack(imgs)
            if a.dtype != np.uint8 and a.size and float(a.max(initial=0.0)) <= 255.0:
                if np.allclose(a, np.round(a)):
                    a = a.astype(np.uint8)
            return a

        mode = self.cfg["mode"]
        if mode == "stereo":
            return stack([np.stack([e.image, e.image_second]) for e in entries])
        if mode == "rgbd":
            return (stack([e.image for e in entries]),
                    np.stack([e.aux for e in entries]).astype(np.float32))
        return stack([e.image for e in entries])

    def _chunk_process(self, entry: CameraQueueEntry):
        """Buffer the frame; dispatch a chunk when full. Returns None while
        buffering, else the results of the previously dispatched chunk."""
        self._chunk_buf.append(entry)
        if len(self._chunk_buf) < self._chunk_size:
            return None
        ct = self._chunk_tracker()
        if self._host_dirty:
            # the host path ran since the last chunk: its state is newer
            ct.discard_carry()
            self._host_dirty = False
        buf, self._chunk_buf = self._chunk_buf, []
        start_fid = self.engine.frame_id
        n_queued = len(self.engine._pending_compacts)
        t0 = time.monotonic()
        ct.process_chunk(self._stack_chunk(buf))
        self._time_frame((time.monotonic() - t0) / len(buf))
        self._chunk_inflight.extend((start_fid + i, e) for i, e in enumerate(buf))
        results = self._emit_chunk_results(ct.drain(keep_last=1))
        self._maybe_emit_map(entry.timestamp)
        if self.cfg["loop_closure"]:
            self._chunk_loop_boundary(ct)
        else:
            # no slot-keyed side tables to fix: drop the compactions queued
            # before this chunk, without a device read. The chunk started from
            # their compacted map, so ct.sync() sets the keyframe count past
            # them; only this boundary's compaction is still to be counted.
            del self.engine._pending_compacts[:n_queued]
            self.engine._compactions.clear()
        return results

    def _chunk_drain_all(self) -> list:
        """Flush the chunk path: drain every dispatched chunk's outputs and
        run still-buffered frames through the host path, in frame order."""
        if self._chunked is None and not self._chunk_buf:
            return []
        results = []
        if self._chunked is not None:
            self._chunked.sync()
            results += self._emit_chunk_results(self._chunked.drain())
        buf, self._chunk_buf = self._chunk_buf, []
        for e in buf:
            results += self._process_host(e)
        return results

    def flush(self) -> list:
        """Drain deferred chunk results, then land in-flight loop verdicts
        so the final map is corrected."""
        out = self._chunk_drain_all()
        self._loop_drain()
        self._stamp_handed_out()
        return out

    def _emit_chunk_results(self, drained) -> list:
        """TrackerResults and trajectory records of drained chunk outputs;
        a chunk that ends LOST hands recovery to the host path."""
        sts, _, pR, pt, _, sig_p, sig_r = drained
        out = []
        for i in range(len(sts)):
            fid, entry = self._chunk_inflight.pop(0)
            if timing.ENABLED:
                self._handed_out.append(fid)
            tracking = sts[i] == int(TrackerStatus.TRACKING)
            self.engine.trajectory.append(
                (fid, SE3(pR[i], pt[i]) if tracking else None, TrackerStatus(int(sts[i])))
            )
            if tracking:
                center_lp, q = create_tracker_result_pose(pR[i], pt[i])
                out.append(TrackerResult(
                    entry.timestamp, center_lp, q, True,
                    position_sigma=_sigma_to_lpslam(sig_p[i]),
                    orientation_sigma=float(sig_r[i]),
                ))
            else:
                out.append(TrackerResult(entry.timestamp, np.zeros(3),
                                         np.array([1.0, 0, 0, 0]), False))
        if len(sts) and sts[-1] == int(TrackerStatus.LOST):
            self._chunked.invalidate_carry()
            if self.engine.status == TrackerStatus.LOST \
                    and self._lost_since is None and out:
                self._lost_since = out[-1].timestamp
        return out

    # -- loop closing ---------------------------------------------------------

    def _chunk_loop_boundary(self, ct) -> None:
        """At a chunk boundary: sync the keyframe counters, realign the BoW
        database through compactions, add new keyframes and try to close."""
        ct.sync()
        self._ensure_loop_closer()
        if self._maybe_close_loop():
            # the pose was resynced to the corrected keyframe
            ct.discard_carry()

    def _sync_compactions(self):
        """Remap the BoW database rows and the pending-keyframe cursor
        through each compaction's keyframe slot permutation; log the
        permutation for verdicts in flight."""
        for kf_order, n_kf_after in self.engine.drain_compactions():
            if self.loop_closer is not None:
                if self._loop_exec is not None:
                    lc, order = self.loop_closer, np.asarray(kf_order).copy()
                    self._loop_exec.submit(lc.remap, order, n_kf_after)
                else:
                    self.loop_closer.remap(kf_order, n_kf_after)
            if self._loop_verdicts:
                self._loop_perm_log.append(
                    (np.asarray(kf_order)[:n_kf_after].copy(), n_kf_after)
                )
            # surviving old slots, in order, are kf_order[:n_kf_after]
            self._loop_pending_kfs = int(
                np.sum(kf_order[:n_kf_after] < self._loop_pending_kfs)
            )

    def _loop_cfg(self):
        """Metric maps (stereo / RGB-D) close loops with a fixed scale."""
        from ..loop.detector import LoopConfig

        return LoopConfig(
            fix_scale=self.cfg["mode"] != "mono",
            global_ba_iters=int(self.cfg["loop_global_ba_iters"]),
        )

    def _ensure_loop_closer(self):
        if self.loop_closer is not None:
            return
        path = self.cfg["vocab_file"] or SHIPPED_VOCAB
        if os.path.exists(path) or os.path.exists(path + ".npz"):
            from ..loop import LoopCloser, load_vocabulary

            vocab = load_vocabulary(path, self.engine.device)
            self.loop_closer = LoopCloser(vocab, self.cfg["max_keyframes"],
                                          cfg=self._loop_cfg())

    def _maybe_close_loop(self) -> bool:
        """True when a loop closure was accepted and applied (the tracker
        pose was resynced)."""
        # keyframe slots must not shift under the loop bookkeeping
        if self.engine.mapping_in_flight:
            return False
        self._sync_compactions()
        nk = self.engine.n_keyframes
        if nk <= self._loop_pending_kfs:
            return self._loop_poll()
        if self.loop_closer is None:
            # no vocabulary file: train one on the map's own descriptors
            if nk < 4:
                self._loop_pending_kfs = nk
                return False
            from ..loop import LoopCloser, train_vocabulary

            m = self.engine.map
            desc = m.kf_desc[:nk].reshape(-1, 8)
            valid = m.kf_kp_valid[:nk].reshape(-1)
            train = desc[valid][:4096]
            vocab = train_vocabulary(train, n_words=min(512, max(64, len(train) // 8)))
            self.loop_closer = LoopCloser(vocab, self.cfg["max_keyframes"], cfg=self._loop_cfg())
            for k in range(nk):
                self.loop_closer.add_keyframe(m, k)
            self._loop_pending_kfs = nk
            return False
        closed = self._loop_poll()
        for k in range(self._loop_pending_kfs, nk):
            if self.cfg["loop_async"]:
                self._loop_submit(k)
            else:
                self.loop_closer.add_keyframe(self.engine.map, k)
                self.engine.map, res = self.loop_closer.try_close(
                    self.engine.map, k, cam=self.engine.cam
                )
                if res.detected:
                    self._loop_resync_pose()
                    closed = True
        self._loop_pending_kfs = nk
        return closed

    def _loop_submit(self, k: int) -> None:
        """Queue BoW insert + detect/verify of keyframe k on the worker,
        against the current map (map updates are functional, so the tensors
        it holds are never written again)."""
        if self._loop_exec is None:
            self._loop_exec = ThreadPoolExecutor(max_workers=1,
                                                 thread_name_prefix="loop-closer")
            self._loop_verdicts = deque()
        lc, m = self.loop_closer, self.engine.map

        def job():
            lc.add_keyframe(m, k)
            return lc.verify(m, k)

        self._loop_verdicts.append((self._loop_exec.submit(job), len(self._loop_perm_log)))

    def _loop_poll(self, block: bool = False) -> bool:
        """Apply finished verdicts, oldest first. Non-blocking unless
        `block`."""
        closed = False
        while self._loop_verdicts:
            fut, epoch = self._loop_verdicts[0]
            if not (block or fut.done()):
                break
            self._loop_verdicts.popleft()
            closed |= self._loop_apply(fut.result(), epoch)
        if self._loop_verdicts is not None and not self._loop_verdicts:
            self._loop_perm_log.clear()  # nothing in flight references it
        return closed

    def _loop_apply(self, verdict, epoch: int) -> bool:
        """Apply a verified closure to the current map, its keyframe indices
        remapped through the compactions since it was submitted; dropped if
        a party to the loop was culled."""
        if not verdict.result.detected:
            return False
        k_new, cand = verdict.k_new, verdict.result.candidate
        for surv, _n_after in self._loop_perm_log[epoch:]:
            surv = list(surv)
            if k_new not in surv or cand not in surv:
                return False
            k_new, cand = surv.index(k_new), surv.index(cand)
        verdict = verdict._replace(k_new=k_new, result=verdict.result._replace(candidate=cand))
        self.engine.map, res = self.loop_closer.apply(self.engine.map, verdict,
                                                      cam=self.engine.cam)
        if res.detected:
            self._loop_resync_pose()
        return res.detected

    def _loop_resync_pose(self) -> None:
        """Resync the tracker pose to the corrected newest keyframe."""
        m = self.engine.map
        kk = m.n_kf - 1
        self.engine.pose = SE3(_row(m.kf_R, kk), _row(m.kf_t, kk))

    def _loop_drain(self) -> bool:
        """Wait for every verification in flight and apply the verdicts."""
        if self._loop_exec is None:
            return False
        return self._loop_poll(block=True)

    def _bow_relocalize(self):
        """After tracking loss: BoW candidates from the keyframe database ->
        PnP + pose refinement with an inlier gate in the engine."""
        feats = getattr(self.engine, "last_feats", None)
        if feats is None:
            return
        # the database must not grow under the scoring read below
        self._loop_drain()
        from ..loop.vocab import bow_similarity, bow_vector

        lc = self.loop_closer
        v = bow_vector(lc.vocab, feats.desc, feats.valid)
        scores = bow_similarity(v, lc.db).cpu().numpy().copy()
        scores[lc.n:] = -1.0
        order = np.argsort(-scores)
        cands = [int(k) for k in order[:3] if scores[k] >= 0.1]
        if not cands:
            return
        # the inlier gate scales with the keypoint budget
        min_inl = max(30, self.cfg["keypoints"] // 20)
        if self.engine.relocalize_with_candidates(feats, cands, min_inliers=min_inl):
            self._lost_since = None
            return
        if self.cfg["unverified_bow_teleport"]:
            m, best = self.engine.map, cands[0]
            self.engine.pose = SE3(m.kf_R[best], m.kf_t[best])

    def _reseed_from_nav(self, nav_odom):
        """Put the LOST engine at the odometry pose; the next frame's wide
        window tries to match from there."""
        pos, R_wc = nav_odom
        R = np.asarray(R_wc)
        t = -R.T @ np.asarray(pos)
        dev = self.engine.device
        self.engine.pose = SE3(torch.as_tensor(R.T, dtype=torch.float32, device=dev),
                               torch.as_tensor(t, dtype=torch.float32, device=dev))
        self.engine.status = TrackerStatus.LOST
        self._lost_since = None

    # -- laser scans and the occupancy grid ---------------------------------

    def add_laser_scan(self, scan: LaserScan):
        self._laser_buffer.append(scan)
        cutoff = scan.timestamp - self.cfg["max_laser_age"]
        self._laser_buffer = [s for s in self._laser_buffer if s.timestamp >= cutoff]

    def get_occupancy_map(self):
        """Landmarks and buffered laser endpoints on a 2-D grid over the
        optical (x, z) ground plane: dict(grid int8 (H, W) with -1 unknown /
        0 free / 100 occupied, origin (2,), cell_size). Free space is carved
        along every (keyframe, observed landmark) ray, sampled at up to 96
        points; above 200,000 rays a seeded permutation keeps that many."""
        m = self.engine.map
        nk = int(m.n_kf)
        if nk == 0:
            return None
        lmv = _np(m.lm_valid)
        lm_world = _np(m.lm_pos)
        pts = lm_world[lmv]
        if len(pts) == 0:
            return None
        cs = self.cfg["occupancy_cell_size"]
        kf_R = _np(m.kf_R[:nk])
        kf_t = _np(m.kf_t[:nk])
        centers = -np.einsum("kij,kj->ki", kf_R.transpose(0, 2, 1), kf_t)
        all_xy = np.concatenate([pts[:, [0, 2]], centers[:, [0, 2]]], 0)
        lo = all_xy.min(0) - 3 * cs
        hi = all_xy.max(0) + 3 * cs
        shape = np.maximum(((hi - lo) / cs).astype(int) + 1, 1)
        grid = np.full((shape[1], shape[0]), -1, np.int8)

        def to_cell(xy):
            c = ((xy - lo) / cs).astype(int)
            return np.clip(c, 0, shape - 1)

        kf_lm = _np(m.kf_lm_idx[:nk])
        kk, nn = np.nonzero(kf_lm >= 0)
        lm_idx = kf_lm[kk, nn]
        keep = lmv[lm_idx]
        kk, lm_idx = kk[keep], lm_idx[keep]
        uniq = np.unique(np.stack([kk, lm_idx], 1), axis=0)
        max_rays = 200_000
        if len(uniq) > max_rays:
            uniq = uniq[np.random.default_rng(0).permutation(len(uniq))[:max_rays]]
        if len(uniq):
            src = centers[uniq[:, 0]][:, [0, 2]]
            dst = lm_world[uniq[:, 1]][:, [0, 2]]
            max_len_cells = np.max(np.abs(dst - src)) / cs + 1
            n_s = int(np.clip(max_len_cells, 2, 96))
            ts = np.linspace(0.0, 1.0 - 1.0 / n_s, n_s)[None, :, None]
            rays = src[:, None, :] + (dst - src)[:, None, :] * ts
            cells = to_cell(rays.reshape(-1, 2))
            grid[cells[:, 1], cells[:, 0]] = 0
        cam_cells = to_cell(centers[:, [0, 2]])
        grid[cam_cells[:, 1], cam_cells[:, 0]] = 0
        lm_cells = to_cell(pts[:, [0, 2]])
        grid[lm_cells[:, 1], lm_cells[:, 0]] = 100
        for scan in self._laser_buffer:
            angles = scan.angle_min + np.arange(len(scan.ranges)) * scan.angle_increment
            ok = (scan.ranges > 0) & (scan.ranges < scan.range_max)
            ex = scan.ranges[ok] * np.cos(angles[ok])
            ez = scan.ranges[ok] * np.sin(angles[ok])
            pts_cam = np.stack([ex, np.zeros_like(ex), ez], 1)
            if scan.extrinsic_R is not None:
                pts_cam = pts_cam @ np.asarray(scan.extrinsic_R).T
                if scan.extrinsic_t is not None:
                    pts_cam = pts_cam + np.asarray(scan.extrinsic_t)
            R = kf_R[nk - 1]
            ctr = -R.T @ kf_t[nk - 1]
            pts_l = pts_cam @ R + ctr
            for c in to_cell(pts_l[:, [0, 2]]):
                grid[c[1], c[0]] = 100
        return {"grid": grid, "origin": lo, "cell_size": cs}

    # -- status and exports -------------------------------------------------

    def status(self) -> dict:
        ft = float(np.mean(self._frame_times)) if self._frame_times else 0.0
        return {
            "state": self.engine.status.name,
            "keyframes": self.engine.n_keyframes,
            "landmarks": self.engine.n_landmarks,
            "frame_time": ft,
        }

    def get_features(self, max_count: int = 0, boundary=None, transform=None):
        """The landmarks in the lpslam frame as [{"position", "observations"}].

        boundary: optional ((y_min, z_min), (y_max, z_max)) rectangle in the
        lpslam map plane; only landmarks whose (y, z) lie inside are kept.
        transform: optional 3x3 (or flat 9) matrix applied to each position.
        """
        m = self.engine.map
        lmv = _np(m.lm_valid)
        pts = _np(m.lm_pos)[lmv]
        obs = _np(m.lm_n_obs)[lmv]
        pts = optical_to_lpslam(pts) if len(pts) else pts
        if boundary is not None:
            (y0, z0), (y1, z1) = boundary
            ylo, yhi = min(y0, y1), max(y0, y1)
            zlo, zhi = min(z0, z1), max(z0, z1)
            keep = ((pts[:, 1] >= ylo) & (pts[:, 1] <= yhi)
                    & (pts[:, 2] >= zlo) & (pts[:, 2] <= zhi))
            pts, obs = pts[keep], obs[keep]
        if transform is not None:
            T = np.asarray(transform, np.float32).reshape(3, 3)
            pts = pts @ T.T
        if max_count and len(pts) > max_count:
            pts, obs = pts[:max_count], obs[:max_count]
        return [{"position": p, "observations": int(o)} for p, o in zip(pts, obs)]

    def get_features_count(self, boundary=None) -> int:
        return len(self.get_features(0, boundary=boundary))

    def export_csv(self, path: str):
        """The landmarks as CSV, in the engine's world (optical) frame."""
        m = self.engine.map
        lmv = _np(m.lm_valid)
        pts = _np(m.lm_pos)[lmv]
        obs = _np(m.lm_n_obs)[lmv]
        with open(path, "w") as f:
            f.write("x,y,z,n_obs\n")
            for p, o in zip(pts, obs):
                f.write(f"{p[0]},{p[1]},{p[2]},{int(o)}\n")

    def set_mapping_mode(self, enabled: bool):
        """Freeze (False) or resume (True) keyframe insertion, on the host
        path and in the chunk loop (the JAX package's chunk loop keeps the
        switch it was built with)."""
        self.engine.mapping_enabled = bool(enabled)
        if self._chunked is not None:
            self._chunked.rebuild_step()

    def save_map(self, path: str):
        from ..mapstore.checkpoint import save_map

        save_map(self.engine.map, path)

    def stop(self):
        self._loop_drain()
        if self._loop_exec is not None:
            self._loop_exec.shutdown(wait=True)
            self._loop_exec = None
        if self.cfg["map_file"]:
            self.save_map(self.cfg["map_file"])
