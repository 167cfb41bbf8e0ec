"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero and prints no result):
1. require a CUDA card; print `nvidia-smi`'s name and power limit;
2. build the hand-written CUDA kernels from csrc/, one nvcc per source, all
   started together (timed);
3. the patch kernel, 3b. the FAST+NMS kernel in both forms (fixed ceiling,
   and each frame's own ceiling with its max pass), each against its plain
   PyTorch version on the card, at the shapes the main paths give it (B = 16
   per level, B = 1 and 2 at 480x640) plus border, tail, small-level and
   flat-frame cases; must be bit-equal. Each kernel is timed three ways:
   the device time of the kernel alone (a CUDA graph of launches replayed
   between two events; on the same input again, which the 50 MB L2 may
   hold, and rotating over inputs that exceed it), the host cost of one
   wrapper call (host clock over un-synchronized calls), and the CUDA-event
   mean of wrapper calls beside the plain version's. Its bound is the larger
   of bytes (each input read once, each output written once) over 3.35 TB/s
   and operations over 33.5 T/s (the card's fp32 rate outside the tensor
   cores, 67 TFLOP/s, counts an FMA as two; these kernels have none); the
   FAST operations are counted on the timed images (`fast_operations`);
4. the monocular slice at the reference operating point (640x480 ray-cast
   room with lens distortion, 1200 keypoints, 3 levels, the composite's
   FAST score with each frame's ceiling, chunks of 16): host initialization,
   then 6 chunks through ChunkedTracker;
5. the stereo slice at the same width (the room's right eye 0.11 m to the
   right, rectified with rectify_maps_stereo, fused FAST kernel): host
   initialization, then 4 chunks of (16, 2, 480, 640) eye pairs;
6. the RGB-D slice (depth maps undistorted with the gray images, fused FAST
   kernel): host initialization, then 3 chunks;
7. the 740-frame room with loop closure through VSLAMTracker (mono, chunks
   of 16), twice, held to the JAX package's CPU run (JAX_LOOP_REF);
8. kidnapped relocalization of four first-lap frames on phase 7's map;
9. the CLI (`pipeline.cli.main`) in process on a JSON config at the
   operating point: the synthetic source (64 frames, 640x480; it publishes
   ground truth as odometry, so every TRACKING frame carries a navigation
   prior and takes the host path), VSLAM mono with a radial mask, loop
   closure, map emission and a map file; no frame dropped (the 64-slot
   camera queue holds them all), >= 90% of the frames after initialization
   tracked, Sim3 ATE within the JAX package's bound (JAX_PIPELINE_REF), the
   map file written, one CSV row per landmark;
10. LpSlamManager localizing in phase 9's map (mapping off, loop closure on)
   from buffers, every second one 3-channel BGR, pushes paced to keep < 32
   frames queued, plus a laser scan: the keyframe count stays the loaded
   map's, >= 90% of the frames after relocalization tracked, one feature
   per landmark, occupied cells in the occupancy grid, ATE within the JAX
   bound;
11. run_dataset on the stereo room at its design length (600 frames, 1.08
   turns, so the camera comes back to its first views) with
   RectifyProcessor on the card, loop closure and chunks of 16: >= 90%
   tracked, >= 1 closure accepted and within 1 of the JAX package's count,
   ATE within max(1.5 x JAX, JAX + 0.02 m) of its run (JAX_PIPELINE_REF).
Phases 9-11 check that no worker or tracker error was recorded and that
each of the three kernels launched; each prints its frames/s and wall time.
Each path resets the kernels' launch counters just before its
initialization and reads them just after its loop. Checks per path: ends
TRACKING, >= 90% frames tracked, finite poses, >= 2 keyframes inserted in
the chunk loop, the kernels launched on every extraction (the patch and
score kernels once per level; on the mono paths, phases 4, 7 and 8, the max
pass too), and ATE under a bound: Sim3-aligned < 0.10 m for mono; aligned without scale (depth fixes
the scale) under max(1.5 x, + 0.02 m) of the JAX package's CPU run on the
same frames for stereo and RGB-D (JAX_CPU_ATE).

The line before the last is the per-kernel JSON record: launches summed
over the paths of phases 4-11; `device_ms`, `bound_ms`, `ms` and `plain_ms` summed over the
three levels at B = 16; `enqueue_us` the mean over them; `levels` the
per-level and B = 1 readings. The last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_INIT = 16
CHUNK = 16
N_CHUNKS = 6
KEYPOINTS = 1200
LEVELS = 3
# the depth phases: a depth tracker initializes on its first good frame
DEPTH_N_INIT = 4
STEREO_CHUNKS = 4
RGBD_CHUNKS = 3
RGBD_MAX_DEPTH = 12.0
# ATE (aligned without scale) of the JAX package on the same frames and
# configuration, on the CPU: tools/jax_depth_reference.py --mode stereo|rgbd.
# The bound is the parity tests' rule, max(1.5 x JAX, JAX + 0.02 m).
JAX_CPU_ATE = {"stereo": 0.0032146948320875947, "rgbd": 0.002910419188752248}


def ate_bound(mode: str) -> float:
    ref = JAX_CPU_ATE[mode]
    return max(1.5 * ref, ref + 0.02)


# phases 7-8: the room with loop closure, the configuration of the JAX
# package's EVAL_r05 mono row (`run_dataset --bench room --mode mono --frames
# 600 --loop`) with its chunk loop on (`--chunk 16`), lengthened at
# run_dataset's per-frame motion (turns = 1.08 * n / 600) until the JAX
# package accepts a closure on the CPU (tools/jax_loop_reference.py): none at
# 600 or 700 frames, one at 740, the shortest length tried that has one.
LOOP_FRAMES = 740
LOOP_FPS = 20.0
LOOP_CONFIG = {
    "mode": "mono", "keypoints": KEYPOINTS, "levels": LEVELS,
    "max_keyframes": 128, "max_landmarks": 24576,
    "loop_closure": True, "loop_global_ba_iters": 5,
    # synchronous closing is deterministic: the run held to the JAX one
    "loop_async": False, "chunk_size": CHUNK,
}
# phase 8: first-lap frames from the part of the orbit the second lap does
# not revisit (lap two covers lap one's frames 0-185), so the map holds one
# region for each; where both laps mapped a place, their landmarks may stay
# apart (0.42 m at frame 150 in the JAX package's 800-frame map)
KIDNAP_FRAMES = (280, 350, 420, 490)


def render_room(n_frames: int = LOOP_FRAMES, h: int = 480, w: int = 640):
    """The room's raw uint8 frames, ground-truth centres, intrinsics and the
    numpy undistortion grid (the port's numpy renderer and map, which the
    JAX reference tool uses too, so both packages see the same bytes)."""
    from lpslam_tpu_torch.geometry.camera import undistort_map_radtan
    from lpslam_tpu_torch.io import SyntheticBenchmark

    ds = SyntheticBenchmark(num_frames=n_frames, h=h, w=w, seed=0,
                            turns=1.08 * n_frames / 600.0, fps=LOOP_FPS)
    raw = np.stack([np.clip(f.image, 0, 255).astype(np.uint8) for f in ds])
    intr = ds.intr
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
    grid = undistort_map_radtan(K, intr["dist"], (h, w))
    return raw, ds.ground_truth().positions, K, grid


def drive_room(tracker, tracking, entry_cls, raw, rectified, chunk: int = CHUNK) -> int:
    """Feed frames to a VSLAMTracker with the undistortion grid attached to
    its chunk path (`attach_device_rectify`): a frame headed for the host
    path (engine not TRACKING) is passed undistorted (`rectified(t)`), one
    headed for the chunk path raw. Feeding stops at the last whole chunk, so
    flush() sends no raw frame through the host path. Returns frames fed."""
    n = end = len(raw)
    chunked = False
    t = 0
    while t < end:
        host = tracker.engine.status != tracking
        if not host and not chunked:
            chunked = True
            end = t + chunk * ((n - t) // chunk)
            if t >= end:
                break
        img = rectified(t) if host else raw[t]
        tracker.process_image(entry_cls(timestamp=t / LOOP_FPS, image=img))
        t += 1
    tracker.flush()
    return t


def record_closures(closer_cls):
    """Record every verdict the class applies that named a candidate, as
    (k_new, candidate, n_matches, n_inliers, accepted). Returns (list, undo)."""
    verdicts = []
    orig = closer_cls.apply

    def apply(self, m, verdict, cam=None):
        out = orig(self, m, verdict, cam=cam)
        r = verdict.result
        if r.candidate >= 0:
            verdicts.append((int(verdict.k_new), int(r.candidate), int(r.n_matches),
                             int(r.n_inliers), bool(r.detected)))
        return out

    closer_cls.apply = apply
    return verdicts, lambda: setattr(closer_cls, "apply", orig)


def room_metrics(engine, gt):
    """Tracked frames, Sim3 ATE of the trajectory's camera centres and the
    alignment (s, R, t) that phase 8 reuses."""
    from lpslam_tpu_torch.eval.ate import align_umeyama

    fids, est = [], []
    for fid, pose, _ in engine.trajectory:
        if pose is not None:
            fids.append(fid)
            est.append(-np.asarray(pose.R).T @ np.asarray(pose.t))
    est = np.asarray(est, np.float64)
    fids = np.asarray(fids)
    s, R, t = align_umeyama(est, gt[fids], with_scale=True)
    err = np.linalg.norm(s * est @ R.T + t - gt[fids], axis=1)
    bins = fids // 100
    return {"tracked": len(fids), "ate_m": float(np.sqrt(np.mean(err ** 2))),
            "err_by_100_frames": [round(float(err[bins == b].mean()), 4)
                                  for b in np.unique(bins)],
            "align": (s, R, t)}


def kidnap(tracker, lost, entry_cls, rectified, gt, align, to_np, blind_pose,
           frames=KIDNAP_FRAMES):
    """Kidnap the engine before each frame: status LOST and a pose prior
    that sees no landmark (`blind_pose(pose)`: the same rotation, 1e4 map
    units back along the optical axis, so every landmark lies behind the
    camera). The frame then goes through the host path: the LOST branch's
    wide-window matching finds nothing, and _bow_relocalize ->
    relocalize_with_candidates must place it. Returns one record per frame:
    whether relocalization verified a pose, and the distance of the
    engine's camera centre, after the phase-7 alignment, from ground truth.
    (With the engine's own last pose as the prior, the wide-window matching
    of the JAX package converges to a wrong pose 0.4-2.3 m off instead.)"""
    eng = tracker.engine
    orig = eng.relocalize_with_candidates
    calls = []

    def spy(*a, **kw):
        ok = orig(*a, **kw)
        calls.append(bool(ok))
        return ok

    eng.relocalize_with_candidates = spy
    s, R, t = align
    out = []
    try:
        for f in frames:
            eng.status = lost
            eng.pose = blind_pose(eng.pose)
            n0 = len(calls)
            tracker.process_image(entry_cls(timestamp=f / LOOP_FPS, image=rectified(f)))
            c = -to_np(eng.pose.R).T @ to_np(eng.pose.t)
            err = float(np.linalg.norm(s * R @ c + t - gt[f]))
            out.append({"frame": f, "relocalized": len(calls) > n0 and calls[-1],
                        "attempted": len(calls) > n0, "err_m": err,
                        "status": eng.status.name})
    finally:
        del eng.relocalize_with_candidates
    return out


def stereo_rig(intr):
    """The room's stereo extrinsics (right eye w.r.t. the left), as
    lpslam_tpu/eval/run_dataset.py builds them: R_rl = I, t_rl = [-b, 0, 0]."""
    return np.eye(3), np.array([-intr["baseline"], 0.0, 0.0])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(launches, replays: int = 20) -> float:
    """Device time of one kernel launch: the callables (each one launch, no
    host read) are captured into a CUDA graph, and the graph is replayed
    between two events, so no host work lies between the launches."""
    for fn in launches:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in launches:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(launches))


def device_times(launch_on, make_inputs, set_bytes: int, n: int = 20):
    """(warm, cold) device ms of a kernel: `launch_on(inputs)` launches it.
    Warm repeats one input set, as a caller finds an image the blur has just
    written; cold rotates over enough sets to exceed twice the 50 MB L2."""
    sets = [make_inputs() for _ in range(max(2, -(-100_000_000 // set_bytes)))]
    warm = graph_ms([lambda: launch_on(sets[0])] * n)
    cold = graph_ms([(lambda x=x: launch_on(x)) for x in sets] * -(-n // len(sets)))
    return warm, cold


def enqueue_us(fn, n: int = 200) -> float:
    """Host cost of one wrapper call: host clock over un-synchronized calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


HBM_BYTES_PER_S = 3.35e12
# fp32 outside the tensor cores: 67 TFLOP/s counts an FMA as two operations
FP32_OPS_PER_S = 33.5e12


def bound_of(n_bytes: float, n_ops: float = 0.0):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def patch_bytes(img, xy) -> int:
    """Bytes the patch kernel must move for these keypoints: the image pixels
    that some window covers (the union of the windows, from a 2-D difference
    array of their corners), the keypoints, and the output."""
    from lpslam_tpu_torch.kernels.patch import PATCH, _corners

    b, h, w = img.shape
    x0, y0 = _corners(xy, h, w)
    frame = torch.arange(b, device=img.device)[:, None].expand_as(x0)
    cover = torch.zeros((b, h + 1, w + 1), dtype=torch.int32, device=img.device)
    for dy, dx, sign in ((0, 0, 1), (0, PATCH, -1), (PATCH, 0, -1), (PATCH, PATCH, 1)):
        cover.index_put_((frame, y0 + dy, x0 + dx),
                         torch.full_like(x0, sign, dtype=torch.int32), accumulate=True)
    covered = int((cover.cumsum(1).cumsum(2) > 0).sum())
    return 4 * (covered + xy.numel() + b * xy.shape[1] * PATCH * PATCH)


def fast_operations(img, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """Operations the FAST kernels need on these images, (score kernel, max
    pass): every pixel 12 (blend, 3x3 maximum, select) or 1 (running max);
    an interior pixel 20 for the compass test (4 differences, 8 compares,
    the counts); a pixel with two bright or two dark compass taps at thr_lo
    98 (16 differences, 32 compares and mask bits, two run tests); a thr_lo
    corner at least 19 for its sum (9 taps, max), plus in the score kernel
    82 for the thr_hi masks and run tests; a thr_hi corner 19 for its sum.
    This is the work of the kernels' design (compass test, then masks), not
    a proven least for the function, so the operation bound errs high."""
    from lpslam_tpu_torch.kernels.fast import _interior, fast_score

    b, h, w = img.shape
    d = [torch.roll(img, (-dy, -dx), (-2, -1)) - img
         for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0))]
    nb = sum((x > thr_lo).int() for x in d)
    nd = sum((x < -thr_lo).int() for x in d)
    interior = _interior(h, w, 3, img.device)
    n_int = b * int(interior.sum())
    n_cand = int((((nb >= 2) | (nd >= 2)) & interior).sum())
    n_lo = int(fast_score(img, thr_lo)[1].sum())
    n_hi = int(fast_score(img, thr_hi)[1].sum())
    shared = 20 * n_int + 98 * n_cand + 19 * n_lo
    counts = {"pixels": b * h * w, "interior": n_int, "compass_pass": n_cand,
              "lo_corners": n_lo, "hi_corners": n_hi}
    return 12 * b * h * w + shared + 82 * n_lo + 19 * n_hi, b * h * w + shared, counts


def level_cases():
    """(H, W, N) per pyramid level at the operating point."""
    from lpslam_tpu_torch.kernels.orb import _level_budgets
    from lpslam_tpu_torch.kernels.pyramid import pyramid_shapes

    shapes = pyramid_shapes(480, 640, LEVELS, 1.2)
    ks = _level_budgets(KEYPOINTS, LEVELS, 1.2)
    return [(h, w, k) for (h, w), k in zip(shapes, ks)]


def check_patch_kernel(device, seed: int = 0):
    """Kernel vs plain version at B = CHUNK for every level, plus border and
    tail cases, and at B = 1 (the host path). Returns the kernel record
    (launch count filled in later)."""
    from lpslam_tpu_torch.kernels import patch

    rng = np.random.default_rng(seed)

    def inputs(b, h, w, n):
        img = torch.from_numpy((rng.random((b, h, w)) * 255).astype(np.float32)).to(device)
        xy = rng.uniform(0, [w, h], (b, n, 2)).astype(np.float32)
        # border clamps, exact .5 centres, out-of-image keypoints
        xy[:, :6] = [[0, 0], [w - 1, h - 1], [16, 16], [w - 17, h - 17],
                     [20.5, 21.5], [-3, h + 50]]
        return img, torch.from_numpy(xy).to(device)

    def launch_on(x):
        patch.launch_patches(*x)

    levels = []
    max_err = 0.0
    for b in (CHUNK, 1):
        for h, w, n in level_cases():
            img, xy = inputs(b, h, w, n)
            got = patch.extract_patches_cuda(img, xy)
            want = patch.extract_patches_reference(img, xy)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"patch kernel differs at level {h}x{w} B={b}")
            max_err = max(max_err, float((got - want).abs().max()))
            n_bytes = patch_bytes(img, xy)
            warm, cold = device_times(
                launch_on, lambda: (*inputs(b, h, w, n), torch.empty_like(got)), n_bytes)
            bound, by = bound_of(n_bytes)
            rec = {"B": b, "H": h, "W": w, "N": n, "device_ms": warm, "device_cold_ms": cold,
                   "enqueue_us": enqueue_us(lambda: patch.extract_patches_cuda(img, xy)),
                   "ms": cuda_ms(lambda: patch.extract_patches_cuda(img, xy)),
                   "plain_ms": cuda_ms(lambda: patch.extract_patches_reference(img, xy)),
                   "bytes": n_bytes, "bound_ms": bound, "bound_by": by}
            levels.append(rec)
            print(f"patch {h}x{w} B={b} N={n}: bit-equal, device {warm:.4f} ms (L2-warm), "
                  f"{cold:.4f} ms (cold), bound {bound:.4f} ms ({by}), share "
                  f"{bound / warm:.2f}; wrapper {rec['enqueue_us']:.1f} us/call, event mean "
                  f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms")
    # tail: a keypoint count no block size divides, one frame
    img = torch.from_numpy((rng.random((1, 37, 45)) * 255).astype(np.float32)).to(device)
    xy = torch.from_numpy(rng.uniform(-5, 50, (1, 13, 2)).astype(np.float32)).to(device)
    if not torch.equal(patch.extract_patches_cuda(img, xy),
                       patch.extract_patches_reference(img, xy)):
        raise AssertionError("patch kernel differs on the tail case")
    print("patch tail case 37x45 N=13: bit-equal")
    return kernel_record("extract_patches", "lpslam_tpu_torch/csrc/patch.cu",
                         "lpslam_tpu/kernels/pallas_patch.py:64", max_err, levels)


def kernel_record(name, source, replaces, max_err, levels):
    """A record of the `kernels` line: sums over the B = CHUNK levels."""
    chunk = [r for r in levels if r["B"] == CHUNK]
    total = lambda key: sum(r[key] for r in chunk)  # noqa: E731
    ops = total("operations") if "operations" in chunk[0] else 0.0
    bound, by = bound_of(total("bytes"), ops)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": 0,
        "max_abs_err": max_err,
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "device_ms": total("device_ms"),
        "device_cold_ms": total("device_cold_ms"),
        "enqueue_us": total("enqueue_us") / len(chunk),
        "levels": levels,
    }


def check_fast_kernel(device, seed: int = 1):
    """The FAST+NMS kernels vs their plain versions, in both forms (fixed
    ceiling; each frame's own ceiling, with the max pass held against the
    plain maximum too): B = CHUNK at every level and B = 1 and 2 (the host
    batches) at level 0, on random, textured and edge-heavy images; a batch
    whose frames have very different maxima, one of them flat; then levels
    under 80 rows, an odd 37x45, and levels a few pixels over the 7 rows
    FAST needs, with extreme one-pixel corners on the 3-pixel border where
    the plain version's shifts wrap around. Times are taken on the textured
    batch. Returns the records of the score kernel and of the max pass
    (launch counts filled in later)."""
    from lpslam_tpu_torch.io.synthetic import make_texture
    from lpslam_tpu_torch.kernels import fast_nms

    rng = np.random.default_rng(seed)

    def image(kind, b, h, w):
        if kind == "textured":
            return np.ascontiguousarray(np.stack([
                make_texture(max(h, 20), max(w, 20), seed=seed + i)[:h, :w] for i in range(b)
            ]))
        x = (rng.random((b, h, w)) * 255).astype(np.float32)
        if kind == "edges":  # one-pixel corners on and next to the border
            x[:, :4, :] = rng.choice([0.0, 255.0], (b, min(4, h), w))
            x[:, -4:, :] = rng.choice([0.0, 255.0], (b, min(4, h), w))
            x[:, :, :4] = rng.choice([0.0, 255.0], (b, h, min(4, w)))
            x[:, :, -4:] = rng.choice([0.0, 255.0], (b, h, min(4, w)))
        if kind == "uneven":  # frame 0 flat (max s_lo = 0), the others at rising contrast
            x *= np.linspace(0.0, 1.0, b, dtype=np.float32)[:, None, None] ** 2
        return x

    def check(kind, b, h, w):
        img = torch.from_numpy(image(kind, b, h, w)).to(device)
        err = 0.0
        for frame_ceiling in (False, True):
            got = fast_nms.fast_nms_score_cuda(img, frame_ceiling=frame_ceiling)
            want = fast_nms.fast_nms_score_reference(img, frame_ceiling=frame_ceiling)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"FAST+NMS kernel (frame_ceiling={frame_ceiling}) "
                                     f"differs on {kind} B={b} {h}x{w}")
            err = max(err, float((got - want).abs().max()))
        got, want = fast_nms.fast_lo_max_cuda(img), fast_nms.fast_lo_max_reference(img)
        if not torch.equal(got, want):
            raise AssertionError(f"FAST max pass differs on {kind} B={b} {h}x{w}")
        return img, err, float((got - want).abs().max())

    def timed(img):
        """Per-kernel readings on one image batch: (score kernel, max pass)."""
        b, h, w = img.shape
        ops_score, ops_max, counts = fast_operations(img)
        ceiling = fast_nms.frame_lo_ceiling(fast_nms.fast_lo_max_cuda(img))
        recs = []
        for name, n_bytes, ops, launch_on, make, wrapper, plain in (
            ("fast_nms_score", 8 * img.numel() + 4 * b, ops_score,
             lambda x: fast_nms.launch_score(x[0], ceiling, x[1], 20.0, 7.0),
             lambda: (img.clone(), torch.empty_like(img)),
             lambda: fast_nms.fast_nms_score_cuda(img),
             lambda: fast_nms.fast_nms_score_reference(img)),
            ("fast_lo_max", 4 * img.numel() + 4 * b, ops_max,
             lambda x: fast_nms.launch_lo_max(x[0], x[1], 7.0),
             lambda: (img.clone(), torch.zeros(b, device=device)),
             lambda: fast_nms.fast_lo_max_cuda(img),
             lambda: fast_nms.fast_lo_max_reference(img)),
        ):
            warm, cold = device_times(launch_on, make, n_bytes)
            bound, by = bound_of(n_bytes, ops)
            rec = {"B": b, "H": h, "W": w, "device_ms": warm, "device_cold_ms": cold,
                   "enqueue_us": enqueue_us(wrapper), "ms": cuda_ms(wrapper),
                   "plain_ms": cuda_ms(plain, iters=10, warmup=2), "bytes": n_bytes,
                   "operations": ops, "bound_ms": bound, "bound_by": by, "counts": counts}
            recs.append(rec)
            print(f"{name} {h}x{w} B={b}: device {warm:.4f} ms (L2-warm), {cold:.4f} ms "
                  f"(cold), bound {bound:.4f} ms ({by}; {n_bytes / 1e6:.2f} MB, "
                  f"{ops / 1e6:.1f} M operations), share {bound / warm:.2f}; wrapper "
                  f"{rec['enqueue_us']:.1f} us/call, event mean {rec['ms']:.4f} ms, plain "
                  f"{rec['plain_ms']:.4f} ms")
        both = lambda: fast_nms.fast_nms_score_cuda(img, frame_ceiling=True)  # noqa: E731
        print(f"fast_nms_score(frame_ceiling=True) {h}x{w} B={b}: wrapper "
              f"{enqueue_us(both):.1f} us/call, event mean {cuda_ms(both):.4f} ms "
              f"(max pass, ceiling, score kernel); {counts}")
        return recs

    levels = ([], [])
    max_err = [0.0, 0.0]  # score kernel, max pass

    def checked(kind, b, h, w):
        img, *errs = check(kind, b, h, w)
        max_err[:] = [max(m, e) for m, e in zip(max_err, errs)]
        return img

    kinds = ("random", "edges", "uneven", "textured")
    for h, w, _ in level_cases():  # timed on the textured batch, the last one
        for kind in kinds:
            img = checked(kind, CHUNK, h, w)
        print(f"fast_nms {h}x{w} B={CHUNK}: both forms and the max pass bit-equal "
              f"({'/'.join(kinds)})")
        for lv, rec in zip(levels, timed(img)):
            lv.append(rec)
    for b in (1, 2):
        for kind in kinds:
            img = checked(kind, b, 480, 640)
        print(f"fast_nms 480x640 B={b}: both forms and the max pass bit-equal")
        for lv, rec in zip(levels, timed(img)):
            lv.append(rec)
    # the operation-bound end: noise, where every pixel is a corner candidate
    img = checked("random", CHUNK, 480, 640)
    for lv, rec in zip(levels, timed(img)):
        lv.append({**rec, "B": f"{CHUNK} (noise)"})
    small = [(3, 79, 97), (2, 64, 85), (1, 37, 45), (2, 7, 9), (1, 8, 8), (1, 9, 40),
             (1, 10, 33), (1, 12, 7), (1, 1, 1), (2, 130, 121), (1, 65, 241)]
    for b, h, w in small:
        for kind in kinds:
            checked(kind, b, h, w)
    print("fast_nms small levels " + ", ".join(f"{b}x{h}x{w}" for b, h, w in small)
          + ": bit-equal")
    return (kernel_record("fast_nms_score", "lpslam_tpu_torch/csrc/fast_nms.cu",
                          "lpslam_tpu/kernels/pallas_fast.py:111", max_err[0], levels[0]),
            kernel_record("fast_lo_max", "lpslam_tpu_torch/csrc/fast_nms.cu",
                          "lpslam_tpu/kernels/pallas_fast.py:111", max_err[1], levels[1]))


def _kernel_counters():
    from lpslam_tpu_torch.kernels import fast_nms, patch

    return fast_nms, patch


def reset_launches():
    fast_nms, patch = _kernel_counters()
    fast_nms.LAUNCHES = fast_nms.MAX_LAUNCHES = patch.LAUNCHES = 0


def read_launches() -> dict:
    fast_nms, patch = _kernel_counters()
    return {"fast_nms_score": fast_nms.LAUNCHES, "fast_lo_max": fast_nms.MAX_LAUNCHES,
            "extract_patches": patch.LAUNCHES}


def init_slice(device, mode: str = "mono", h: int = 480, w: int = 640,
               keypoints: int = KEYPOINTS, levels: int = LEVELS,
               max_keyframes: int = 128, max_landmarks: int = 24576,
               n_init: int = N_INIT, n_after: int = CHUNK * N_CHUNKS):
    """Render the room (n_init + n_after frames at the bench's per-frame
    motion rate; stereo adds the right eye, rgbd the depth maps), reset the
    kernels' launch counters, and initialize on the host path. mono
    undistorts with the radtan map, stereo rectifies both eyes with the
    port's rectify_maps_stereo, rgbd undistorts gray and depth with the same
    map. The depth modes run the fused FAST kernel (use_pallas=True).
    Returns a dict with the engine, a ChunkedTracker, `chunk_of(t, n)` (the
    raw chunk the loop takes), the mono uint8 frames, ground-truth centres,
    the next frame index and the launches made by initialization."""
    from lpslam_tpu_torch.frontend import (
        MonoTracker, RGBDTracker, StereoTracker, TrackerConfig, TrackerStatus,
    )
    from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
    from lpslam_tpu_torch.geometry import (
        PinholeCamera, rectify_maps_stereo, undistort_map_radtan,
    )
    from lpslam_tpu_torch.io import SyntheticBenchmark
    from lpslam_tpu_torch.kernels.orb import OrbParams
    from lpslam_tpu_torch.kernels.remap import remap_bilinear
    from lpslam_tpu_torch.mapstore import MapConfig

    total = n_init + n_after
    t0 = time.perf_counter()
    # bench.py's motion rate: turns = 1.08 * total / 556
    ds = SyntheticBenchmark(num_frames=total, h=h, w=w, seed=0,
                            stereo=mode == "stereo", with_depth=mode == "rgbd",
                            turns=1.08 * total / 556.0)
    rendered = list(ds)
    frames = np.stack([np.clip(f.image, 0, 255).astype(np.uint8) for f in rendered])
    intr = ds.intr
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
    print(f"rendered {total} {mode} frames {w}x{h} in {time.perf_counter() - t0:.1f} s")

    cfg = TrackerConfig(
        orb=OrbParams(num_keypoints=keypoints, num_levels=levels,
                      use_pallas=mode != "mono"),
        map_cfg=MapConfig(max_keyframes=max_keyframes, max_landmarks=max_landmarks,
                          num_keypoints=keypoints),
    )
    if mode == "stereo":
        right = np.stack([np.clip(f.image_right, 0, 255).astype(np.uint8) for f in rendered])
        R_rl, t_rl = stereo_rig(intr)
        rect = rectify_maps_stereo(K, intr["dist"], K, intr["dist"], R_rl, t_rl, (h, w))
        Kn = rect["K_new"]
        cam = PinholeCamera.make(Kn[0, 0], Kn[1, 1], Kn[0, 2], Kn[1, 2], device=device)
        engine = StereoTracker(cam, rect["focal_x_baseline"], cfg, device=device)
        rmap_np = np.stack([rect["map_l"], rect["map_r"]])
        second = right
        print(f"rectified: fx {Kn[0, 0]:.3f}, fx*b {rect['focal_x_baseline']:.4f}")
    else:
        rmap_np = undistort_map_radtan(K, intr["dist"], (h, w))
        cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device=device)
        if mode == "rgbd":
            engine = RGBDTracker(cam, cfg, max_depth=RGBD_MAX_DEPTH, device=device)
            second = np.stack([f.depth for f in rendered]).astype(np.float32)
        else:
            engine = MonoTracker(cam, cfg, device=device)
            second = None
    rmap = torch.from_numpy(rmap_np).to(device)

    def host_image(x, grid):
        return remap_bilinear(torch.from_numpy(x).to(device, torch.float32), grid)

    def chunk_of(t, n):
        if mode == "stereo":
            return np.stack([frames[t:t + n], second[t:t + n]], axis=1)
        if mode == "rgbd":
            return (frames[t:t + n], second[t:t + n])
        return frames[t:t + n]

    reset_launches()
    t = 0
    t_init = time.perf_counter()
    while engine.status != TrackerStatus.TRACKING and t < n_init:
        if mode == "stereo":
            engine.process(host_image(frames[t], rmap[0]),
                           aux=host_image(second[t], rmap[1]))
        elif mode == "rgbd":
            engine.process(host_image(frames[t], rmap), aux=host_image(second[t], rmap))
        else:
            engine.process(host_image(frames[t], rmap))
        t += 1
    if engine.status != TrackerStatus.TRACKING:
        raise AssertionError(f"{mode}: no initialization within {n_init} frames")
    print(f"{mode}: initialized after {t} frames in {time.perf_counter() - t_init:.1f} s, "
          f"{engine.n_landmarks} landmarks")
    return {
        "engine": engine,
        "ct": ChunkedTracker(engine, rectify_map=rmap_np),
        "chunk_of": chunk_of,
        "frames": frames,
        "gt": ds.ground_truth().positions,
        "t": t,
        "init_launches": read_launches(),
    }


def run_slice(device, mode: str = "mono", levels: int = LEVELS, chunk: int = CHUNK,
              n_chunks: int = N_CHUNKS, ate_bound: float = 0.10, **kw):
    """Initialize, then run n_chunks chunks through the chunk loop (each
    synchronized). The ATE is Sim3-aligned for mono and aligned without
    scale for the depth modes. Returns a dict of results; raises on a failed
    check."""
    from lpslam_tpu_torch.eval import ate_rmse
    from lpslam_tpu_torch.frontend import TrackerStatus

    n_init = N_INIT if mode == "mono" else DEPTH_N_INIT
    st = init_slice(device, mode=mode, levels=levels, n_init=n_init,
                    n_after=chunk * n_chunks, **kw)
    engine, ct, t = st["engine"], st["ct"], st["t"]
    t0_chunk = t
    chunk_ms = []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t_loop = time.perf_counter()
    for _ in range(n_chunks):
        tc = time.perf_counter()
        ct.process_chunk(st["chunk_of"](t, chunk))
        t += chunk
        sync()
        chunk_ms.append((time.perf_counter() - tc) * 1e3 / chunk)
    ct.sync()
    sync()
    loop_s = time.perf_counter() - t_loop
    launches = read_launches()
    loop_launches = {k: v - st["init_launches"][k] for k, v in launches.items()}

    sts, n_inl, pR, pt, kf_ins, _, _ = ct.collect()
    n_frames = chunk * n_chunks
    tracked = sts == int(TrackerStatus.TRACKING)
    centers = -np.einsum("bji,bj->bi", pR, pt)
    gt = st["gt"][t0_chunk:t0_chunk + n_frames]
    ate, _ = ate_rmse(centers[tracked], gt[tracked], with_scale=mode == "mono")
    kf_in_loop = int(kf_ins.sum())
    res = {
        "mode": mode,
        "frames": n_frames,
        "state": engine.status.name,
        "tracked_fraction": float(tracked.mean()),
        "keyframes_in_loop": kf_in_loop,
        "keyframes": engine.n_keyframes,
        "landmarks": engine.n_landmarks,
        "median_inliers": int(np.median(n_inl)),
        "ate_m": float(ate),
        "ate_aligned": "sim3" if mode == "mono" else "se3 (no scale)",
        "fps": n_frames / loop_s,
        "frame_ms_median": float(np.median(chunk_ms)),
        "chunk_frame_ms": [round(x, 3) for x in chunk_ms],
        "launches": launches,
        "launches_init": st["init_launches"],
    }
    checks = {
        "ends TRACKING": engine.status == TrackerStatus.TRACKING,
        "tracked >= 0.9": res["tracked_fraction"] >= 0.9,
        "poses finite": bool(np.isfinite(pR).all() and np.isfinite(pt).all()),
        ">= 2 keyframes in the chunk loop": kf_in_loop >= 2,
        f"ATE < {ate_bound:.4f} m": ate < ate_bound,
    }
    # one extraction per chunk (mono: the frames; depth: the left batch), and
    # for stereo one more per keyframe (its right eye); each runs the patch
    # and score kernels once per level, and mono (each frame's own ceiling)
    # the max pass before each score launch
    want = levels * (n_chunks + (kf_in_loop if mode == "stereo" else 0))
    want_all = {"extract_patches": want, "fast_nms_score": want,
                "fast_lo_max": want if mode == "mono" else 0}
    checks[f"the kernels on every extraction ({want_all})"] = loop_launches == want_all
    if mode == "mono":
        init = st["init_launches"]
        checks["the kernels on every host frame"] = (
            init["extract_patches"] == init["fast_nms_score"] == init["fast_lo_max"]
            == levels * t0_chunk)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{mode} slice checks failed: {failed}; {res}")
    return res


# tools/jax_loop_reference.py on the CPU with the frames and configuration
# of phases 7-8 (LOOP_FRAMES, LOOP_CONFIG, KIDNAP_FRAMES); sets their bounds.
# Its relocalization fails where its fp32 DLT PnP runs on raw coordinates
# far from the map origin (err_m then measures the blind prior); the port
# centres the points (frontend/relocalize.py)
JAX_LOOP_REF = {
    "frames": 740, "tracked": 737, "keyframes": 108,
    # accepted (k_new, candidate, n_inliers)
    "closures": [[98, 5, 69]],
    "ate_m_sim3": 0.42346514387465156,
    "relocalization": [
        {"frame": 280, "relocalized": False, "err_m": 388.66593447355353},
        {"frame": 350, "relocalized": False, "err_m": 389.2225998824441},
        {"frame": 420, "relocalized": False, "err_m": 390.12636556930073},
        {"frame": 490, "relocalized": True, "err_m": 0.24683415054122326},
    ],
}


def loop_ate_bound() -> float:
    ref = JAX_LOOP_REF["ate_m_sim3"]
    return max(1.5 * ref, ref + 0.02)


class _Timed:
    """Synchronized host-clock ms of each call of the wrapped functions,
    by key; undo() restores them."""

    def __init__(self, device):
        self.ms = {}
        self._undo = []
        self._sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def wrap(self, owner, name, key, after=None):
        orig = getattr(owner, name)

        def timed(*a, **kw):
            self._sync()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            self._sync()
            self.ms.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
            if after is not None:
                after(out)
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def undo(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    def summary(self) -> dict:
        return {k: {"n": len(v), "median_ms": float(np.median(v)), "max_ms": float(np.max(v))}
                for k, v in self.ms.items()}


def run_loop_room(device, raw, gt, K, grid, config=None):
    """Phase 7: the room through VSLAMTracker.process_image, then flush().
    Returns (result dict, tracker); raises on a failed check."""
    from lpslam_tpu_torch.backend import ba
    from lpslam_tpu_torch.frontend import TrackerStatus
    from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
    from lpslam_tpu_torch.geometry import PinholeCamera
    from lpslam_tpu_torch.kernels.remap import remap_bilinear
    from lpslam_tpu_torch.loop import detector
    from lpslam_tpu_torch.pipeline import CameraQueueEntry, VSLAMTracker

    config = dict(LOOP_CONFIG if config is None else config)
    grid_d = torch.from_numpy(grid).to(device)

    def rectified(t):
        return remap_bilinear(torch.from_numpy(raw[t]).to(device, torch.float32), grid_d)

    def finite(out):
        m = out[0]
        if not (torch.isfinite(m.kf_t).all() and torch.isfinite(m.lm_pos).all()):
            raise AssertionError("non-finite poses or landmarks after a loop correction")

    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device=device)
    tracker = VSLAMTracker(cam, config, device=device)
    tracker.attach_device_rectify(grid)
    timed = _Timed(device)
    timed.wrap(detector.LoopCloser, "add_keyframe", "bow_add")
    timed.wrap(detector.LoopCloser, "detect", "bow_detect")
    timed.wrap(detector.LoopCloser, "verify", "verify")
    timed.wrap(detector, "correct_loop", "correct_loop")
    timed.wrap(ba, "global_ba", "global_ba")
    timed.wrap(detector.LoopCloser, "apply", "apply", after=finite)
    timed.wrap(ChunkedTracker, "process_chunk", "chunk")
    timed.wrap(VSLAMTracker, "_process_host", "host_frame")
    verdicts, undo = record_closures(detector.LoopCloser)
    reset_launches()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    try:
        fed = drive_room(tracker, TrackerStatus.TRACKING, CameraQueueEntry, raw, rectified)
        sync()
    finally:
        undo()
        timed.undo()
    loop_s = time.perf_counter() - t0
    launches = read_launches()
    eng = tracker.engine
    met = room_metrics(eng, gt)
    times = timed.summary()
    extractions = sum(times.get(k, {"n": 0})["n"] for k in ("chunk", "host_frame"))
    lc = tracker.loop_closer
    closures = [v[:2] + v[3:4] for v in verdicts if v[4]]
    res = {
        "frames": fed,
        "tracked": met["tracked"],
        "tracked_fraction": met["tracked"] / fed,
        "keyframes": eng.n_keyframes,
        "landmarks": eng.n_landmarks,
        "closures": closures,
        "verdicts_named_candidate": len(verdicts),
        "ate_m_sim3": met["ate_m"],
        "err_by_100_frames": met["err_by_100_frames"],
        "state": eng.status.name,
        "fps": fed / loop_s,
        "loop_seconds": loop_s,
        "times": times,
        "bow_db_bytes": lc.db.numel() * lc.db.element_size(),
        "vocab_bytes": sum(x.numel() * x.element_size() for x in lc.vocab),
        "launches": launches,
        "extractions": extractions,
    }
    checks = {
        "ends TRACKING": eng.status == TrackerStatus.TRACKING,
        "tracked >= 0.9": res["tracked_fraction"] >= 0.9,
        "finite map": bool(torch.isfinite(eng.map.kf_t).all() and torch.isfinite(eng.map.lm_pos).all()),
        "the three kernels on every extraction": all(
            n == LEVELS * extractions for n in launches.values()),
    }
    if JAX_LOOP_REF is not None:
        n_ref = len(JAX_LOOP_REF["closures"])
        checks[f"closures {len(closures)} within 1 of JAX's {n_ref}, >= 1"] = (
            len(closures) >= 1 and abs(len(closures) - n_ref) <= 1)
        checks[f"ATE <= {loop_ate_bound():.4f} m"] = met["ate_m"] <= loop_ate_bound()
    res["checks_failed"] = [k for k, ok in checks.items() if not ok]
    return res, tracker, met["align"], rectified


def run_kidnap(device, tracker, gt, align, rectified, frames=KIDNAP_FRAMES):
    """Phase 8: kidnapped relocalization on the phase-7 map."""
    from lpslam_tpu_torch.frontend import TrackerStatus
    from lpslam_tpu_torch.geometry import SE3
    from lpslam_tpu_torch.pipeline import CameraQueueEntry

    far = torch.tensor([0.0, 0.0, -1e4], device=device)
    reset_launches()
    t0 = time.perf_counter()
    out = kidnap(tracker, TrackerStatus.LOST, CameraQueueEntry, rectified, gt, align,
                 lambda x: x.detach().cpu().numpy(), lambda pose: SE3(pose.R, far), frames)
    seconds = time.perf_counter() - t0
    n_ok = sum(r["relocalized"] for r in out)
    bound = loop_ate_bound() if JAX_LOOP_REF is not None else float("inf")
    res = {"relocalization": out, "relocalized": n_ok, "seconds": seconds,
           "launches": read_launches()}
    checks = {
        ">= 3 of 4 relocalized": n_ok >= 0.75 * len(out),
        f"each relocalized centre within {bound:.4f} m": all(
            r["err_m"] <= bound for r in out if r["relocalized"]),
        "the three kernels on every extraction": all(
            n == LEVELS * len(out) for n in res["launches"].values()),
    }
    if JAX_LOOP_REF is not None:
        n_ref = sum(r["relocalized"] for r in JAX_LOOP_REF["relocalization"])
        checks[f"no fewer than JAX's {n_ref}"] = n_ok >= n_ref
    res["checks_failed"] = [k for k, ok in checks.items() if not ok]
    return res


# phases 9-11: the entry points users start the system with, at the
# operating point. tools/jax_pipeline_reference.py runs the JAX package on
# the CPU with the same configurations and prints JAX_PIPELINE_REF.
PIPE_FRAMES = 64
PIPE_FPS = 20.0
PIPE_SIZE = (480, 640)
PIPE_TRACKER = {
    "mode": "mono", "keypoints": KEYPOINTS, "levels": LEVELS,
    "max_keyframes": 128, "max_landmarks": 24576, "chunk_size": CHUNK,
    "loop_closure": True, "mask_radius": 380.0, "emit_map_seconds": 1.0,
}
# pushes wait while the camera queue holds this many frames (phase 10)
PIPE_QUEUE_HIGH = 32
# the room's design length: 1.08 turns in 600 frames, so the camera comes
# back to the first frames' view and a loop can close
ROOM_ARGS = ["--bench", "room", "--mode", "stereo", "--frames", "600", "--loop",
             "--chunk", "16"]
# tools/jax_pipeline_reference.py on the CPU (the JAX package, rendering
# every frame with its own renderers, which the port's copy)
JAX_PIPELINE_REF = {
    "cli": {"frames": 64, "tracked": 61, "first_valid": 3, "keyframes": 10,
            "landmarks": 1802, "ate_m_sim3": 0.0066444975656311436},
    "localize": {"frames": 64, "tracked": 64, "first_valid": 0, "keyframes": 10,
                 "ate_m_sim3": 0.002649098430343324},
    "room": {"frames": 600, "tracked": 600, "keyframes": 103, "landmarks": 14288,
             "ate_rmse": 0.0585,
             # accepted (k_new, candidate, n_inliers)
             "closures": [[95, 0, 58], [98, 2, 126], [101, 5, 249]]},
}


def pipeline_sequence():
    """The synthetic source's sequence for phases 9-10 (the source renders
    the same one from its seed): images and ground-truth centres."""
    from lpslam_tpu_torch.io.synthetic import make_sequence

    seq = make_sequence(num_frames=PIPE_FRAMES, h=PIPE_SIZE[0], w=PIPE_SIZE[1], seed=0)
    return seq.images, np.stack([np.asarray(p.t, np.float64) for p in seq.poses_wc]), seq.K


def pipeline_config(K, map_file: str, localize: bool = False) -> dict:
    """The JSON config of phase 9 (the synthetic source feeds it), or of
    phase 10 (no source: frames come from buffers; mapping off, no map
    emission)."""
    tracker = dict(PIPE_TRACKER, map_file=map_file)
    if localize:
        tracker.update(mapping=False, emit_map_seconds=0.0)
    return {
        "manager": {"record": False},
        "datasources": [] if localize else [{"type": "Synthetic", "configuration": {
            "num_frames": PIPE_FRAMES, "width": PIPE_SIZE[1], "height": PIPE_SIZE[0], "seed": 0,
            "fps": PIPE_FPS}}],
        "cameras": [{"number": 0, "model": "no_distortion", "fx": float(K[0, 0]),
                     "fy": float(K[1, 1]), "cx": float(K[0, 2]), "cy": float(K[1, 2]),
                     "resolution": [PIPE_SIZE[1], PIPE_SIZE[0]], "fps": PIPE_FPS}],
        "processors": [],
        "trackers": [{"type": "VSLAM", "configuration": tracker}],
    }


def trajectory_metrics(stamped, gt, n_frames: int, ate_rmse=None) -> dict:
    """stamped: [(timestamp, lpslam-frame position)] of valid results.
    Frames after the first valid one, tracked, and the Sim3 ATE against
    the ground-truth centres (the alignment absorbs the frame swap);
    `ate_rmse` defaults to the port's."""
    if ate_rmse is None:
        from lpslam_tpu_torch.eval.ate import ate_rmse

    idx = np.array([int(round(ts * PIPE_FPS)) for ts, _ in stamped])
    est = np.array([p for _, p in stamped], np.float64)
    first = int(idx.min()) if len(idx) else n_frames
    return {"tracked": len(idx), "first_valid": first, "after": n_frames - first,
            "ate_m_sim3": ate_rmse(est, gt[idx])[0] if len(idx) > 3 else float("inf")}


def feed_localization(push, qsize, images):
    """Phase 10's frames: uint8, every second one as 3-channel BGR; a push
    waits while the camera queue holds PIPE_QUEUE_HIGH frames."""
    for t, img in enumerate(images):
        u8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
        buf = np.repeat(u8[..., None], 3, axis=2) if t % 2 else u8
        while qsize() >= PIPE_QUEUE_HIGH:
            time.sleep(0.005)
        if not push(t / PIPE_FPS, buf):
            raise AssertionError(f"frame {t} refused")


def pipe_bound(key: str) -> float:
    ref = JAX_PIPELINE_REF[key]["ate_m_sim3" if key != "room" else "ate_rmse"]
    return max(1.5 * ref, ref + 0.02)


def run_cli_phase(device, images, gt, K, tmp):
    """Phase 9. Returns (result dict, map file)."""
    from lpslam_tpu_torch.pipeline import VSLAMTracker, cli

    map_file = os.path.join(tmp, "map.npz")
    cfg_path = os.path.join(tmp, "phase9.json")
    with open(cfg_path, "w") as f:
        json.dump(pipeline_config(K, map_file), f)
    traj, csv = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "map.csv")
    timed = _Timed(device)
    timed.wrap(VSLAMTracker, "_process_host", "host_frame")
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--config", cfg_path, "--export-trajectory", traj,
                           "--export-map-csv", csv])
    finally:
        timed.undo()
    wall = time.perf_counter() - t0
    launches = read_launches()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    stamped = []
    with open(traj) as f:
        for row in f:
            v = [float(x) for x in row.split()]
            stamped.append((v[0], v[1:4]))
    met = trajectory_metrics(stamped, gt, PIPE_FRAMES)
    with open(csv) as f:
        n_rows = len(f.read().strip().splitlines()) - 1
    host = timed.summary().get("host_frame", {"n": 0, "median_ms": float("nan")})
    res = {"cli": line, "rc": rc, **met, "csv_rows": n_rows, "wall_s": wall,
           "host_frames": host["n"], "host_frame_ms_median": host["median_ms"],
           "fps_host_path": 1e3 / host["median_ms"] if host["n"] else 0.0,
           "launches": launches, "map_file_bytes": os.path.getsize(map_file)
           if os.path.exists(map_file) else 0}
    checks = {
        "rc 0, no worker error": rc == 0 and line["error"] == "",
        f"{PIPE_FRAMES} frames processed (none dropped)": line["frames"] == PIPE_FRAMES,
        ">= 0.9 of the frames after init tracked": met["tracked"] >= 0.9 * met["after"],
        "map file written": res["map_file_bytes"] > 0,
        "one CSV row per landmark": n_rows == line["landmarks"] > 0,
        "the three kernels launched": all(n > 0 for n in launches.values()),
    }
    if JAX_PIPELINE_REF is not None:
        checks[f"ATE <= {pipe_bound('cli'):.4f} m"] = met["ate_m_sim3"] <= pipe_bound("cli")
    res["checks_failed"] = [k for k, ok in checks.items() if not ok]
    return res, map_file


def run_localize_phase(device, images, gt, K, tmp, map_file):
    """Phase 10."""
    from lpslam_tpu_torch.interface import LpSlamManager

    cfg_path = os.path.join(tmp, "phase10.json")
    with open(cfg_path, "w") as f:
        json.dump(pipeline_config(K, map_file, localize=True), f)
    reset_launches()
    t0 = time.perf_counter()
    lm = LpSlamManager()
    ok_cfg = lm.read_configuration_file(cfg_path)
    if not ok_cfg:
        return {"checks_failed": ["read_configuration_file"]}
    tracker = lm._m.trackers[0]
    n_kf_loaded = tracker.engine.n_keyframes
    results = []
    lm.set_reconstruction_callback(results.append)
    lm.start()
    t1 = time.perf_counter()
    feed_localization(lm.add_image_from_buffer, lm._m.camera_queue.qsize, images)
    lm.mapping_add_laser_scan(PIPE_FRAMES / PIPE_FPS, np.linspace(1.0, 4.0, 181),
                              -np.pi / 2, np.pi / 180, 8.0)
    while not lm._m.camera_queue.empty():
        time.sleep(0.01)
    lm.stop()
    feed_s = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = lm.get_slam_status()
    stamped = [(r.timestamp, r.position) for r in results if r.valid]
    met = trajectory_metrics(stamped, gt, PIPE_FRAMES)
    grid = lm.mapping_get_map_raw()["grid"]
    res = {"status": {k: getattr(st, k) for k in ("localization", "keyframes", "landmarks",
                                                  "frames_processed", "error")},
           "keyframes_loaded": n_kf_loaded, **met, "results": len(results),
           "features": lm.mapping_get_features_count(),
           "occupied_cells": int((grid == 100).sum()), "fps": PIPE_FRAMES / feed_s,
           "wall_s": wall, "launches": launches}
    checks = {
        "no worker error": st.error == "",
        f"{PIPE_FRAMES} frames processed": st.frames_processed == PIPE_FRAMES,
        "keyframes stay the loaded map's": st.keyframes == n_kf_loaded > 0,
        "relocalized, then >= 0.9 of the frames after tracked":
            met["tracked"] > 0 and met["tracked"] >= 0.9 * met["after"],
        "one feature per landmark": res["features"] == st.landmarks > 0,
        "occupied cells": res["occupied_cells"] > 0,
        "the three kernels launched": all(n > 0 for n in launches.values()),
    }
    if JAX_PIPELINE_REF is not None:
        checks[f"ATE <= {pipe_bound('localize'):.4f} m"] = (
            met["ate_m_sim3"] <= pipe_bound("localize"))
    res["checks_failed"] = [k for k, ok in checks.items() if not ok]
    return res


def run_dataset_phase(tmp):
    """Phase 11."""
    from lpslam_tpu_torch.eval import run_dataset
    from lpslam_tpu_torch.loop.detector import LoopCloser

    out_path = os.path.join(tmp, "room.json")
    out = io.StringIO()
    verdicts, undo = record_closures(LoopCloser)
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = run_dataset.main(ROOM_ARGS + ["--json-out", out_path])
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = read_launches()
    with open(out_path) as f:
        line = json.loads(f.read())
    closures = [[v[0], v[1], v[3]] for v in verdicts if v[4]]
    res = {**line, "closures": closures, "rc": rc, "wall_s": wall, "launches": launches}
    checks = {
        "rc 0": rc == 0,
        ">= 0.9 tracked": line["tracked"] >= 0.9 * line["frames"],
        ">= 1 closure accepted": len(closures) >= 1,
        "the three kernels launched": all(n > 0 for n in launches.values()),
    }
    if JAX_PIPELINE_REF is not None:
        ref = JAX_PIPELINE_REF["room"]
        checks[f"ATE <= {pipe_bound('room'):.4f} m"] = line["ate_rmse"] <= pipe_bound("room")
        checks[f"closures within 1 of JAX's {len(ref['closures'])}"] = (
            abs(len(closures) - len(ref["closures"])) <= 1)
    res["checks_failed"] = [k for k, ok in checks.items() if not ok]
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)
    from lpslam_tpu_torch import _cuda

    device = torch.device("cuda")
    t_all = time.perf_counter()
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")

    t0 = time.perf_counter()
    sources = ["patch.cu", "fast_nms.cu"]
    _cuda.load_libraries(sources)
    print(f"phase 2: built {', '.join(sources)} with parallel nvcc in "
          f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    records = {"extract_patches": check_patch_kernel(device)}
    print(f"phase 3: patch kernel checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records["fast_nms_score"], records["fast_lo_max"] = check_fast_kernel(device)
    print(f"phase 3b: FAST+NMS kernels checked in {time.perf_counter() - t0:.1f} s")

    paths = [("4", "mono", dict()),
             ("5", "stereo", dict(n_chunks=STEREO_CHUNKS, ate_bound=ate_bound("stereo"))),
             ("6", "rgbd", dict(n_chunks=RGBD_CHUNKS, ate_bound=ate_bound("rgbd")))]
    for phase, mode, kw in paths:
        t0 = time.perf_counter()
        res = run_slice(device, mode=mode, **kw)
        for name, n in res["launches"].items():
            records[name]["launches"] += n
        print(f"{mode}: " + json.dumps(res))
        print(f"phase {phase}: {mode} slice {res['fps']:.2f} frames/s over the "
              f"synchronized chunk loop, median {res['frame_ms_median']:.2f} ms/frame, "
              f"{res['keyframes']} keyframes, {res['landmarks']} landmarks, ATE "
              f"{res['ate_m']:.4f} m ({res['ate_aligned']}), launches {res['launches']}, "
              f"{time.perf_counter() - t0:.1f} s, on {card}")

    t0 = time.perf_counter()
    raw, gt, K, grid = render_room()
    print(f"rendered the {len(raw)}-frame room in {time.perf_counter() - t0:.1f} s")
    # phases 7 (twice: global BA's index_add_ atomics may reorder sums) and 8
    # all run before a failed check raises, so one call shows the spread
    failed = []
    for run in (1, 2):
        t0 = time.perf_counter()
        res, tracker, align, rectified = run_loop_room(device, raw, gt, K, grid)
        for name, n in res["launches"].items():
            records[name]["launches"] += n
        print(f"loop room run {run}: " + json.dumps(res))
        failed += [f"phase 7 run {run}: {c}" for c in res["checks_failed"]]
        t = res["times"]
        print(f"phase 7 run {run}: {res['frames']} frames, {res['tracked']} tracked, "
              f"closures {res['closures']} (JAX CPU {JAX_LOOP_REF['closures']}), ATE "
              f"{res['ate_m_sim3']:.4f} m Sim3 (bound {loop_ate_bound():.4f}), "
              f"{res['fps']:.2f} frames/s; median ms: BoW add "
              f"{t['bow_add']['median_ms']:.2f}, detect {t['bow_detect']['median_ms']:.2f}, "
              f"verify {t['verify']['median_ms']:.2f}, correct_loop "
              f"{t.get('correct_loop', {}).get('median_ms', float('nan')):.2f}, global_ba "
              f"{t.get('global_ba', {}).get('median_ms', float('nan')):.2f}; BoW db "
              f"{res['bow_db_bytes']} B, vocabulary {res['vocab_bytes']} B; "
              f"{time.perf_counter() - t0:.1f} s, on {card}")
    t0 = time.perf_counter()
    res = run_kidnap(device, tracker, gt, align, rectified)
    for name, n in res["launches"].items():
        records[name]["launches"] += n
    print("kidnap: " + json.dumps(res))
    failed += [f"phase 8: {c}" for c in res["checks_failed"]]
    print(f"phase 8: {res['relocalized']}/{len(res['relocalization'])} kidnapped frames "
          f"relocalized (JAX CPU "
          f"{sum(r['relocalized'] for r in JAX_LOOP_REF['relocalization'])}), errors "
          f"{[round(r['err_m'], 4) for r in res['relocalization']]} m, "
          f"{time.perf_counter() - t0:.1f} s, on {card}")

    t0 = time.perf_counter()
    images, gt_pipe, K_pipe = pipeline_sequence()
    print(f"rendered the {len(images)}-frame synthetic sequence in "
          f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        res, map_file = run_cli_phase(device, images, gt_pipe, K_pipe, tmp)
        for name, n in res["launches"].items():
            records[name]["launches"] += n
        print("cli: " + json.dumps(res))
        failed += [f"phase 9: {c}" for c in res["checks_failed"]]
        ref = JAX_PIPELINE_REF["cli"] if JAX_PIPELINE_REF else {}
        print(f"phase 9: CLI {res['cli']['frames']} frames, {res['tracked']} tracked of "
              f"{res['after']} after init (JAX CPU {ref.get('tracked')}), ATE "
              f"{res['ate_m_sim3']:.4f} m Sim3 (JAX CPU {ref.get('ate_m_sim3')}), "
              f"{res['cli']['keyframes']} keyframes, {res['cli']['landmarks']} landmarks; "
              f"nav-prior host path {res['fps_host_path']:.2f} frames/s (median "
              f"{res['host_frame_ms_median']:.2f} ms over {res['host_frames']} frames, "
              f"synchronized), wall {res['wall_s']:.1f} s; launches {res['launches']}; "
              f"on {card}")
        res = run_localize_phase(device, images, gt_pipe, K_pipe, tmp, map_file)
        for name, n in res.get("launches", {}).items():
            records[name]["launches"] += n
        print("localize: " + json.dumps(res))
        failed += [f"phase 10: {c}" for c in res["checks_failed"]]
        if "status" in res:
            print(f"phase 10: LpSlamManager relocalized at frame {res['first_valid']}, "
                  f"{res['tracked']} tracked of {res['after']} after, ATE "
                  f"{res['ate_m_sim3']:.4f} m Sim3 (JAX CPU "
                  f"{JAX_PIPELINE_REF['localize']['ate_m_sim3']}), keyframes "
                  f"{res['status']['keyframes']} (loaded {res['keyframes_loaded']}), "
                  f"{res['fps']:.2f} frames/s pushed and processed, wall "
                  f"{res['wall_s']:.1f} s; launches {res['launches']}; on {card}")
        res = run_dataset_phase(tmp)
    for name, n in res["launches"].items():
        records[name]["launches"] += n
    print("run_dataset: " + json.dumps(res))
    failed += [f"phase 11: {c}" for c in res["checks_failed"]]
    ref = JAX_PIPELINE_REF["room"] if JAX_PIPELINE_REF else {}
    print(f"phase 11: run_dataset stereo room {res['frames']} frames, {res['tracked']} "
          f"tracked (JAX CPU {ref.get('tracked')}), closures {res['closures']} (JAX CPU "
          f"{ref.get('closures')}), ATE {res['ate_rmse']} m (JAX CPU "
          f"{ref.get('ate_rmse')}), {res['fps']} frames/s with rendering "
          f"({res['read_ms_per_frame']} ms per frame of it), "
          f"RectifyProcessor {res['rectify_ms_per_frame']} ms per stereo pair (host "
          f"clock: upload, two remaps, read-back), wall {res['wall_s']:.1f} s; launches "
          f"{res['launches']}; on {card}")
    if failed:
        raise AssertionError(f"checks failed: {failed}")
    print(f"all phases: {time.perf_counter() - t_all:.1f} s")

    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
