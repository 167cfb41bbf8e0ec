"""Drive the PyTorch/CUDA port's main paths once on an NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero and prints no result):
1. require a CUDA card; print `nvidia-smi`'s name and power limit;
2. build the hand-written CUDA kernels from csrc/, one nvcc per source, all
   started together (timed);
3. the patch kernel, 3b. the FAST+NMS kernel, each against its plain
   PyTorch version on the card, at the shapes the main paths give it plus
   border, tail and small-level cases; must be bit-equal; mean times of both
   over CUDA events after warm-up;
4. the monocular slice at the reference operating point (640x480 ray-cast
   room with lens distortion, 1200 keypoints, 3 levels, composite FAST,
   chunks of 16): host initialization, then 6 chunks through ChunkedTracker;
5. the stereo slice at the same width (the room's right eye 0.11 m to the
   right, rectified with rectify_maps_stereo, fused FAST kernel): host
   initialization, then 4 chunks of (16, 2, 480, 640) eye pairs;
6. the RGB-D slice (depth maps undistorted with the gray images, fused FAST
   kernel): host initialization, then 3 chunks.
Each path resets the kernels' launch counters just before its
initialization and reads them just after its loop. Checks per path: ends
TRACKING, >= 90% frames tracked, finite poses, >= 2 keyframes inserted in
the chunk loop, the kernels launched on every extraction, and ATE under a
bound: Sim3-aligned < 0.10 m for mono; aligned without scale (depth fixes
the scale) under max(1.5 x, + 0.02 m) of the JAX package's CPU run on the
same frames for stereo and RGB-D (JAX_CPU_ATE).

The line before the last is the per-kernel JSON record (launches summed
over the paths); the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
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


def level_cases():
    """(H, W, N) per pyramid level at the operating point."""
    from lpslam_tpu_torch.kernels.orb import _level_budgets
    from lpslam_tpu_torch.kernels.pyramid import pyramid_shapes

    shapes = pyramid_shapes(480, 640, LEVELS, 1.2)
    ks = _level_budgets(KEYPOINTS, LEVELS, 1.2)
    return [(h, w, k) for (h, w), k in zip(shapes, ks)]


def check_patch_kernel(device, seed: int = 0):
    """Kernel vs plain version at B = CHUNK for every level, plus border and
    tail cases. Returns the kernel record (launch count filled in later)."""
    from lpslam_tpu_torch.kernels import patch

    rng = np.random.default_rng(seed)
    ms_k = ms_p = 0.0
    max_err = 0.0
    for h, w, n in level_cases():
        img = torch.from_numpy(
            (rng.random((CHUNK, h, w)) * 255).astype(np.float32)
        ).to(device)
        xy = rng.uniform(0, [w, h], (CHUNK, n, 2)).astype(np.float32)
        # border clamps, exact .5 centres, out-of-image keypoints
        xy[:, :6] = [[0, 0], [w - 1, h - 1], [16, 16], [w - 17, h - 17],
                     [20.5, 21.5], [-3, h + 50]]
        xy = torch.from_numpy(xy).to(device)
        got = patch.extract_patches_cuda(img, xy)
        want = patch.extract_patches_reference(img, xy)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"patch kernel differs at level {h}x{w}")
        max_err = max(max_err, float((got - want).abs().max()))
        tk = cuda_ms(lambda: patch.extract_patches_cuda(img, xy))
        tp = cuda_ms(lambda: patch.extract_patches_reference(img, xy))
        ms_k += tk
        ms_p += tp
        print(f"patch {h}x{w} B={CHUNK} N={n}: bit-equal, kernel {tk:.4f} ms, "
              f"plain {tp:.4f} ms")
    # tail: a keypoint count no block size divides, one frame
    img = torch.from_numpy((rng.random((1, 37, 45)) * 255).astype(np.float32)).to(device)
    xy = torch.from_numpy(rng.uniform(-5, 50, (1, 13, 2)).astype(np.float32)).to(device)
    if not torch.equal(patch.extract_patches_cuda(img, xy),
                       patch.extract_patches_reference(img, xy)):
        raise AssertionError("patch kernel differs on the tail case")
    print("patch tail case 37x45 N=13: bit-equal")
    return {
        "name": "extract_patches",
        "route": "cuda",
        "source": "lpslam_tpu_torch/csrc/patch.cu",
        "replaces": "lpslam_tpu/kernels/pallas_patch.py:64",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }


def check_fast_kernel(device, seed: int = 1):
    """FAST+NMS kernel vs plain version: B = CHUNK at every level and B = 2
    (the two-eye host batch) at level 0, on random, textured and edge-heavy
    images; then levels under 80 rows, an odd 37x45, and levels a few pixels
    over the 7 rows FAST needs, with extreme one-pixel corners on the
    3-pixel border where the plain version's shifts wrap around. Returns the
    kernel record (launch count filled in later)."""
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
        return x

    def check(kind, b, h, w):
        img = torch.from_numpy(image(kind, b, h, w)).to(device)
        got = fast_nms.fast_nms_score_cuda(img)
        want = fast_nms.fast_nms_score_reference(img)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"FAST+NMS kernel differs on {kind} B={b} {h}x{w}")
        return img, float((got - want).abs().max()), int((want > 0).sum())

    ms_k = ms_p = 0.0
    max_err = 0.0
    for h, w, _ in level_cases():  # timed on the textured batch
        for kind in ("random", "edges", "textured"):
            img, err, _ = check(kind, CHUNK, h, w)
            max_err = max(max_err, err)
        tk = cuda_ms(lambda: fast_nms.fast_nms_score_cuda(img))
        tp = cuda_ms(lambda: fast_nms.fast_nms_score_reference(img))
        ms_k += tk
        ms_p += tp
        print(f"fast_nms {h}x{w} B={CHUNK}: bit-equal (random/textured/edges), "
              f"kernel {tk:.4f} ms, plain {tp:.4f} ms")
    img, err, _ = check("textured", 2, 480, 640)
    tk = cuda_ms(lambda: fast_nms.fast_nms_score_cuda(img))
    tp = cuda_ms(lambda: fast_nms.fast_nms_score_reference(img))
    print(f"fast_nms 480x640 B=2: bit-equal, kernel {tk:.4f} ms, plain {tp:.4f} ms")
    small = [(3, 79, 97), (2, 64, 85), (1, 37, 45), (2, 7, 9), (1, 8, 8), (1, 9, 40),
             (1, 10, 33), (1, 12, 7), (1, 1, 1)]
    for b, h, w in small:
        for kind in ("random", "textured", "edges"):
            max_err = max(max_err, check(kind, b, h, w)[1])
    print("fast_nms small levels " + ", ".join(f"{b}x{h}x{w}" for b, h, w in small)
          + ": bit-equal")
    return {
        "name": "fast_nms_score",
        "route": "cuda",
        "source": "lpslam_tpu_torch/csrc/fast_nms.cu",
        "replaces": "lpslam_tpu/kernels/pallas_fast.py:111",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }


def _kernel_counters():
    from lpslam_tpu_torch.kernels import fast_nms, patch

    return fast_nms, patch


def reset_launches():
    for k in _kernel_counters():
        k.LAUNCHES = 0


def read_launches() -> dict:
    fast_nms, patch = _kernel_counters()
    return {"fast_nms_score": fast_nms.LAUNCHES, "extract_patches": patch.LAUNCHES}


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
    if mode == "mono":
        checks["patch kernel on every extraction"] = (
            loop_launches["extract_patches"] >= n_chunks * levels)
    else:
        # one extraction per chunk (the left batch), and for stereo one more
        # per keyframe (its right eye); each runs both kernels once per level
        want = levels * (n_chunks + (kf_in_loop if mode == "stereo" else 0))
        checks[f"both kernels on every extraction ({want} launches each)"] = (
            loop_launches["fast_nms_score"] == want
            and loop_launches["extract_patches"] == want)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{mode} slice checks failed: {failed}; {res}")
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
    records["fast_nms_score"] = check_fast_kernel(device)
    print(f"phase 3b: FAST+NMS kernel checked in {time.perf_counter() - t0:.1f} s")

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
