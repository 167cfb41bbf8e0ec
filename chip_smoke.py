"""Drive the PyTorch/CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero and prints no result):
1. require a CUDA card; print `nvidia-smi`'s name and power limit;
2. build the hand-written CUDA kernels from csrc/ with nvcc (timed);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it plus border and tail cases; must be bit-equal;
   mean times of both over CUDA events after warm-up;
4. the monocular slice at the reference operating point (640x480 ray-cast
   room with lens distortion, 1200 keypoints, 3 levels, chunks of 16): host
   initialization, then 6 chunks through ChunkedTracker on the card, with
   the kernels' launch counters reset just before and read just after.
   Checks: ends TRACKING, >= 90% frames tracked, finite poses, >= 2
   keyframes inserted in the chunk loop, the patch kernel launched for every
   extraction, Sim3 ATE < 0.10 m against ground truth.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}.
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


def init_slice(device, h: int = 480, w: int = 640, keypoints: int = KEYPOINTS,
               levels: int = LEVELS, max_keyframes: int = 128,
               max_landmarks: int = 24576, n_init: int = N_INIT,
               n_after: int = CHUNK * N_CHUNKS):
    """Render the room (n_init + n_after frames at the bench's per-frame
    motion rate), initialize on the host path with the patch launch counter
    reset first. Returns a dict with the engine, a ChunkedTracker, the uint8
    frames, ground-truth centres and the next frame index."""
    from lpslam_tpu_torch.frontend import MonoTracker, TrackerConfig, TrackerStatus
    from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
    from lpslam_tpu_torch.geometry import PinholeCamera, undistort_map_radtan
    from lpslam_tpu_torch.io import SyntheticBenchmark
    from lpslam_tpu_torch.kernels import patch
    from lpslam_tpu_torch.kernels.orb import OrbParams
    from lpslam_tpu_torch.kernels.remap import remap_bilinear
    from lpslam_tpu_torch.mapstore import MapConfig

    total = n_init + n_after
    t0 = time.perf_counter()
    # bench.py's motion rate: turns = 1.08 * total / 556
    ds = SyntheticBenchmark(num_frames=total, h=h, w=w, seed=0,
                            turns=1.08 * total / 556.0)
    frames = np.stack([np.clip(f.image, 0, 255).astype(np.uint8) for f in ds])
    intr = ds.intr
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
    rmap_np = undistort_map_radtan(K, intr["dist"], (h, w))
    print(f"rendered {total} frames {w}x{h} in {time.perf_counter() - t0:.1f} s")

    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device=device)
    cfg = TrackerConfig(
        orb=OrbParams(num_keypoints=keypoints, num_levels=levels),
        map_cfg=MapConfig(max_keyframes=max_keyframes, max_landmarks=max_landmarks,
                          num_keypoints=keypoints),
    )
    rmap = torch.from_numpy(rmap_np).to(device)
    engine = MonoTracker(cam, cfg, device=device)

    patch.LAUNCHES = 0
    t = 0
    t_init = time.perf_counter()
    while engine.status != TrackerStatus.TRACKING and t < n_init:
        raw = torch.from_numpy(frames[t]).to(device, torch.float32)
        engine.process(remap_bilinear(raw, rmap))
        t += 1
    if engine.status != TrackerStatus.TRACKING:
        raise AssertionError(f"no initialization within {n_init} frames")
    print(f"initialized after {t} frames in {time.perf_counter() - t_init:.1f} s, "
          f"{engine.n_landmarks} landmarks")
    return {
        "engine": engine,
        "ct": ChunkedTracker(engine, rectify_map=rmap_np),
        "frames": frames,
        "gt": ds.ground_truth().positions,
        "t": t,
        "init_launches": patch.LAUNCHES,
    }


def run_slice(device, levels: int = LEVELS, chunk: int = CHUNK,
              n_chunks: int = N_CHUNKS, **kw):
    """Initialize, then run n_chunks chunks through the chunk loop (each
    synchronized). Returns a dict of results; raises on a failed check."""
    from lpslam_tpu_torch.eval import ate_rmse
    from lpslam_tpu_torch.frontend import TrackerStatus
    from lpslam_tpu_torch.kernels import patch

    st = init_slice(device, levels=levels, n_after=chunk * n_chunks, **kw)
    engine, ct, frames, t = st["engine"], st["ct"], st["frames"], st["t"]
    t0_chunk = t
    chunk_ms = []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t_loop = time.perf_counter()
    for _ in range(n_chunks):
        tc = time.perf_counter()
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
        sync()
        chunk_ms.append((time.perf_counter() - tc) * 1e3 / chunk)
    ct.sync()
    sync()
    loop_s = time.perf_counter() - t_loop
    launches = patch.LAUNCHES

    sts, n_inl, pR, pt, kf_ins, _, _ = ct.collect()
    n_frames = chunk * n_chunks
    tracked = sts == int(TrackerStatus.TRACKING)
    centers = -np.einsum("bji,bj->bi", pR, pt)
    gt = st["gt"][t0_chunk:t0_chunk + n_frames]
    ate, _ = ate_rmse(centers[tracked], gt[tracked])
    res = {
        "frames": n_frames,
        "state": engine.status.name,
        "tracked_fraction": float(tracked.mean()),
        "keyframes_in_loop": int(kf_ins.sum()),
        "keyframes": engine.n_keyframes,
        "landmarks": engine.n_landmarks,
        "median_inliers": int(np.median(n_inl)),
        "ate_m": float(ate),
        "fps": n_frames / loop_s,
        "frame_ms_median": float(np.median(chunk_ms)),
        "chunk_frame_ms": [round(x, 3) for x in chunk_ms],
        "patch_launches": launches,
        "patch_launches_init": st["init_launches"],
    }
    checks = {
        "ends TRACKING": engine.status == TrackerStatus.TRACKING,
        "tracked >= 0.9": res["tracked_fraction"] >= 0.9,
        "poses finite": bool(np.isfinite(pR).all() and np.isfinite(pt).all()),
        ">= 2 keyframes in the chunk loop": res["keyframes_in_loop"] >= 2,
        "patch kernel on every extraction":
            launches - st["init_launches"] >= n_chunks * levels,
        "ATE < 0.10 m": ate < 0.10,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}; {res}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import lpslam_tpu_torch  # noqa: F401  (sets full-fp32 matmul precision)
    from lpslam_tpu_torch import _cuda
    from lpslam_tpu_torch.kernels import patch

    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")

    t0 = time.perf_counter()
    patch.build()
    print(f"built csrc/patch.cu in {time.perf_counter() - t0:.2f} s "
          f"(nvcc + load: {_cuda.BUILD_SECONDS['patch.cu']:.2f} s)")

    record = check_patch_kernel(device)

    res = run_slice(device)
    record["launches"] = res["patch_launches"]
    print("slice: " + json.dumps(res))
    print(f"slice: {res['fps']:.2f} frames/s over the synchronized chunk loop, "
          f"median {res['frame_ms_median']:.2f} ms/frame, "
          f"{res['keyframes']} keyframes, {res['landmarks']} landmarks, "
          f"ATE {res['ate_m']:.4f} m on {card}")

    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
