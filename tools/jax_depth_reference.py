"""The JAX package's stereo and RGB-D ATE on the frames and configuration of
chip_smoke.py's depth phases, on the CPU: the reference that sets their
ATE bounds.

    JAX_PLATFORMS=cpu python tools/jax_depth_reference.py --mode stereo
    JAX_PLATFORMS=cpu python tools/jax_depth_reference.py --mode rgbd

Renders the same room frames (lpslam_tpu/io/benchmark.py, 640x480, lens
distortion, photometric drift), rectifies them in the JAX package's own way
(cv2 maps, `geometry.camera.rectify_maps_stereo` for stereo), initializes on
the host path, then runs the chunk loop with `OrbParams(1200, 3,
use_pallas=True)` and `MapConfig(128, 24576, 1200)`. On the CPU the Pallas
FAST+NMS kernel cannot run, so `fast_nms_score_pallas` is replaced by its
fixed-ceiling composite, the same math as its small-level branch
(pallas_fast.py:126-132). Prints one JSON line; ATE is aligned without
scale, over the tracked frames of the chunk loop.
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

import chip_smoke as smoke  # noqa: E402  (the phases' constants)


def _fixed_ceiling_composite(img, thr_hi=20.0, thr_lo=7.0, interpret=False):
    import jax.numpy as jnp

    from lpslam_tpu.kernels.fast import fast_score, nms3x3

    s_hi, _ = fast_score(img, thr_hi)
    s_lo, _ = fast_score(img, thr_lo)
    lo_ceiling = 1e-3 / (1.0 + 255.0 * 16.0)
    return nms3x3(jnp.where(s_hi > 0, 1.0 + s_hi, s_lo * lo_ceiling))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["stereo", "rgbd"], required=True)
    args = p.parse_args(argv)

    import cv2
    import jax.numpy as jnp

    from lpslam_tpu.eval import ate_rmse
    from lpslam_tpu.frontend import TrackerConfig, TrackerStatus
    from lpslam_tpu.frontend.device_loop import ChunkedTracker
    from lpslam_tpu.frontend.stereo import RGBDTracker, StereoTracker
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.geometry.camera import rectify_maps_stereo
    from lpslam_tpu.io.benchmark import SyntheticBenchmark
    from lpslam_tpu.kernels import pallas_fast
    from lpslam_tpu.kernels.orb import OrbParams
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.mapstore import MapConfig

    pallas_fast.fast_nms_score_pallas = _fixed_ceiling_composite
    stereo = args.mode == "stereo"
    n_chunks = smoke.STEREO_CHUNKS if stereo else smoke.RGBD_CHUNKS
    h, w, chunk, n_init = 480, 640, smoke.CHUNK, smoke.DEPTH_N_INIT
    total = n_init + chunk * n_chunks
    t0 = time.perf_counter()
    ds = SyntheticBenchmark(num_frames=total, h=h, w=w, seed=0, stereo=stereo,
                            with_depth=not stereo, turns=1.08 * total / 556.0)
    frames = list(ds)
    left = np.stack([np.clip(f.image, 0, 255).astype(np.uint8) for f in frames])
    intr = ds.intr
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
    dist = np.asarray(intr["dist"], np.float64)
    cfg = TrackerConfig(
        orb=OrbParams(num_keypoints=smoke.KEYPOINTS, num_levels=smoke.LEVELS,
                      use_pallas=True),
        map_cfg=MapConfig(max_keyframes=128, max_landmarks=24576,
                          num_keypoints=smoke.KEYPOINTS),
    )
    if stereo:
        right = np.stack([np.clip(f.image_right, 0, 255).astype(np.uint8) for f in frames])
        R_rl, t_rl = smoke.stereo_rig(intr)
        rect = rectify_maps_stereo(K, dist, K, dist, R_rl, t_rl, (h, w))
        Kn = rect["K_new"]
        cam = PinholeCamera.make(Kn[0, 0], Kn[1, 1], Kn[0, 2], Kn[1, 2])
        eng = StereoTracker(cam, rect["focal_x_baseline"], cfg)
        maps = (jnp.asarray(rect["map_l"]), jnp.asarray(rect["map_r"]))
        rmap = np.stack([rect["map_l"], rect["map_r"]])

        def host_frame(t):
            return (remap_bilinear(jnp.asarray(left[t], jnp.float32), maps[0]),
                    remap_bilinear(jnp.asarray(right[t], jnp.float32), maps[1]))

        def chunk_of(t):
            return np.stack([left[t:t + chunk], right[t:t + chunk]], axis=1)
    else:
        depth = np.stack([f.depth for f in frames]).astype(np.float32)
        rmap = cv2.initUndistortRectifyMap(K, dist, np.eye(3), K, (w, h), cv2.CV_32FC2)[0]
        cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
        eng = RGBDTracker(cam, cfg, max_depth=smoke.RGBD_MAX_DEPTH)
        m = jnp.asarray(rmap)

        def host_frame(t):
            return (remap_bilinear(jnp.asarray(left[t], jnp.float32), m),
                    remap_bilinear(jnp.asarray(depth[t]), m))

        def chunk_of(t):
            return (left[t:t + chunk], depth[t:t + chunk])
    print(f"rendered {total} frames in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    t = 0
    while eng.status != TrackerStatus.TRACKING and t < n_init:
        img, aux = host_frame(t)
        eng.process(img, aux=aux)
        t += 1
    if eng.status != TrackerStatus.TRACKING:
        raise SystemExit(f"no initialization within {n_init} frames")
    t_first = t
    ct = ChunkedTracker(eng, rectify_map=rmap)
    for _ in range(n_chunks):
        ct.process_chunk(chunk_of(t))
        t += chunk
    ct.sync()
    sts, n_inl, pR, pt, kf, _, _ = ct.collect()
    tracked = sts == int(TrackerStatus.TRACKING)
    centers = -np.einsum("bji,bj->bi", pR, pt)
    gt = ds.ground_truth().positions[t_first:t_first + len(sts)]
    ate, _ = ate_rmse(centers[tracked], gt[tracked], with_scale=False)
    print(json.dumps({
        "mode": args.mode,
        "init_frames": t_first,
        "frames": int(len(sts)),
        "tracked": int(tracked.sum()),
        "keyframes_in_loop": int(kf.sum()),
        "keyframes": int(eng.n_keyframes),
        "landmarks": int(eng.n_landmarks),
        "median_inliers": int(np.median(n_inl)),
        "ate_m_no_scale": float(ate),
        "state": eng.status.name,
        "seconds": time.perf_counter() - t0,
        "device": "cpu (JAX)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
