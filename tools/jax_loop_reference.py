"""The JAX package's loop closing and relocalization on the frames and
configuration of chip_smoke.py's phases 7-8, on the CPU: the reference
that sets their bounds.

    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py [--frames N]
    JAX_PLATFORMS=cpu python tools/jax_loop_reference.py --vocab-only

Renders the room (chip_smoke.LOOP_FRAMES frames) with the port's numpy copy of the renderer and
takes the port's numpy undistortion grid, so both packages see the same
bytes. A JAX `VSLAMTracker` with chip_smoke.LOOP_CONFIG (mono, 1200
keypoints, 3 levels, MapConfig(128, 24576, 1200), loop closure with the
shipped vocabulary and 5 global-BA iterations, synchronous, chunks of 16)
gets the grid through `attach_device_rectify`; frames headed for its host
path are undistorted with the JAX `remap_bilinear` on the same grid
(chip_smoke.drive_room). Then phase 8: each of chip_smoke.KIDNAP_FRAMES
with the engine set LOST, through the host path.

Prints one JSON line: accepted closures as (k_new, candidate, n_inliers),
every verdict that named a candidate as (k_new, candidate, n_matches,
n_inliers, accepted), tracked frames, keyframes, Sim3 ATE over the
trajectory, and the relocalization outcomes.

--vocab-only: phase 14 (JAX_VOCAB_REF). ORB (chip_smoke's KEYPOINTS and
LEVELS) on every undistorted room frame; the JAX `train_vocabulary_tree`
(branching 32, depth 3, a document per frame) on the first lap's valid
descriptors, the lazy `train_vocabulary` (the first 4096, 512 words), and
chip_smoke.vocab_metrics of those two and the shipped vocabulary. Prints
one JSON line {"tree": ..., "lazy_flat": ..., "shipped": ...}.
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

import chip_smoke as smoke  # noqa: E402  (the phases' constants and frame feeding)


def vocab_reference(frames: int) -> dict:
    """Phase 14 in the JAX package."""
    import jax
    import jax.numpy as jnp

    from lpslam_tpu.kernels.orb import OrbParams, extract_orb
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.loop.vocab import (bow_vector, load_vocabulary, train_vocabulary,
                                       train_vocabulary_tree)

    raw, gt, _, grid = smoke.render_room(frames)
    grid_j = jnp.asarray(grid)
    params = OrbParams(num_keypoints=smoke.KEYPOINTS, num_levels=smoke.LEVELS)
    ext = jax.jit(lambda im: extract_orb(remap_bilinear(im, grid_j), params))
    desc, valid = [], []
    for i, img in enumerate(raw):
        f = ext(jnp.asarray(img, jnp.float32))
        desc.append(np.asarray(f.desc))
        valid.append(np.asarray(f.valid))
        if (i + 1) % 100 == 0:
            print(f"extracted {i + 1}/{len(raw)}", file=sys.stderr, flush=True)
    desc, valid = np.stack(desc), np.stack(valid)
    T = smoke.room_lap(len(raw))
    n_kp = desc.shape[1]
    lap_valid = valid[:T].reshape(-1)
    train = desc[:T].reshape(-1, 8)[lap_valid]
    docs = np.repeat(np.arange(T), n_kp)[lap_valid]
    t0 = time.perf_counter()
    tree = train_vocabulary_tree(train, branching=32, depth=3, doc_ids=docs)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = train_vocabulary(train[:4096], n_words=512)
    t_flat = time.perf_counter() - t0
    out = {"frames": len(raw), "lap": T, "train_descriptors": int(len(train))}
    for name, vocab, secs in (("tree", tree, t_tree), ("lazy_flat", flat, t_flat),
                              ("shipped", load_vocabulary(str(REPO / "lpslam_tpu" / "assets" / "orb_vocab.npz")), None)):
        bow = jax.jit(lambda d, v: bow_vector(vocab, d, v))
        vecs = np.stack([np.asarray(bow(d, v)) for d, v in zip(desc, valid)])
        out[name] = {"words": int(vocab.words.shape[0]), "train_s_cpu": secs,
                     **smoke.vocab_metrics(vecs, gt, T)}
        print(name + " " + json.dumps(out[name]), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=smoke.LOOP_FRAMES)
    p.add_argument("--vocab-only", action="store_true", help="phase 14 only")
    args = p.parse_args(argv)
    if args.vocab_only:
        print(json.dumps({**vocab_reference(args.frames), "device": "cpu (JAX)"}))
        return 0

    import jax.numpy as jnp

    from lpslam_tpu.frontend.tracker import TrackerStatus
    from lpslam_tpu.geometry import SE3, PinholeCamera
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.loop.detector import LoopCloser
    from lpslam_tpu.pipeline.queues import CameraQueueEntry
    from lpslam_tpu.pipeline.trackers import VSLAMTracker

    t0 = time.perf_counter()
    raw, gt, K, grid = smoke.render_room(args.frames)
    print(f"rendered {len(raw)} frames in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    grid_j = jnp.asarray(grid)

    def rectified(t):
        return np.asarray(remap_bilinear(jnp.asarray(raw[t], jnp.float32), grid_j))

    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    tracker = VSLAMTracker(cam, dict(smoke.LOOP_CONFIG))
    tracker.attach_device_rectify(grid)
    verdicts, undo = smoke.record_closures(LoopCloser)
    t1 = time.perf_counter()
    try:
        fed = smoke.drive_room(tracker, TrackerStatus.TRACKING, CameraQueueEntry,
                               raw, rectified)
    finally:
        undo()
    loop_s = time.perf_counter() - t1
    eng = tracker.engine
    met = smoke.room_metrics(eng, gt)
    state = eng.status.name
    def blind_pose(pose):
        return SE3(pose.R, jnp.asarray([0.0, 0.0, -1e4], jnp.float32))

    reloc = smoke.kidnap(tracker, TrackerStatus.LOST, CameraQueueEntry, rectified, gt,
                         met["align"], np.asarray, blind_pose,
                         frames=[f for f in smoke.KIDNAP_FRAMES if f < len(raw)])
    print(json.dumps({
        "frames": fed,
        "turns": 1.08 * args.frames / 600.0,
        "tracked": met["tracked"],
        "keyframes": int(eng.n_keyframes),
        "landmarks": int(eng.n_landmarks),
        "closures": [v[:2] + v[3:4] for v in verdicts if v[4]],
        "verdicts": verdicts,
        "ate_m_sim3": met["ate_m"],
        "state": state,
        "relocalization": reloc,
        "loop_seconds": loop_s,
        "device": "cpu (JAX)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
