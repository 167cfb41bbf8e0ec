"""Port parity, the pipeline tracker's depth modes with loop closure on:
VSLAMTracker in stereo and RGB-D mode, through the chunked path, in
lpslam_tpu and lpslam_tpu_torch on the same closed 120x160 orbit (0.1 m
baseline / rendered depth), with the relaxed gates of
tests/test_torch_loop_slice.py patched into `_loop_cfg` identically. A
metric map closes loops with a fixed Sim3 scale (`fix_scale`), so these runs
also take the rigid re-fit of `LoopCloser.verify`.

Margins, as for the depth slices (tests/test_torch_stereo_slice.py): at
least one accepted closure (the reference accepts (7, 0) in both modes, and
(8, 0) too in RGB-D), each of JAX's matched within +-1 keyframe on each
side, the same count within 1;
keyframes within +-1; at least JAX's tracked count - 1; ATE aligned without
scale <= max(1.5 x JAX, JAX + 0.02 m); a finite map.
"""
import numpy as np
import pytest
import torch

from lpslam_tpu.eval import ate_rmse
from lpslam_tpu.io.synthetic import make_sequence

import chip_smoke

torch.set_num_threads(1)

BASELINE = 0.1


def _run(pkg, mode, seq):
    fx = float(seq.K[0, 0])
    config = {"mode": mode, "keypoints": 256, "levels": 2, "max_keyframes": 16,
              "max_landmarks": 2048, "loop_closure": True, "loop_async": False,
              "chunk_size": 8, "loop_global_ba_iters": 2}
    if mode == "stereo":
        # the plane lies at 5 m, beyond the default 40 x baseline
        config.update(focal_x_baseline=fx * BASELINE, depth_threshold=80.0)
    else:
        config.update(max_depth=20.0)
    if pkg == "jax":
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.loop.detector import LoopCloser, LoopConfig
        from lpslam_tpu.pipeline.queues import CameraQueueEntry as Entry
        from lpslam_tpu.pipeline.trackers import VSLAMTracker

        tr = VSLAMTracker(PinholeCamera.make(fx, fx, seq.K[0, 2], seq.K[1, 2]), config)
    else:
        from lpslam_tpu_torch.geometry import PinholeCamera
        from lpslam_tpu_torch.loop.detector import LoopCloser, LoopConfig
        from lpslam_tpu_torch.pipeline import CameraQueueEntry as Entry
        from lpslam_tpu_torch.pipeline import VSLAMTracker

        tr = VSLAMTracker(PinholeCamera.make(fx, fx, seq.K[0, 2], seq.K[1, 2], device="cpu"),
                          config, device="cpu")
    tr._loop_cfg = lambda: LoopConfig(min_gap=6, min_score=0.12, consistency=1,
                                      fix_scale=True, global_ba_iters=2)
    verdicts, undo = chip_smoke.record_closures(LoopCloser)
    try:
        for t, img in enumerate(seq.images):
            tr.process_image(Entry(
                timestamp=t / 20.0, image=img,
                image_second=seq.images_r[t] if mode == "stereo" else None,
                aux=seq.depths[t] if mode == "rgbd" else None))
        tr.flush()
    finally:
        undo()
    est, gt = [], []
    for fid, pose, _ in tr.engine.trajectory:
        if pose is not None:
            est.append(-np.asarray(pose.R).T @ np.asarray(pose.t))
            gt.append(np.asarray(seq.poses_wc[fid].t))
    m = tr.engine.map
    return {
        "closures": [v[:2] for v in verdicts if v[4]],
        "tracked": len(est),
        "keyframes": tr.engine.n_keyframes,
        "ate": ate_rmse(np.asarray(est), np.asarray(gt), with_scale=False)[0],
        "state": tr.engine.status.name,
        "finite": bool(np.isfinite(np.asarray(m.kf_t)).all()
                       and np.isfinite(np.asarray(m.lm_pos)).all()),
    }


@pytest.mark.parametrize("mode", ["stereo", "rgbd"])
def test_depth_modes_with_loop_closure_match_jax(mode):
    seq = make_sequence(num_frames=40, h=120, w=160, seed=1, motion="orbit", fx=115.0,
                        stereo_baseline=BASELINE if mode == "stereo" else 0.0,
                        with_depth=mode == "rgbd")
    ref = _run("jax", mode, seq)
    ours = _run("torch", mode, seq)
    assert ref["closures"] and ours["closures"], (ours, ref)   # both close here
    assert abs(len(ours["closures"]) - len(ref["closures"])) <= 1, (ours, ref)
    for a, b in ref["closures"]:
        assert any(abs(a - c) <= 1 and abs(b - d) <= 1 for c, d in ours["closures"]), (ours, ref)
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert ours["tracked"] >= ref["tracked"] - 1, (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)
    assert ours["state"] == ref["state"] == "TRACKING"
    assert ours["finite"]
