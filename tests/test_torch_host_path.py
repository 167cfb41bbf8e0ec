"""Port parity, the host tracking path: ``MonoTracker.process`` frame by frame
after initialization, in lpslam_tpu and lpslam_tpu_torch on the same frames.

This runs the TRACKING and LOST branches of ``process``, the keyframe
pipeline (insert, triangulate, local BA, cull/compact), its adoption at the
next frame (async mapping) or at once (sync), and the forced compaction when
the store reaches its keyframe capacity. One frame is blanked, so both
packages must lose track on it and recover on the next with the wider lost
radius.

Margins, as for the chunk loop (tests/test_torch_slice.py): the same frame
statuses, keyframes within +-1, landmarks within +-15%, and a Sim3 ATE
<= max(1.5 x JAX, JAX + 0.02 m).
"""
import numpy as np
import pytest
import torch

from lpslam_tpu.eval import ate_rmse
from lpslam_tpu.io.synthetic import make_sequence

torch.set_num_threads(1)

BLANK = 20     # a frame after initialization, replaced by a black image
KF_CAP = 6     # small enough that the forced compaction runs


def _run_host(pkg, seq, async_mapping):
    if pkg == "jax":
        from lpslam_tpu.frontend import MonoTracker, TrackerConfig
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.kernels.orb import OrbParams
        from lpslam_tpu.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
        kw = {}
    else:
        from lpslam_tpu_torch.frontend import MonoTracker, TrackerConfig
        from lpslam_tpu_torch.geometry import PinholeCamera
        from lpslam_tpu_torch.kernels.orb import OrbParams
        from lpslam_tpu_torch.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                 device="cpu")
        kw = {"device": "cpu"}
    cfg = TrackerConfig(orb=OrbParams(256, 2), map_cfg=MapConfig(KF_CAP, 2048, 256),
                        async_mapping=async_mapping)
    eng = MonoTracker(cam, cfg, **kw)
    forced = []
    compact = eng._compact

    def counted_compact(force_min_one=False):
        forced.append(force_min_one)
        compact(force_min_one=force_min_one)

    eng._compact = counted_compact
    statuses, events = [], 0
    for t, img in enumerate(seq.images):
        st, _ = eng.process(np.zeros_like(img) if t == BLANK else img)
        statuses.append(int(st))
        events += len(eng.drain_compactions())
    poses = [(fid, p) for fid, p, _ in eng.trajectory if p is not None]
    est = np.array([-np.asarray(p.R).T @ np.asarray(p.t) for _, p in poses])
    gt = np.array([seq.poses_wc[fid].t for fid, _ in poses])
    return {
        "statuses": statuses,
        "keyframes": eng.n_keyframes,
        "kf_count": eng._kf_count,
        "landmarks": eng.n_landmarks,
        "forced_compactions": sum(forced),
        "compaction_events": events,
        "ate": ate_rmse(est, gt)[0],
    }


@pytest.mark.parametrize("async_mapping", [True, False])
def test_host_path_matches_jax(async_mapping):
    seq = make_sequence(num_frames=36, h=120, w=160, seed=1, motion="orbit", fx=115.0)
    ref = _run_host("jax", seq, async_mapping)
    ours = _run_host("torch", seq, async_mapping)
    # the reference itself initializes, loses the blank frame and recovers
    init = ref["statuses"].index(2)
    assert init < BLANK and ref["statuses"][BLANK] == 3, ref
    assert ref["statuses"][init:].count(2) == len(seq.images) - init - 1, ref
    assert ref["forced_compactions"] >= 1, ref
    assert ours["statuses"] == ref["statuses"], (ours, ref)
    assert ours["forced_compactions"] == ref["forced_compactions"], (ours, ref)
    assert ours["compaction_events"] == ref["compaction_events"], (ours, ref)
    assert ours["kf_count"] == ours["keyframes"], ours
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert abs(ours["landmarks"] - ref["landmarks"]) <= 0.15 * ref["landmarks"], (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)
