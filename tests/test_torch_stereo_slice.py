"""Port parity, the stereo slice: host initialization, then the chunked
tracking loop; and the host path after initialization, in lpslam_tpu and
lpslam_tpu_torch on the same frames (a 120x160 orbit over a textured plane,
0.1 m baseline, ``OrbParams(256, 2, use_pallas=True)``,
``MapConfig(16, 2048, 256)``, chunks of 8).

The JAX package cannot run its Pallas FAST+NMS kernel on the CPU at these
sizes, so it runs the kernel's fixed-ceiling composite instead — the same
math (tests/test_torch_fast_nms.py holds the two equal); the port runs the
kernel's plain version. The scene plane lies at 5 m, beyond the default
depth threshold (40 x 0.1 m), so both trackers take a threshold of 80.

Margins, as for the mono slice (tests/test_torch_slice.py): the same
initialization frame, at least JAX's tracked count - 1 (the host path: the
same statuses), keyframes within +-1, landmarks within +-15%, and an ATE
without scale alignment (depth fixes the scale) <= max(1.5 x JAX,
JAX + 0.02 m). The runner is shared with tests/test_torch_rgbd_slice.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.eval import ate_rmse
from lpslam_tpu.io.synthetic import make_sequence
from lpslam_tpu.kernels import pallas_fast
from lpslam_tpu.kernels.fast import fast_score, nms3x3

torch.set_num_threads(1)

BASELINE = 0.1
DEPTH_THRESHOLD = 80.0


def _fixed_ceiling_composite(img, thr_hi=20.0, thr_lo=7.0, interpret=False):
    s_hi, _ = fast_score(img, thr_hi)
    s_lo, _ = fast_score(img, thr_lo)
    return nms3x3(jnp.where(s_hi > 0, 1.0 + s_hi, s_lo * (1e-3 / (1.0 + 255.0 * 16.0))))


def make_engine(pkg, mode, seq):
    """(engine, ChunkedTracker class, TrackerStatus) of one package."""
    if pkg == "jax":
        from lpslam_tpu.frontend import TrackerConfig, TrackerStatus
        from lpslam_tpu.frontend.device_loop import ChunkedTracker
        from lpslam_tpu.frontend.stereo import RGBDTracker, StereoTracker
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.kernels.orb import OrbParams
        from lpslam_tpu.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
        kw = {}
    else:
        from lpslam_tpu_torch.frontend import (
            RGBDTracker, StereoTracker, TrackerConfig, TrackerStatus,
        )
        from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
        from lpslam_tpu_torch.geometry import PinholeCamera
        from lpslam_tpu_torch.kernels.orb import OrbParams
        from lpslam_tpu_torch.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                 device="cpu")
        kw = {"device": "cpu"}
    cfg = TrackerConfig(orb=OrbParams(256, 2, use_pallas=mode == "stereo"),
                        map_cfg=MapConfig(16, 2048, 256))
    if mode == "stereo":
        eng = StereoTracker(cam, seq.K[0, 0] * BASELINE, cfg,
                            depth_threshold=DEPTH_THRESHOLD, **kw)
    else:
        eng = RGBDTracker(cam, cfg, max_depth=20.0, **kw)
    return eng, ChunkedTracker, TrackerStatus


def _aux(mode, seq):
    return seq.images_r if mode == "stereo" else seq.depths


def run_depth_slice(pkg, mode, seq, chunk=8):
    eng, ChunkedTracker, TrackerStatus = make_engine(pkg, mode, seq)
    aux = _aux(mode, seq)
    t = 0
    while eng.status != TrackerStatus.TRACKING and t < 12:
        eng.process(seq.images[t], aux=aux[t])
        t += 1
    init_frame = t
    ct = ChunkedTracker(eng)
    assert ct.mode == mode
    while t + chunk <= len(seq.images):
        if mode == "stereo":
            frames = np.stack([seq.images[t:t + chunk], aux[t:t + chunk]], axis=1)
        else:
            frames = (seq.images[t:t + chunk], aux[t:t + chunk])
        ct.process_chunk(frames)
        t += chunk
    ct.sync()
    sts, n_inl, pR, pt, kf, _, _ = ct.collect()
    tracked = sts == int(TrackerStatus.TRACKING)
    est = -np.einsum("bji,bj->bi", pR, pt)[tracked]
    gt = np.asarray([seq.poses_wc[init_frame + i].t for i in range(len(sts))])[tracked]
    return {
        "init_frame": init_frame,
        "tracked": int(tracked.sum()),
        "keyframes": eng._kf_count,
        "keyframes_in_loop": int(kf.sum()),
        "landmarks": eng.n_landmarks,
        "ate": ate_rmse(est, gt, with_scale=False)[0],
        "status": int(eng.status),
    }


def run_depth_host(pkg, mode, seq, n_frames):
    eng, _, _ = make_engine(pkg, mode, seq)
    aux = _aux(mode, seq)
    statuses = []
    for t in range(n_frames):
        st, _ = eng.process(seq.images[t], aux=aux[t])
        statuses.append(int(st))
    poses = [(fid, p) for fid, p, _ in eng.trajectory if p is not None]
    est = np.array([-np.asarray(p.R).T @ np.asarray(p.t) for _, p in poses])
    gt = np.array([seq.poses_wc[fid].t for fid, _ in poses])
    return {
        "statuses": statuses,
        "keyframes": eng.n_keyframes,
        "landmarks": eng.n_landmarks,
        "ate": ate_rmse(est, gt, with_scale=False)[0],
    }


def assert_slice_close(ours, ref, n_frames):
    assert ref["tracked"] == n_frames and ref["keyframes_in_loop"] >= 2, ref
    assert ours["init_frame"] == ref["init_frame"], (ours, ref)
    assert ours["tracked"] >= ref["tracked"] - 1, (ours, ref)
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert abs(ours["landmarks"] - ref["landmarks"]) <= 0.15 * ref["landmarks"], (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)
    assert ours["status"] == ref["status"] == 2


def assert_host_close(ours, ref):
    assert ref["statuses"][0] == 2 and set(ref["statuses"]) == {2}, ref
    assert ours["statuses"] == ref["statuses"], (ours, ref)
    assert ref["keyframes"] >= 3, ref
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert abs(ours["landmarks"] - ref["landmarks"]) <= 0.15 * ref["landmarks"], (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)


@pytest.fixture
def stereo_seq(monkeypatch):
    monkeypatch.setattr(pallas_fast, "fast_nms_score_pallas", _fixed_ceiling_composite)
    return make_sequence(num_frames=33, h=120, w=160, seed=1, motion="orbit", fx=115.0,
                         stereo_baseline=BASELINE)


def test_stereo_slice_matches_jax(stereo_seq):
    ref = run_depth_slice("jax", "stereo", stereo_seq)
    ours = run_depth_slice("torch", "stereo", stereo_seq)
    assert_slice_close(ours, ref, 32)


def test_stereo_host_path_matches_jax(stereo_seq):
    ref = run_depth_host("jax", "stereo", stereo_seq, 14)
    ours = run_depth_host("torch", "stereo", stereo_seq, 14)
    assert_host_close(ours, ref)
