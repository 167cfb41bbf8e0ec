"""Port parity, relocalization: lpslam_tpu_torch/frontend/relocalize.py and
MonoTracker.relocalize_with_candidates against lpslam_tpu on the CPU.

The hypothesis draws of pnp_irls come from different generators (jax.random
vs torch.multinomial), so robust PnP and relocalization are held on
outcomes, not samples:
- pnp_dlt on exact correspondences: rotation within 1e-3 and translation
  within 5e-3 of the truth and of JAX (a 12x12 fp32 eigenproblem; 5e-3 is
  the JAX test's bound);
- pnp_irls, exact / with noise and 25% outliers / with invalid points: the
  JAX tests' bounds on the truth, for both packages;
- relocalize_attempt against each keyframe of a map from the 120x160 CPU
  slice, its own source image as the query: the same accept/reject verdict,
  inlier counts within 10%, accepted poses within 1e-2 of each other;
- relocalize_with_candidates: both engines accept and adopt the same pose
  within 1e-2.
pnp_irls departs from JAX on purpose (centred DLT, see the port's module
docstring); test_pnp_irls_far_from_the_origin shows why.
Also: the readiness events of queued compactions (mapping_in_flight, the
only_ready drain) and ChunkedTracker's carry hooks.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.frontend import relocalize as jrel
from lpslam_tpu.frontend.tracker import MonoTracker as JMono
from lpslam_tpu.frontend.tracker import TrackerConfig as JCfg
from lpslam_tpu.frontend.tracker import TrackerStatus as JStatus
from lpslam_tpu.geometry import PinholeCamera as JCam
from lpslam_tpu.geometry.se3 import se3_exp
from lpslam_tpu.io.synthetic import make_sequence
from lpslam_tpu.kernels.orb import OrbParams as JOrb
from lpslam_tpu.mapstore.store import MapConfig as JMapCfg

from lpslam_tpu_torch import convert
from lpslam_tpu_torch.frontend import relocalize as trel
from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
from lpslam_tpu_torch.frontend.tracker import MonoTracker as TMono
from lpslam_tpu_torch.frontend.tracker import TrackerConfig as TCfg
from lpslam_tpu_torch.frontend.tracker import TrackerStatus as TStatus
from lpslam_tpu_torch.geometry import PinholeCamera as TCam
from lpslam_tpu_torch.kernels.orb import OrbParams as TOrb
from lpslam_tpu_torch.mapstore.store import MapConfig as TMapCfg

torch.set_num_threads(1)

F, CX, CY = 300.0, 160.0, 120.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _gt_pose(seed):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.uniform(-0.5, 0.5, 3), rng.uniform(-0.3, 0.3, 3)])
    T = se3_exp(jnp.asarray(xi, jnp.float32))
    return np.asarray(T.R), np.asarray(T.t)


def _scene(seed, n):
    rng = np.random.default_rng(seed)
    R, t = _gt_pose(seed + 1)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], -1).astype(np.float32)
    pc = pts @ R.T + t
    uv = np.stack([F * pc[:, 0] / pc[:, 2] + CX, F * pc[:, 1] / pc[:, 2] + CY], -1)
    return rng, R, t, pts, uv.astype(np.float32)


def test_pnp_dlt_exact_pose():
    _, R, t, pts, uv = _scene(0, 60)
    uv_n = ((uv - [CX, CY]) / F).astype(np.float32)
    w = np.ones(60, np.float32)
    Tj = jrel.pnp_dlt(jnp.asarray(pts), jnp.asarray(uv_n), jnp.asarray(w))
    Tt = trel.pnp_dlt(_t(pts), _t(uv_n), _t(w))
    for T in (Tt, Tj):
        np.testing.assert_allclose(np.asarray(T.R), R, atol=1e-3)
        np.testing.assert_allclose(np.asarray(T.t), t, atol=5e-3)
    np.testing.assert_allclose(Tt.R.numpy(), np.asarray(Tj.R), atol=1e-3)
    np.testing.assert_allclose(Tt.t.numpy(), np.asarray(Tj.t), atol=5e-3)
    # a batch of weight vectors solves each one
    wb = np.stack([w, (np.arange(60) % 2).astype(np.float32)])
    Tb = trel.pnp_dlt(_t(pts), _t(uv_n), _t(wb))
    assert Tb.R.shape == (2, 3, 3)
    np.testing.assert_allclose(Tb.t.numpy(), np.stack([t, t]), atol=5e-3)


@pytest.mark.parametrize("case", ["exact", "noise_outliers", "invalid"])
def test_pnp_irls_outcomes(case):
    rng, R, t, pts, uv = _scene(2, 120)
    valid = np.ones(120, bool)
    if case == "noise_outliers":
        uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
        uv[:30] = rng.uniform(0, 320, (30, 2))
    elif case == "invalid":
        uv[60:] = 0.0
        valid[60:] = False
    cam_j = JCam.make(F, F, CX, CY)
    cam_t = TCam.make(F, F, CX, CY, device="cpu")
    for T in (jrel.pnp_irls(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), cam_j),
              trel.pnp_irls(_t(pts), _t(uv), _t(valid), cam_t)):
        Re, te = np.asarray(T.R), np.asarray(T.t)
        ang = np.arccos(np.clip((np.trace(Re @ R.T) - 1) / 2, -1, 1))
        if case == "noise_outliers":
            assert ang < 0.02 and np.linalg.norm(te - t) < 0.1, (ang, te, t)
        else:
            assert ang < 1e-3 and np.linalg.norm(te - t) < 1e-2, (ang, te, t)


@pytest.mark.parametrize("offset", [20.0, 80.0])
def test_pnp_irls_far_from_the_origin(offset):
    """The port's deliberate departure: its DLTs run on centred points. The
    same noisy scene moved `offset` map units away from the origin (the
    camera with it): the port keeps its accuracy, the JAX package's fp32
    DLT on raw coordinates loses the pose (the reason for the departure)."""
    rng, R, t, pts, uv = _scene(2, 200)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:40] = rng.uniform(0, 320, (40, 2))
    shift = np.float32([offset, -0.5 * offset, 0.7 * offset])
    pts, t = pts + shift, t - R @ shift
    valid = np.ones(200, bool)
    errs = []
    for T in (trel.pnp_irls(_t(pts), _t(uv), _t(valid), TCam.make(F, F, CX, CY, device="cpu")),
              jrel.pnp_irls(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                            JCam.make(F, F, CX, CY))):
        Re, te = np.asarray(T.R), np.asarray(T.t)
        errs.append((np.arccos(np.clip((np.trace(Re @ R.T) - 1) / 2, -1, 1)),
                     np.linalg.norm(Re.T @ te - R.T @ t)))
    assert errs[0][0] < 0.02 and errs[0][1] < 0.1, errs
    assert errs[1][0] > 0.1, errs


@pytest.fixture(scope="module")
def slice_engines():
    """A JAX MonoTracker after the host path on the 120x160 orbit, a port
    MonoTracker holding the same map, and the frames."""
    seq = make_sequence(num_frames=30, h=120, w=160, seed=12, motion="orbit", fx=115.0)
    K = seq.K
    jeng = JMono(JCam.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                 JCfg(orb=JOrb(256, 2), map_cfg=JMapCfg(16, 2048, 256), async_mapping=False))
    for img in seq.images:
        jeng.process(img)
    assert jeng.status == JStatus.TRACKING
    teng = TMono(TCam.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device="cpu"),
                 TCfg(orb=TOrb(256, 2), map_cfg=TMapCfg(16, 2048, 256), async_mapping=False),
                 device="cpu")
    teng.map = convert.map_from_numpy(
        {k: np.asarray(v) for k, v in jeng.map._asdict().items()}, "cpu")
    teng.status = TStatus.TRACKING
    return jeng, teng, seq


def _feats(jeng, img):
    fj = jeng._extract(img)
    return fj, convert.feats_from_numpy({k: np.asarray(v) for k, v in fj._asdict().items()},
                                        "cpu")


def test_relocalize_attempt_outcomes(slice_engines):
    jeng, teng, seq = slice_engines
    nk = int(jeng.map.n_kf)
    fids = np.asarray(jeng.map.kf_frame_id)[:nk]
    n_ok = 0
    for k in range(2, nk):
        fj, ft = _feats(jeng, seq.images[int(fids[k])])
        rj = jrel.relocalize_attempt(jeng.map, jeng.cam, fj.desc, fj.xy, fj.valid,
                                     jnp.int32(k), min_inliers=20)
        rt = trel.relocalize_attempt(teng.map, teng.cam, ft.desc, ft.xy, ft.valid, k,
                                     min_inliers=20)
        assert bool(rt.ok) == bool(rj.ok), (k, int(rt.n_inliers), int(rj.n_inliers))
        assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 0.1 * int(rj.n_inliers) + 1
        if bool(rj.ok):
            n_ok += 1
            np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t), atol=1e-2)
            np.testing.assert_allclose(rt.pose.R.numpy(), np.asarray(rj.pose.R), atol=1e-2)
    assert n_ok >= 3, n_ok


def test_relocalize_with_candidates(slice_engines):
    jeng, teng, seq = slice_engines
    nk = int(jeng.map.n_kf)
    k = nk // 2
    fj, ft = _feats(jeng, seq.images[int(np.asarray(jeng.map.kf_frame_id)[k])])
    for eng in (jeng, teng):
        eng.status = type(eng.status).LOST
    assert jeng.relocalize_with_candidates(fj, list(range(nk)), min_inliers=20)
    assert teng.relocalize_with_candidates(ft, list(range(nk)), min_inliers=20)
    np.testing.assert_allclose(teng.pose.t.numpy(), np.asarray(jeng.pose.t), atol=1e-2)
    assert torch.equal(teng.velocity.R, torch.eye(3))
    # nothing verified: the pose stays
    before = teng.pose
    assert not teng.relocalize_with_candidates(ft, [k], min_inliers=10**6)
    assert teng.pose is before


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_compaction_readiness():
    """A queued compaction is ready when its event has completed (always on
    the CPU): mapping_in_flight waits for it, the only_ready drain leaves it
    queued, a full drain reads it."""
    from lpslam_tpu_torch.mapstore.store import CompactResult, empty_map

    eng = TMono(TCam.make(100.0, 100.0, 80.0, 60.0, device="cpu"), TCfg(), device="cpu")
    m = empty_map(TMapCfg(8, 64, 16), "cpu")._replace(n_kf=torch.tensor(5, dtype=torch.int32))
    res = CompactResult(m, torch.arange(8), torch.arange(64), torch.tensor(2, dtype=torch.int32))
    eng._kf_count = 7
    eng._queue_compaction(res)            # the CPU: no event, ready
    assert eng._pending_compacts[0][1] is None and not eng.mapping_in_flight
    eng._pending_compacts = [(res, _Event(False))]
    assert eng.mapping_in_flight
    eng._drain_compact_stats(only_ready=True)
    assert len(eng._pending_compacts) == 1 and eng._kf_count == 7
    eng._pending_compacts[0][1].done = True
    assert not eng.mapping_in_flight
    eng._drain_compact_stats(only_ready=True)
    assert eng._pending_compacts == [] and eng._kf_count == 5
    assert [int(n) for _, n in eng.drain_compactions()] == [5]
    eng._pending_map = (m, None)
    assert eng.mapping_in_flight


def test_chunk_carry_hooks():
    eng = TMono(TCam.make(100.0, 100.0, 80.0, 60.0, device="cpu"), TCfg(), device="cpu")
    ct = ChunkedTracker(eng)
    carry = ct._carry()._replace(status=int(TStatus.LOST), last_kf_frame=41,
                                 inliers_at_last_kf=77)
    ct._pending_carry = carry
    ct.discard_carry()                    # host state is newer: drop it
    assert ct._pending_carry is None and eng.status == TStatus.NOT_INITIALIZED
    ct._pending_carry = carry
    ct.invalidate_carry()                 # fold it into the engine first
    assert ct._pending_carry is None
    assert eng.status == TStatus.LOST and eng.last_kf_frame == 41
    assert eng.inliers_at_last_kf == 77
