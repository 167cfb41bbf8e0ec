"""Port parity, loop closing: lpslam_tpu_torch/loop/* and geometry/sim3.py
against lpslam_tpu on the CPU, the same numpy inputs through both.

Tolerances:
- Sim3 exp/log/compose/inverse: 1e-5 absolute (fp32 chains of a few
  transcendental ops); the pose-graph residuals and their forward-mode
  Jacobians: 1e-5 absolute, at zero and at random points, and finite there.
- The 12-node drift circle: both packages pull the chain closed (the JAX
  test's own criteria), and their optimized poses agree within 1e-4.
- Umeyama / robust Sim3: R, t, s within 1e-4 (the SVD's signs may differ;
  R = U S Vt with the determinant fix does not depend on them); inlier masks
  equal.
- The shipped vocabulary's words and words_pm1, and assign_words (including
  a fixture where most similarities tie): bit-equal; bow_vector within 1e-6.
- The consistency gates with a stubbed detect: the same verdicts.
- correct_loop on a map from the 120x160 CPU slice: keyframe poses and
  landmarks within 1e-3 (a 10-step Gauss-Newton over a 112x112 fp32 system);
  global_ba on the same map: final cost within 1e-3 relative, poses within
  1e-3, as the BA parity tests hold local BA.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.backend import ba as jba
from lpslam_tpu.geometry import PinholeCamera as JCam
from lpslam_tpu.geometry import se3 as jse3
from lpslam_tpu.geometry import sim3 as jsim3
from lpslam_tpu.io.synthetic import make_sequence
from lpslam_tpu.loop import detector as jdet
from lpslam_tpu.loop import pose_graph as jpg
from lpslam_tpu.loop import sim3_solve as jsolve
from lpslam_tpu.loop import vocab as jvocab
from lpslam_tpu.mapstore import store as jstore

from lpslam_tpu_torch import convert
from lpslam_tpu_torch.backend import ba as tba
from lpslam_tpu_torch.geometry import PinholeCamera as TCam
from lpslam_tpu_torch.geometry import sim3 as tsim3
from lpslam_tpu_torch.loop import detector as tdet
from lpslam_tpu_torch.loop import pose_graph as tpg
from lpslam_tpu_torch.loop import sim3_solve as tsolve
from lpslam_tpu_torch.loop import vocab as tvocab
from lpslam_tpu_torch.mapstore import store as tstore
from lpslam_tpu_torch.pipeline.trackers import SHIPPED_VOCAB

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(S):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy() for x in S]


def _close(a, b, atol):
    for x, y in zip(_np(a), _np(b)):
        np.testing.assert_allclose(x, y, atol=atol)


@pytest.mark.parametrize("scale", [0.0, 1e-6, 1e-3, 0.5])
def test_sim3_exp_log_compose(scale):
    rng = np.random.default_rng(int(scale * 1e6) + 3)
    xi = (rng.normal(size=(8, 7)) * scale).astype(np.float32)
    xi2 = (rng.normal(size=(8, 7)) * 0.3).astype(np.float32)
    Sj, St = jsim3.sim3_exp(jnp.asarray(xi)), tsim3.sim3_exp(_t(xi))
    _close(St, Sj, 1e-5)
    np.testing.assert_allclose(tsim3.sim3_log(St).numpy(), np.asarray(jsim3.sim3_log(Sj)),
                               atol=1e-5)
    np.testing.assert_allclose(tsim3.sim3_log(St).numpy(), xi, atol=1e-5)
    S2j, S2t = jsim3.sim3_exp(jnp.asarray(xi2)), tsim3.sim3_exp(_t(xi2))
    _close(tsim3.sim3_compose(St, S2t), jsim3.sim3_compose(Sj, S2j), 1e-5)
    _close(tsim3.sim3_inverse(S2t), jsim3.sim3_inverse(S2j), 1e-5)
    p = rng.normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(tsim3.sim3_apply(S2t, _t(p)).numpy(),
                               np.asarray(jsim3.sim3_apply(S2j, jnp.asarray(p))), atol=1e-5)


def _rand_sims(rng, n, scale):
    xi = (rng.normal(size=(n, 7)) * scale).astype(np.float32)
    return [np.array(x) for x in jsim3.sim3_exp(jnp.asarray(xi))]


@pytest.mark.parametrize("scale", [0.0, 0.5])
def test_pose_graph_jacobians(scale):
    """Residual and Jacobians of every edge, at zero (identity nodes and
    measurements: the small-angle and small-scale branches) and at random
    points."""
    import jax

    rng = np.random.default_rng(11)
    E = 9
    args = _rand_sims(rng, E, scale) + _rand_sims(rng, E, scale) + _rand_sims(rng, E, scale)
    z = jnp.zeros(7)

    def one(*a):
        return (jpg._edge_residual(z, z, *a),
                jax.jacfwd(jpg._edge_residual, argnums=0)(z, z, *a),
                jax.jacfwd(jpg._edge_residual, argnums=1)(z, z, *a))

    want = jax.vmap(one)(*[jnp.asarray(a) for a in args])
    got = tpg._res_and_jac(*[_t(a) for a in args])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _drift_circle():
    """The 12-node drift circle of tests/test_loop.py."""
    K = 12
    gt_R, gt_t = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = jse3.se3_exp(jnp.asarray([np.cos(a), np.sin(a), 0, 0, 0, a], jnp.float32))
        gt_R.append(np.asarray(T.R))
        gt_t.append(np.asarray(T.t))
    gt_R, gt_t = np.asarray(gt_R), np.asarray(gt_t)
    est_R, est_t = gt_R.copy(), gt_t.copy()
    for k in range(1, K):
        d = jse3.se3_exp(jnp.asarray(np.asarray(
            [0.02 * k, -0.015 * k, 0.01 * k, 0.004 * k, 0, 0.006 * k], np.float32)))
        est_R[k] = np.asarray(d.R) @ gt_R[k]
        est_t[k] = np.asarray(d.R) @ gt_t[k] + np.asarray(d.t)
    ei = np.r_[np.arange(K - 1), [K - 1]].astype(np.int32)
    ej = np.r_[np.arange(1, K), [0]].astype(np.int32)
    Sm_R = np.zeros((K, 3, 3), np.float32)
    Sm_t = np.zeros((K, 3), np.float32)
    for e in range(K):
        Sij = jsim3.sim3_compose(
            jsim3.Sim3(jnp.asarray(gt_R[ei[e]]), jnp.asarray(gt_t[ei[e]]), jnp.float32(1.0)),
            jsim3.sim3_inverse(jsim3.Sim3(jnp.asarray(gt_R[ej[e]]), jnp.asarray(gt_t[ej[e]]),
                                          jnp.float32(1.0))))
        Sm_R[e], Sm_t[e] = np.asarray(Sij.R), np.asarray(Sij.t)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fields = dict(node_R=est_R, node_t=est_t, node_s=np.ones(K, np.float32),
                  edge_i=ei, edge_j=ej, edge_R=Sm_R, edge_t=Sm_t,
                  edge_s=np.ones(K, np.float32), edge_weight=np.ones(K, np.float32),
                  node_fixed=fixed)
    return fields, gt_t, est_t


def test_pose_graph_drift_circle():
    fields, gt_t, est_t = _drift_circle()
    Rj, tj, sj, cj = jpg.optimize_pose_graph(
        jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in fields.items()}), iters=12)
    Rt, tt, st, ct = tpg.optimize_pose_graph(
        tpg.PoseGraphProblem(**{k: _t(v) for k, v in fields.items()}), iters=12)
    err_before = np.linalg.norm(est_t - gt_t, axis=1).mean()
    err_after = np.linalg.norm(tt.numpy() - gt_t, axis=1).mean()
    assert err_after < 0.2 * err_before, (err_before, err_after)
    assert float(ct[-1]) < float(ct[0]) * 0.01
    for g, w in ((Rt, Rj), (tt, tj), (st, sj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_pose_graph_sums_duplicate_edges():
    """A second, disagreeing copy of the loop edge adds its blocks to the
    first one's, as JAX's scatter-add does (an indexed += in torch would keep
    one of them)."""
    fields, _, _ = _drift_circle()
    dup = {k: np.concatenate([v, v[-1:]]) if k.startswith("edge") else v
           for k, v in fields.items()}
    dup["edge_t"][-1] += np.float32([0.3, -0.2, 0.1])
    Rj, tj, _, _ = jpg.optimize_pose_graph(
        jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in dup.items()}), iters=3)
    Rt, tt, _, _ = tpg.optimize_pose_graph(
        tpg.PoseGraphProblem(**{k: _t(v) for k, v in dup.items()}), iters=3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    # either copy alone gives another answer
    for drop in (-1, -2):
        one = {k: np.delete(v, drop, 0) if k.startswith("edge") else v
               for k, v in dup.items()}
        _, t_one, _, _ = tpg.optimize_pose_graph(
            tpg.PoseGraphProblem(**{k: _t(v) for k, v in one.items()}), iters=3)
        assert np.abs(t_one.numpy() - np.asarray(tj)).max() > 1e-2


@pytest.mark.parametrize("outliers", [0.0, 0.25])
def test_umeyama_and_robust_sim3(outliers):
    rng = np.random.default_rng(4)
    n = 200
    src = rng.normal(0, 2, (n, 3)).astype(np.float32)
    S = jsim3.sim3_exp(jnp.asarray([0.1, 0.0, -0.3, 0.05, -0.02, 0.1, np.log(0.9)],
                                   jnp.float32))
    dst = np.array(jsim3.sim3_apply(S, jnp.asarray(src)))
    out = rng.random(n) < outliers
    dst[out] += rng.uniform(1, 5, (out.sum(), 3)).astype(np.float32)
    valid = rng.random(n) < 0.95
    if outliers == 0.0:
        w = rng.uniform(0.5, 1.5, n).astype(np.float32)
        _close(tsolve.umeyama_sim3(_t(src), _t(dst), _t(w)),
               jsolve.umeyama_sim3(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)), 1e-4)
    Sj, inl_j = jsolve.robust_sim3_from_matches(jnp.asarray(src), jnp.asarray(dst),
                                                jnp.asarray(valid), sigma=0.05)
    St, inl_t = tsolve.robust_sim3_from_matches(_t(src), _t(dst), _t(valid), sigma=0.05)
    _close(St, Sj, 1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(float(St.s), float(S.s), rtol=1e-3)


@pytest.fixture(scope="module")
def vocabs():
    return jvocab.load_vocabulary(SHIPPED_VOCAB), tvocab.load_vocabulary(SHIPPED_VOCAB, "cpu")


def test_shipped_vocabulary_bit_equal(vocabs, tmp_path):
    vj, vt = vocabs
    assert vt.words.shape == (31707, 8) and vt.words_pm1.shape == (31707, 256)
    np.testing.assert_array_equal(vt.words.numpy(), np.asarray(vj.words).view(np.int32))
    np.testing.assert_array_equal(vt.words_pm1.numpy(), np.asarray(vj.words_pm1, np.float32))
    np.testing.assert_array_equal(vt.idf.numpy(), np.asarray(vj.idf))
    # the converters and save/load carry the vocabulary across
    d = convert.vocab_to_numpy(vt)
    np.testing.assert_array_equal(d["words"], np.asarray(vj.words))
    back = convert.vocab_from_numpy(
        {k: np.asarray(v) for k, v in vj._asdict().items()}, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, vt))
    tvocab.save_vocabulary(vt, str(tmp_path / "v"))
    vj2 = jvocab.load_vocabulary(str(tmp_path / "v"))
    np.testing.assert_array_equal(np.asarray(vj2.words), np.asarray(vj.words))


@pytest.mark.parametrize("fixture", ["random", "ties"])
def test_assign_words_and_bow_vector(vocabs, fixture):
    vj, vt = vocabs
    rng = np.random.default_rng(5)
    if fixture == "random":
        desc = rng.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
    else:
        # descriptors half-way between pairs of words: both words (and often
        # more) share the best similarity, so the first maximum decides
        w = np.asarray(vj.words)
        a, b = w[rng.integers(0, len(w), 300)], w[rng.integers(0, len(w), 300)]
        mask = rng.integers(0, 2**32, (300, 8), dtype=np.uint64).astype(np.uint32)
        desc = (a & mask) | (b & ~mask)
        desc[:40] = w[:40]            # exact words
        desc[40:60] = 0               # one shared descriptor
    valid = rng.random(300) < 0.9
    ids_j = np.asarray(jvocab.assign_words(vj, jnp.asarray(desc), jnp.asarray(valid)))
    ids_t = tvocab.assign_words(vt, _t(desc.view(np.int32)), _t(valid)).numpy()
    np.testing.assert_array_equal(ids_t, ids_j)
    if fixture == "ties":
        sim = (np.unpackbits(desc.view(np.uint8), bitorder="little").reshape(300, 256)
               .astype(np.float32) * 2 - 1) @ np.asarray(vj.words_pm1, np.float32).T
        n_best = (sim == sim.max(1, keepdims=True)).sum(1)
        assert (n_best > 1).sum() >= 30, (n_best > 1).sum()
    np.testing.assert_allclose(
        tvocab.bow_vector(vt, _t(desc.view(np.int32)), _t(valid)).numpy(),
        np.asarray(jvocab.bow_vector(vj, jnp.asarray(desc), jnp.asarray(valid))), atol=1e-6)


def _stub_closers(consistency, cands, fix_scale=False):
    out = []
    for det, Vocab, words in (
        (jdet, jvocab.Vocabulary, lambda: jvocab.Vocabulary(
            jnp.zeros((4, 8), jnp.uint32), jnp.zeros((4, 256), jnp.int8),
            jnp.ones((4,), jnp.float32))),
        (tdet, tvocab.Vocabulary, lambda: tvocab.Vocabulary(
            torch.zeros((4, 8), dtype=torch.int32), torch.zeros((4, 256)), torch.ones(4))),
    ):
        closer = det.LoopCloser(words(), 8, det.LoopConfig(consistency=consistency,
                                                            fix_scale=fix_scale))
        seq = iter(cands)
        closer.detect = lambda m, k, seq=seq: next(seq)
        out.append(closer)
    return out


@pytest.mark.parametrize("cands", [[2, -1, 2, -1, 2], [2, 2, 2], [1, 3, 6, 6, 6]])
def test_consistency_gates(cands):
    """The consistency gate with a stubbed detect (tests/test_loop.py): one-off
    hits never reach verification; sustained hits reach it and then fail on
    the empty map's match count. Both packages give the same verdicts."""
    cj, ct = _stub_closers(3, cands)
    mj = jstore.empty_map(jstore.MapConfig(8, 64, 16))
    mt = tstore.empty_map(tstore.MapConfig(8, 64, 16), "cpu")
    got = [ct.try_close(mt, k)[1] for k in range(len(cands))]
    want = [cj.try_close(mj, k)[1] for k in range(len(cands))]
    assert [tuple(r) for r in got] == [tuple(r) for r in want]
    assert not any(r.detected for r in got)
    if cands == [2, 2, 2]:
        assert got[2].candidate == 2


@pytest.fixture(scope="module")
def slice_map():
    """The map of the JAX package's host tracking path on the 120x160 orbit
    (tests/test_torch_host_path.py's frames), as numpy, with its camera."""
    from lpslam_tpu.frontend import MonoTracker, TrackerConfig
    from lpslam_tpu.kernels.orb import OrbParams

    seq = make_sequence(num_frames=30, h=120, w=160, seed=1, motion="orbit", fx=115.0)
    cam = JCam.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
    eng = MonoTracker(cam, TrackerConfig(orb=OrbParams(256, 2),
                                         map_cfg=jstore.MapConfig(16, 2048, 256),
                                         async_mapping=False))
    for img in seq.images:
        eng.process(img)
    d = {k: np.array(v) for k, v in eng.map._asdict().items()}
    assert int(d["n_kf"]) >= 6, int(d["n_kf"])
    return d, seq.K


def _maps(d):
    return (jstore.MapStore(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.map_from_numpy(d, "cpu"))


def test_correct_loop_on_slice_map(slice_map):
    d, _ = slice_map
    mj, mt = _maps(d)
    nk = int(d["n_kf"])
    corr = jsim3.sim3_exp(jnp.asarray([0.05, -0.02, 0.03, 0.01, 0.02, -0.01, np.log(1.05)],
                                      jnp.float32))
    out_j = jdet.correct_loop(mj, jnp.int32(nk - 1), jnp.int32(1), corr.R, corr.t, corr.s)
    out_t = tdet.correct_loop(mt, nk - 1, 1, _t(corr.R), _t(corr.t), _t(corr.s))
    got, want = convert.map_to_numpy(out_t), {k: np.asarray(v) for k, v in out_j._asdict().items()}
    assert np.isfinite(got["kf_t"]).all() and np.isfinite(got["lm_pos"]).all()
    # the correction moved the keyframes (and by the same amount in both)
    assert np.abs(got["kf_t"][:nk] - d["kf_t"][:nk]).max() > 1e-3
    for k in ("kf_R", "kf_t", "lm_pos"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3, err_msg=k)


def test_global_ba_on_slice_map(slice_map):
    d, K = slice_map
    d = dict(d)
    # keep landmarks seen by two or more keyframes (a single-view landmark
    # has a rank-2 point block whose fp32 inverse sends XLA and torch down
    # different LM paths; tests/test_torch_mapping.py)
    lm = d["kf_lm_idx"][d["kf_kp_valid"]]
    seen = np.bincount(lm[lm >= 0], minlength=len(d["lm_valid"]))
    d["lm_valid"] = d["lm_valid"] & (seen >= 2)
    mj, mt = _maps(d)
    cj = JCam.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    ct = TCam.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device="cpu")
    out_j, rj = jba.global_ba(mj, cj, iters=4)
    out_t, rt = tba.global_ba(mt, ct, iters=4)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-3)
    assert float(rt.final_cost) < float(rt.initial_cost)
    np.testing.assert_allclose(out_t.kf_R.numpy(), np.asarray(out_j.kf_R), atol=1e-3)
    np.testing.assert_allclose(out_t.kf_t.numpy(), np.asarray(out_j.kf_t), atol=1e-3)
