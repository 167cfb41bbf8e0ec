"""Port parity, dist/: gloo worlds of 1, 2 and 4 CPU processes
(``dist.mesh.run_world``) against the JAX package on the 8-device virtual
mesh of tests/conftest.py, on the same numpy inputs:

- ``distributed_bundle_adjust`` (slots sharded; tests/test_dist_ba.py's
  problems, N = 300 and the ragged N = 301);
- ``sharded_global_ba_problem`` (keyframes sharded; tests/test_sharded_map.py's
  problems: converging, against the port's dense solver, world-size
  invariance, camera-axis padding at C = 13);
- ``sharded_bow_scores`` on 37 rows, and ``sharded_global_ba`` over a small
  map of the port's tracker (120x160 orbit, 6 keyframes);
- ``ResidentMap``: insert -> local_ba -> loop_scores -> global_ba
  (tests/test_resident_map.py's payloads, every landmark in every
  keyframe), with residency after each step.

Tolerances: camera translations within 2e-4 of JAX's (the bar of
tests/test_sharded_map.py:100, JAX's own spread across mesh sizes), the
resident sequence's within 3e-4 (tests/test_resident_map.py:147), final
costs within 1e-4 relative, BoW scores within 1e-5. The resident local BA
is held bit for bit to the port's single-device ``local_ba``: the halo
carries the window rows' bits exactly and every rank solves the same
window. Every rank must return the same replicated result.

The worlds run once per module, all three at once; their processes never
import JAX (the work they do is ``_world_cases`` below).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
BA_CAM = (460.0, 460.0, 320.0, 240.0)       # tests/test_ba.py
MAP_CAM = (460.0, 460.0, 160.0, 120.0)      # tests/test_sharded_map.py, test_resident_map.py
RES_CFG = (16, 256, 64)                      # MapConfig of tests/test_resident_map.py
RES_W = 32


def _se3_exp(xis):
    from lpslam_tpu_torch.geometry.se3 import se3_exp

    T = se3_exp(torch.from_numpy(np.asarray(xis, np.float32)))
    return T.R.numpy(), T.t.numpy()


def ba_problem(seed, C=6, P=300, N=300, noise_px=0.4):
    """tests/test_ba.py's build_problem in numpy (poses through the port's
    se3_exp): dict of BAProblem fields, t_gt."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 9, P)],
                   -1).astype(np.float32)
    xis = [[0.15 * c, 0.02 * c, 0.05 * c, 0.01 * c, -0.02 * c, 0.005 * c] for c in range(C)]
    R_gt, t_gt = _se3_exp(xis)
    obs_lm = np.full((C, N), -1, np.int32)
    obs_uv = np.zeros((C, N, 2), np.float32)
    for c in range(C):
        p_c = pts @ R_gt[c].T + t_gt[c]
        uv = np.stack([460 * p_c[:, 0] / p_c[:, 2] + 320, 460 * p_c[:, 1] / p_c[:, 2] + 240], -1)
        sel = rng.permutation(P)[: int(0.8 * N)]
        obs_lm[c, : len(sel)] = sel
        obs_uv[c, : len(sel)] = uv[sel] + rng.normal(0, noise_px, (len(sel), 2))
    R0, t0 = R_gt.copy(), t_gt.copy()
    for c in range(2, C):
        dR, dt = _se3_exp(rng.normal(0, 0.01, (1, 6)))
        R0[c] = dR[0] @ R0[c]
        t0[c] = dR[0] @ t0[c] + dt[0]
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return dict(cam_R=R0, cam_t=t0, points=pts0, obs_lm=obs_lm, obs_uv=obs_uv,
                obs_sigma2=np.ones((C, N), np.float32), cam_fixed=np.arange(C) < 2,
                point_valid=np.ones((P,), bool)), t_gt


def map_problem(C=16, Pn=256, N=64, noise=0.02, seed=0):
    """tests/test_sharded_map.py's _make_problem in numpy."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn),
                    rng.uniform(4, 8, Pn)], -1).astype(np.float32)
    R_gt, t_gt = _se3_exp([[0.08 * c, 0.02 * c, 0.01 * c, 0.005 * c, -0.004 * c, 0.0]
                           for c in range(C)])
    obs_lm = np.full((C, N), -1, np.int32)
    obs_uv = np.zeros((C, N, 2), np.float32)
    for c in range(C):
        p_c = pts @ R_gt[c].T + t_gt[c]
        uv = np.stack([460 * p_c[:, 0] / p_c[:, 2] + 160, 460 * p_c[:, 1] / p_c[:, 2] + 120], -1)
        sel = rng.permutation(Pn)[:N]
        obs_lm[c] = sel
        obs_uv[c] = uv[sel] + rng.normal(0, 0.3, (N, 2))
    t0 = t_gt + rng.normal(0, noise, t_gt.shape).astype(np.float32)
    pts0 = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
    t0[:2] = t_gt[:2]
    return dict(cam_R=R_gt, cam_t=t0, points=pts0, obs_lm=obs_lm, obs_uv=obs_uv,
                obs_sigma2=np.ones((C, N), np.float32), cam_fixed=np.arange(C) < 2,
                point_valid=np.ones((Pn,), bool)), t_gt


def resident_payloads(C=10, Pn=64, N=64, noise=0.02, seed=0):
    """tests/test_resident_map.py's _payloads in numpy (keyframe payloads,
    the perturbed landmarks, their BoW rows), with Pn = N: every keyframe
    sees every landmark. At its Pn = 200 a 6-keyframe window leaves landmarks
    with one view, whose rank-2 point blocks make the window BA chaotic in
    fp32: JAX's local_ba and the port's land 0.107 apart there (ROADMAP
    Queue 3), at Pn = 64 within 1e-6."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn),
                    rng.uniform(4, 8, Pn)], -1).astype(np.float32)
    R_gt, t_gt = _se3_exp([[0.08 * c, 0.02 * c, 0.01 * c, 0.005 * c, -0.004 * c, 0.0]
                           for c in range(C)])
    kfs = []
    for c in range(C):
        p_c = pts @ R_gt[c].T + t_gt[c]
        uv = np.stack([460 * p_c[:, 0] / p_c[:, 2] + 160, 460 * p_c[:, 1] / p_c[:, 2] + 120], -1)
        sel = rng.permutation(Pn)[:N]
        t0 = t_gt[c] if c < 2 else t_gt[c] + rng.normal(0, noise, 3)
        kfs.append(dict(R=R_gt[c], t=t0.astype(np.float32),
                        uv=(uv[sel] + rng.normal(0, 0.3, (N, 2))).astype(np.float32),
                        desc=rng.integers(0, 2**32, (N, 8), dtype=np.uint32),
                        kp_valid=np.ones(N, bool), lm_idx=sel.astype(np.int32),
                        frame_id=c * 3))
    pts0 = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
    db = np.random.default_rng(2).uniform(0, 1, (C, RES_W)).astype(np.float32)
    return dict(kfs=kfs, pts0=pts0, db=db, t_gt=t_gt)


def tracker_map():
    """A map of the port's host tracking path (120x160 orbit), as numpy."""
    from lpslam_tpu_torch import convert
    from lpslam_tpu_torch.frontend.tracker import MonoTracker, TrackerConfig
    from lpslam_tpu_torch.geometry.camera import PinholeCamera
    from lpslam_tpu_torch.io.synthetic import make_sequence
    from lpslam_tpu_torch.kernels.orb import OrbParams
    from lpslam_tpu_torch.mapstore.store import MapConfig

    seq = make_sequence(num_frames=30, h=120, w=160, seed=1, motion="orbit", fx=115.0)
    K = seq.K
    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], "cpu")
    eng = MonoTracker(cam, TrackerConfig(orb=OrbParams(256, 2), map_cfg=MapConfig(16, 2048, 256)),
                      device="cpu")
    for img in seq.images:
        eng.process(img)
    d = convert.map_to_numpy(eng.map)
    assert int(d["n_kf"]) >= 4, int(d["n_kf"])
    return d, (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))


def _cases():
    m, map_cam = tracker_map()
    rng = np.random.default_rng(0)
    return {
        "dba": ("dba", ba_problem(7)[0], BA_CAM, dict(iters=12)),
        "dba_ragged": ("dba", ba_problem(8, N=301)[0], BA_CAM, dict(iters=12)),
        "sgba_converge": ("sgba", map_problem()[0], MAP_CAM, dict(iters=8, cg_iters=20)),
        "sgba_dense": ("sgba", map_problem(seed=3)[0], MAP_CAM, dict(iters=10, cg_iters=25)),
        "sgba_invariance": ("sgba", map_problem(seed=5)[0], MAP_CAM, dict(iters=4, cg_iters=12)),
        "sgba_padding": ("sgba", map_problem(C=13, seed=7)[0], MAP_CAM, dict(iters=6)),
        "bow": ("bow", dict(db=rng.uniform(0, 1, (37, 64)).astype(np.float32),
                            q=rng.uniform(0, 1, (64,)).astype(np.float32)), None, {}),
        "map": ("map", m, map_cam, dict(iters=6)),
        "resident": ("resident", resident_payloads(), MAP_CAM, {}),
    }


# ---------------------------------------------------------------------------
# the port, in each rank of a world (no JAX in these processes)
# ---------------------------------------------------------------------------


def _t(d):
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.view(np.int32) if v.dtype == np.uint32 else v)) for k, v in d.items()}


def _np_result(res):
    return {k: np.asarray(getattr(res, k).numpy()) for k in
            ("cam_R", "cam_t", "points", "initial_cost", "final_cost", "obs_inlier")}


def _resident_sequence(mesh, d, cam):
    from lpslam_tpu_torch.backend.ba import local_ba
    from lpslam_tpu_torch.dist import ResidentMap
    from lpslam_tpu_torch.mapstore.store import MapConfig

    rm = ResidentMap(mesh, MapConfig(*RES_CFG), vocab_words=RES_W)
    full = rm.full_map()
    Pn = len(d["pts0"])
    rm.put(full._replace(
        lm_pos=torch.cat([torch.from_numpy(d["pts0"]), full.lm_pos[Pn:]]),
        lm_valid=torch.arange(full.lm_valid.shape[0]) < Pn,
        lm_n_obs=torch.where(torch.arange(full.lm_n_obs.shape[0]) < Pn, 3, 0).to(torch.int32),
        n_lm=torch.tensor(Pn, dtype=torch.int32)))
    steps = {"put": rm.residency_ok()}
    for i, kf in enumerate(d["kfs"]):
        k = _t({f: kf[f] for f in ("R", "t", "uv", "desc", "kp_valid", "lm_idx")})
        rm.insert_keyframe(k["R"], k["t"], k["uv"], k["desc"], k["kp_valid"], k["lm_idx"],
                           kf["frame_id"], bow_vec=torch.from_numpy(d["db"][i]))
    inserted = rm.full_map()
    steps["insert"] = rm.residency_ok()
    single, _ = local_ba(inserted, cam, window=rm.window, iters=4)
    rm.local_ba(cam, iters=4)
    steps["local_ba"] = rm.residency_ok()
    after_local = rm.full_map()
    scores = rm.loop_scores(torch.from_numpy(d["db"][-1]))
    _, res = rm.global_ba(cam, iters=8, cg_iters=20)
    steps["global_ba"] = rm.residency_ok()
    final = rm.full_map()
    return dict(
        residency=steps, n_kf=int(final.n_kf), kf_frame_id=inserted.kf_frame_id.numpy(),
        inserted_kf_t=inserted.kf_t.numpy(), lm_n_obs=inserted.lm_n_obs.numpy(),
        local_kf_t=after_local.kf_t.numpy(), local_lm_pos=after_local.lm_pos.numpy(),
        single_kf_t=single.kf_t.numpy(), single_lm_pos=single.lm_pos.numpy(),
        scores=scores.numpy(), kf_t=final.kf_t.numpy(), lm_pos=final.lm_pos.numpy(),
        initial_cost=float(res.initial_cost), final_cost=float(res.final_cost))


def _world_cases(mesh, cases):
    """Every case on this rank; results as numpy."""
    from lpslam_tpu_torch import convert
    from lpslam_tpu_torch.backend.ba import BAProblem
    from lpslam_tpu_torch.dist import (distributed_bundle_adjust, sharded_bow_scores,
                                       sharded_global_ba, sharded_global_ba_problem)
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    torch.set_num_threads(1)
    out = {}
    for name, (kind, data, cam_args, kw) in cases.items():
        cam = None if cam_args is None else PinholeCamera.make(*cam_args, "cpu")
        if kind == "dba":
            out[name] = _np_result(distributed_bundle_adjust(BAProblem(**_t(data)), cam,
                                                             mesh=mesh, **kw))
        elif kind == "sgba":
            out[name] = _np_result(sharded_global_ba_problem(BAProblem(**_t(data)), cam,
                                                             mesh=mesh, **kw))
        elif kind == "bow":
            out[name] = sharded_bow_scores(torch.from_numpy(data["db"]),
                                           torch.from_numpy(data["q"]), mesh=mesh).numpy()
        elif kind == "map":
            m2, res = sharded_global_ba(convert.map_from_numpy(data, "cpu"), cam, mesh=mesh, **kw)
            out[name] = dict(_np_result(res), map=convert.map_to_numpy(m2))
        else:
            out[name] = _resident_sequence(mesh, data, cam)
    return out


# ---------------------------------------------------------------------------
# fixtures: the worlds, and JAX on the virtual mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _jax_problem(d):
    import jax.numpy as jnp
    from lpslam_tpu.backend.ba import BAProblem as JProblem

    return JProblem(**{k: jnp.asarray(v) for k, v in d.items()})


def _jax_resident(d, cam):
    import jax.numpy as jnp
    from lpslam_tpu.dist import ResidentMap, make_mesh
    from lpslam_tpu.mapstore import MapConfig

    rm = ResidentMap(make_mesh(8, axis_name="kf"), MapConfig(*RES_CFG), vocab_words=RES_W)
    Pn = len(d["pts0"])
    rm.put(rm.m._replace(lm_pos=rm.m.lm_pos.at[:Pn].set(jnp.asarray(d["pts0"])),
                         lm_valid=rm.m.lm_valid.at[:Pn].set(True),
                         lm_n_obs=rm.m.lm_n_obs.at[:Pn].set(3), n_lm=jnp.int32(Pn)))
    for i, kf in enumerate(d["kfs"]):
        rm.insert_keyframe(kf["R"], kf["t"], kf["uv"], kf["desc"], kf["kp_valid"],
                           kf["lm_idx"], kf["frame_id"], bow_vec=d["db"][i])
    inserted_kf_t = np.asarray(rm.m.kf_t)
    rm.local_ba(cam, iters=4)
    local_kf_t = np.asarray(rm.m.kf_t)
    scores = np.asarray(rm.loop_scores(jnp.asarray(d["db"][-1])))
    _, res = rm.global_ba(cam, iters=8, cg_iters=20)
    assert rm.residency_ok()
    return dict(inserted_kf_t=inserted_kf_t, local_kf_t=local_kf_t, scores=scores,
                kf_t=np.asarray(rm.m.kf_t), final_cost=float(res.final_cost))


def _jax_cases(cases):
    """The same cases through the JAX package on the 8-device mesh."""
    import jax.numpy as jnp
    from lpslam_tpu.dist import (distributed_bundle_adjust, make_mesh, sharded_bow_scores,
                                 sharded_global_ba, sharded_global_ba_problem)
    from lpslam_tpu.geometry import PinholeCamera as JCam
    from lpslam_tpu.mapstore import MapStore

    mesh = make_mesh(8)
    out = {}
    for name, (kind, data, cam_args, kw) in cases.items():
        cam = None if cam_args is None else JCam.make(*cam_args)
        if kind == "dba":
            res = distributed_bundle_adjust(_jax_problem(data), cam, mesh=mesh, **kw)
        elif kind == "sgba":
            res = sharded_global_ba_problem(_jax_problem(data), cam, mesh=mesh, **kw)
        elif kind == "bow":
            out[name] = np.asarray(sharded_bow_scores(jnp.asarray(data["db"]),
                                                      jnp.asarray(data["q"]), mesh=mesh))
            continue
        elif kind == "map":
            m = MapStore(**{k: jnp.asarray(v) for k, v in data.items()})
            _, res = sharded_global_ba(m, cam, mesh=mesh, **kw)
        else:
            out[name] = _jax_resident(data, cam)
            continue
        out[name] = {k: np.asarray(getattr(res, k)) for k in
                     ("cam_t", "points", "initial_cost", "final_cost")}
    return out


@pytest.fixture(scope="module")
def results(cases):
    """({n: [rank 0's results, ...]} of the gloo worlds of 1, 2 and 4, JAX's
    results): the worlds run in their processes while JAX runs here."""
    from lpslam_tpu_torch.dist.mesh import run_world

    with ThreadPoolExecutor(len(WORLDS)) as ex:
        futs = {n: ex.submit(run_world, _world_cases, n, cases, timeout=300.0) for n in WORLDS}
        ref = _jax_cases(cases)
        return {n: f.result() for n, f in futs.items()}, ref


@pytest.fixture(scope="module")
def worlds(results):
    return results[0]


@pytest.fixture(scope="module")
def jax_results(results):
    return results[1]


def _close_cost(a, b, rel=1e-4):
    assert abs(float(a) - float(b)) <= rel * abs(float(b)), (float(a), float(b))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_every_rank_returns_the_same_result(worlds):
    for n, ranks in worlds.items():
        for r in ranks[1:]:
            for name in ("dba", "sgba_converge", "bow", "map"):
                a, b = ranks[0][name], r[name]
                if isinstance(a, dict):
                    for k in ("cam_t", "points", "final_cost"):
                        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{n} {name} {k}")
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{n} {name}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["dba", "dba_ragged"])
def test_distributed_bundle_adjust_matches_jax(worlds, jax_results, cases, n, case):
    ours, ref = worlds[n][0][case], jax_results[case]
    np.testing.assert_allclose(ours["cam_t"], ref["cam_t"], atol=2e-4)
    _close_cost(ours["final_cost"], ref["final_cost"])
    _close_cost(ours["initial_cost"], ref["initial_cost"])
    # both converge (tests/test_dist_ba.py's bars)
    _, t_gt = ba_problem(7) if case == "dba" else ba_problem(8, N=301)
    tol = 1e-2 if case == "dba" else 2e-2
    assert np.linalg.norm(ours["cam_t"][2:6] - t_gt[2:6], axis=1).max() < tol
    assert ours["final_cost"] < 0.05 * ours["initial_cost"]
    if case == "dba_ragged":
        assert ours["obs_inlier"].shape == (6, 304 if n == 4 else 302 if n == 2 else 301)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", ["sgba_converge", "sgba_dense", "sgba_invariance",
                                  "sgba_padding"])
def test_sharded_global_ba_problem_matches_jax(worlds, jax_results, n, case):
    ours, ref = worlds[n][0][case], jax_results[case]
    C = 13 if case == "sgba_padding" else 16
    np.testing.assert_allclose(ours["cam_t"][:C], ref["cam_t"][:C], atol=2e-4)
    _close_cost(ours["final_cost"], ref["final_cost"])
    assert ours["cam_t"].shape[0] == C + (-C % n)    # padded to the world


def test_sharded_global_ba_converges_and_matches_dense(worlds, cases):
    """tests/test_sharded_map.py's bars: converges to ground truth, and lands
    within 2x of the port's dense single-device solver's error."""
    from lpslam_tpu_torch.backend.ba import BAProblem, bundle_adjust
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    _, t_gt = map_problem()
    for n in WORLDS:
        res = worlds[n][0]["sgba_converge"]
        assert res["final_cost"] < 0.05 * res["initial_cost"]
        assert np.linalg.norm(res["cam_t"] - t_gt, axis=1).max() < 0.02
    data, t_gt = map_problem(seed=3)
    dense = bundle_adjust(BAProblem(**_t(data)), PinholeCamera.make(*MAP_CAM, "cpu"), iters=10)
    d_t = np.linalg.norm(dense.cam_t.numpy() - t_gt, axis=1).max()
    for n in WORLDS:
        s_t = np.linalg.norm(worlds[n][0]["sgba_dense"]["cam_t"] - t_gt, axis=1).max()
        assert s_t < max(2.0 * d_t, 5e-3), (n, s_t, d_t)
    _, t_gt = map_problem(C=13, seed=7)
    for n in WORLDS:
        err = np.linalg.norm(worlds[n][0]["sgba_padding"]["cam_t"][:13] - t_gt, axis=1)
        assert err.max() < 0.05


def test_world_size_invariance(worlds):
    """Worlds of 1, 2 and 4 give the same solution (2e-4, JAX's bar)."""
    for case in ("dba", "sgba_invariance", "map"):
        base = worlds[1][0][case]["cam_t"]
        for n in WORLDS[1:]:
            np.testing.assert_allclose(worlds[n][0][case]["cam_t"][:base.shape[0]], base,
                                       atol=2e-4, err_msg=f"{case} world {n}")


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_bow_scores_match_jax(worlds, jax_results, cases, n):
    got = worlds[n][0]["bow"]
    db, q = cases["bow"][1]["db"], cases["bow"][1]["q"]
    want = (db / np.linalg.norm(db, axis=1, keepdims=True)) @ (q / np.linalg.norm(q))
    assert got.shape == (37,)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, jax_results["bow"], atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_global_ba_over_a_tracker_map(worlds, jax_results, cases, n):
    data = cases["map"][1]
    nk = int(data["n_kf"])
    ours, ref = worlds[n][0]["map"], jax_results["map"]
    assert ours["final_cost"] <= ours["initial_cost"]
    assert int(ours["map"]["n_kf"]) == nk
    assert np.isfinite(ours["map"]["kf_t"][:nk]).all()
    np.testing.assert_array_equal(ours["map"]["kf_uv"], data["kf_uv"])   # untouched leaves
    np.testing.assert_allclose(ours["cam_t"][:nk], ref["cam_t"][:nk], atol=2e-4)
    _close_cost(ours["final_cost"], ref["final_cost"])


@pytest.mark.parametrize("n", WORLDS)
def test_resident_sequence_matches_jax(worlds, jax_results, cases, n):
    ours, ref = worlds[n][0]["resident"], jax_results["resident"]
    d = cases["resident"][1]
    nk = len(d["kfs"])
    assert all(ours["residency"].values()), ours["residency"]
    assert ours["n_kf"] == nk
    # insert: slot values land across block boundaries, exactly
    np.testing.assert_array_equal(ours["inserted_kf_t"][:nk], np.stack([k["t"] for k in d["kfs"]]))
    np.testing.assert_array_equal(ours["kf_frame_id"][:nk], [k["frame_id"] for k in d["kfs"]])
    np.testing.assert_array_equal(ours["inserted_kf_t"], ref["inserted_kf_t"])
    assert ours["lm_n_obs"].sum() == 3 * len(d["pts0"]) + sum(len(k["lm_idx"]) for k in d["kfs"])
    # local BA: the halo window equals the single-device local_ba bit for bit
    np.testing.assert_array_equal(ours["local_kf_t"], ours["single_kf_t"])
    np.testing.assert_array_equal(ours["local_lm_pos"], ours["single_lm_pos"])
    np.testing.assert_allclose(ours["local_kf_t"], ref["local_kf_t"], atol=2e-4)
    np.testing.assert_allclose(ours["scores"][:nk], ref["scores"][:nk], atol=1e-5)
    np.testing.assert_allclose(ours["kf_t"], ref["kf_t"], atol=3e-4)
    _close_cost(ours["final_cost"], ref["final_cost"], rel=1e-3)
    assert ours["final_cost"] < ours["initial_cost"]
    # as near the ground truth as JAX comes on these payloads (0.027 m: with
    # 64 landmarks the solution sits further from it than at JAX's 200)
    err = np.linalg.norm(ours["kf_t"][:nk] - d["t_gt"], axis=1).max()
    assert err <= np.linalg.norm(ref["kf_t"][:nk] - d["t_gt"], axis=1).max() + 3e-4


def test_resident_sequence_world_invariance(worlds):
    base = worlds[1][0]["resident"]
    for n in WORLDS[1:]:
        r = worlds[n][0]["resident"]
        np.testing.assert_array_equal(r["local_kf_t"], base["local_kf_t"])
        np.testing.assert_allclose(r["kf_t"], base["kf_t"], atol=3e-4)


def test_world_of_one_without_a_process_group(cases, worlds):
    """No process group: the default mesh is a world of one in this process,
    and gives what the gloo world of one gives."""
    from lpslam_tpu_torch.backend.ba import BAProblem
    from lpslam_tpu_torch.dist import default_mesh, make_mesh, sharded_global_ba_problem
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    mesh = default_mesh()
    assert mesh.size == 1 and mesh.rank == 0 and mesh.device_mesh is None
    with pytest.raises(ValueError):
        make_mesh(2)
    _, data, cam_args, kw = cases["sgba_converge"]
    res = sharded_global_ba_problem(BAProblem(**_t(data)),
                                    PinholeCamera.make(*cam_args, "cpu"), **kw)
    np.testing.assert_array_equal(res.cam_t.numpy(), worlds[1][0]["sgba_converge"]["cam_t"])


def test_a_step_that_empties_the_active_set_is_refused():
    """The dist solvers take an LM step only if it lowers the cost and keeps
    half the active observations (backend.ba's rule). The JAX package's dist
    solvers compare costs alone (lpslam_tpu/dist/sharded_map.py:237), so a
    step that sends every point behind its camera or to NaN, costing 0, is
    taken there: on an H100 it turned a room map's global BA into NaN."""
    from lpslam_tpu_torch.dist.sharded_map import _accept

    t = torch.tensor
    assert bool(_accept(t(5.0), t(10.0), t(60.0), t(100.0)))
    assert not bool(_accept(t(0.0), t(10.0), t(0.0), t(100.0)))
    assert not bool(_accept(t(5.0), t(10.0), t(49.0), t(100.0)))
    assert not bool(_accept(t(float("nan")), t(10.0), t(100.0), t(100.0)))
    assert not bool(_accept(t(11.0), t(10.0), t(100.0), t(100.0)))
