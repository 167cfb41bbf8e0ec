"""Port parity, the chunk loop's options and the BA robustness hooks:
lpslam_tpu_torch against lpslam_tpu on the same frames and problems.

- One drive per package of ChunkedTracker(local_ba_every_chunk=False) on a
  16-keyframe store, the boundary set per chunk: boundary_compact = False,
  compact_period = 1 (twice), compact_enabled = False, the defaults.
  Statuses, keyframe flags and the carry's BA cursor (last_ba_frame) after
  every chunk equal JAX's; keyframes within +-1, landmarks within +-15%,
  ATE <= max(1.5 x JAX, JAX + 0.02 m) (the slice rules); the port never
  enters local_ba. The boundaries whose cull runs, the keyframes each culls
  and n_kf after each boundary equal JAX's.
- LPSLAM_BA_DAMPING / LPSLAM_BA_GUARD_TOL (read at import in both packages;
  patched here in both modules, with JAX's compiled programs dropped first
  so they trace the patched values): bundle_adjust and bundle_adjust_cg
  agree with JAX's under each of the ablation's three configurations within
  the BA parity tolerance (final cost 1e-3 relative, poses 1e-3); the
  relative damping changes the result; with the defaults the port is
  bit-equal to its solver before the hooks (the damping inline).
"""
import numpy as np
import pytest
import torch

import jax

from lpslam_tpu.backend import ba as jba
from lpslam_tpu.eval import ate_rmse as j_ate
from lpslam_tpu.frontend import device_loop as jdl
from lpslam_tpu.io.synthetic import make_sequence

from lpslam_tpu_torch.backend import ba as tba
from lpslam_tpu_torch.frontend import device_loop as tdl

from test_torch_mapping import _problem, _scene_map, _tcam

torch.set_num_threads(1)

CHUNK = 8
# the ablation's configurations (tools/ablate_ba_robustness.py CONFIGS)
CONFIGS = [("absolute", 1e12), ("absolute", 1e-2), ("relative", 1e12)]


@pytest.fixture(scope="module")
def orbit():
    return make_sequence(num_frames=52, h=120, w=160, seed=1, motion="orbit", fx=115.0)


def _engine(pkg, seq, map_cfg):
    if pkg == "jax":
        from lpslam_tpu.frontend import MonoTracker, TrackerConfig, TrackerStatus
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.kernels.orb import OrbParams
        from lpslam_tpu.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
        kw = {}
    else:
        from lpslam_tpu_torch.frontend import MonoTracker, TrackerConfig, TrackerStatus
        from lpslam_tpu_torch.geometry import PinholeCamera
        from lpslam_tpu_torch.kernels.orb import OrbParams
        from lpslam_tpu_torch.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                 device="cpu")
        kw = {"device": "cpu"}
    cfg = TrackerConfig(orb=OrbParams(256, 2), map_cfg=MapConfig(*map_cfg, 256))
    eng = MonoTracker(cam, cfg, **kw)
    t = 0
    while eng.status != TrackerStatus.TRACKING and t < 12:
        eng.process(seq.images[t])
        t += 1
    assert eng.status == TrackerStatus.TRACKING
    return eng, t


# per chunk: (boundary_compact, compact_period, compact_enabled); the store
# nears its capacity from 16 - (2 * 3 + 2) = 8 keyframes on
SCHEDULE = [(False, 8, True), (True, 1, True), (True, 1, True), (True, 8, False),
            (True, 8, True)]


def _drive(pkg, seq, spy):
    """The chunk loop with no BA inside it over SCHEDULE's boundaries: per
    chunk the cull's culled keyframes (None where no cull ran), n_kf after
    the boundary and the carry's BA cursor; the per-frame outputs."""
    mod = jdl if pkg == "jax" else tdl
    culls = []
    if pkg == "jax":
        real = jdl._chunk_boundary

        def boundary(m, cam, any_kf, do_compact, *a):
            res = real(m, cam, any_kf, do_compact, *a)
            culls[-1] = int(res.n_kf_culled) if bool(any_kf & do_compact) else None
            return res

        spy.setattr(jdl, "_chunk_boundary", boundary)
    else:
        real_cull = tdl.cull_and_compact

        def cull(*a, **k):
            res = real_cull(*a, **k)
            culls[-1] = int(res.n_kf_culled)
            return res

        spy.setattr(tdl, "cull_and_compact", cull)
    eng, t = _engine(pkg, seq, (16, 4096))
    init_frame = t
    ct = mod.ChunkedTracker(eng, local_ba_every_chunk=False)
    n_kf, cursors = [], []
    for compact, period, enabled in SCHEDULE:
        ct.boundary_compact = compact
        ct.compact_period, ct.compact_enabled = period, enabled
        culls.append(None)
        ct.process_chunk(np.stack(seq.images[t:t + CHUNK]))
        t += CHUNK
        n_kf.append(int(eng.map.n_kf))
        cursors.append(int(ct._pending_carry.last_ba_frame))
    ct.sync()
    sts, _, pR, pt, kf, _, _ = ct.collect()
    tracked = sts == 2
    est = -np.einsum("bji,bj->bi", pR, pt)[tracked]
    gt = np.asarray([seq.poses_wc[init_frame + i].t for i in range(len(sts))])[tracked]
    return {"status": sts, "kf": kf, "cursors": cursors, "culls": culls, "n_kf": n_kf,
            "kf_chunks": kf.reshape(len(SCHEDULE), CHUNK).any(1).tolist(),
            "keyframes": eng._kf_count, "landmarks": eng.n_landmarks,
            "ate": j_ate(est, gt)[0]}


@pytest.fixture(scope="module")
def drives(orbit):
    entered = []
    with pytest.MonkeyPatch.context() as spy:
        real_ba = tba.local_ba
        spy.setattr(tba, "local_ba", lambda *a, **k: entered.append(1) or real_ba(*a, **k))
        ref = _drive("jax", orbit, spy)
        ours = _drive("torch", orbit, spy)
    return ref, ours, len(entered)


def test_no_ba_in_the_loop_matches_jax(drives):
    ref, ours, ba_calls = drives
    assert ba_calls == 0
    assert ref["status"].size == CHUNK * len(SCHEDULE) and (ref["status"] == 2).all(), ref
    np.testing.assert_array_equal(ours["status"], ref["status"])
    np.testing.assert_array_equal(ours["kf"], ref["kf"])
    # the BA cursor advances on every keyframe when the loop runs no BA
    assert ours["cursors"] == ref["cursors"], (ours["cursors"], ref["cursors"])
    assert ref["kf"].sum() >= 3
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert abs(ours["landmarks"] - ref["landmarks"]) <= 0.15 * ref["landmarks"], (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)


def test_compaction_options_match_jax(drives):
    ref, ours, _ = drives
    assert (ours["culls"], ours["n_kf"]) == (ref["culls"], ref["n_kf"]), (ours, ref)
    # a cull exactly at the boundaries whose chunk inserted a keyframe and
    # whose cull is on and due: compact_period = 1 far from the capacity,
    # the capacity under the defaults, never with compact_enabled = False
    # nor with boundary_compact = False
    for (compact, _, enabled), c, kf in zip(SCHEDULE, ref["culls"], ref["kf_chunks"]):
        assert (c is not None) == (compact and enabled and kf), ref
    assert ref["kf_chunks"][1] and ref["n_kf"][0] < 8, ref   # a periodic cull
    assert ref["n_kf"][3] >= 8 and ref["culls"][4] is not None, ref   # near capacity


def _hooks(monkeypatch, damping, tol):
    for mod in (jba, tba):
        monkeypatch.setattr(mod, "_BA_DAMPING", damping)
        monkeypatch.setattr(mod, "_BA_GUARD_TOL", tol)
    jax.clear_caches()  # the JAX solvers read the hooks when they trace


@pytest.fixture(scope="module")
def ba_scene():
    m_j, cam_j = _scene_map(3, n_kf=8)
    return _problem(m_j), cam_j


@pytest.mark.parametrize("damping,tol", CONFIGS)
@pytest.mark.parametrize("solver", ["bundle_adjust", "bundle_adjust_cg"])
def test_ba_hooks_match_jax(ba_scene, monkeypatch, solver, damping, tol):
    (pj, pt), cam_j = ba_scene
    _hooks(monkeypatch, damping, tol)
    try:
        r_j = getattr(jba, solver)(pj, cam_j, iters=6)
        r_t = getattr(tba, solver)(pt, _tcam(), iters=6)
    finally:
        jax.clear_caches()
    np.testing.assert_allclose(float(r_t.initial_cost), float(r_j.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(r_t.final_cost), float(r_j.final_cost), rtol=1e-3)
    np.testing.assert_allclose(r_t.cam_R.numpy(), np.asarray(r_j.cam_R), atol=1e-3)
    np.testing.assert_allclose(r_t.cam_t.numpy(), np.asarray(r_j.cam_t), atol=1e-3)
    assert float(r_j.final_cost) < float(r_j.initial_cost)
    if damping == "relative":
        monkeypatch.setattr(tba, "_BA_DAMPING", "absolute")
        r_abs = getattr(tba, solver)(pt, _tcam(), iters=6)
        assert float(r_abs.final_cost) != float(r_t.final_cost)
        assert not torch.equal(r_abs.points, r_t.points)


@pytest.mark.parametrize("solver", ["bundle_adjust", "bundle_adjust_cg"])
def test_ba_defaults_bit_equal_to_inline_damping(ba_scene, monkeypatch, solver):
    """Neither variable set: the hooks' defaults give the solver's results
    before the hooks bit for bit (absolute damping written inline, the
    guard's tolerance 1e12)."""
    from lpslam_tpu_torch.kernels.linalg import inv3x3_guarded

    (_, pt), _ = ba_scene
    assert (tba._BA_DAMPING, tba._BA_GUARD_TOL) == ("absolute", 1e12)
    ours = getattr(tba, solver)(pt, _tcam(), iters=6)

    def inline(prob, Hpp, lam):
        eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
        Hpp_inv = inv3x3_guarded(Hpp + (lam + 1e-8) * eye3, tol=1e12)
        if prob.point_fixed is not None:
            Hpp_inv = torch.where(prob.point_fixed[:, None, None], 0.0, Hpp_inv)
        return Hpp_inv

    monkeypatch.setattr(tba, "_point_inverse", inline)
    before = getattr(tba, solver)(pt, _tcam(), iters=6)
    for a, b in zip(ours, before):
        assert torch.equal(a, b)


def phase17_reference() -> dict:
    """The JAX package on the CPU over chip_smoke.py phase 4's frames with
    phase 17 drive (a)'s options (no BA in the loop, no boundary cull): the
    tracked count behind chip_smoke.JAX_OPTIONS_REF. The frames are the
    JAX package's own render of the room, undistorted with OpenCV's radtan
    map, as tools/jax_depth_reference.py does for the depth phases."""
    import json
    import sys
    import time
    from pathlib import Path

    import cv2
    import jax.numpy as jnp

    from lpslam_tpu.frontend import MonoTracker, TrackerConfig, TrackerStatus
    from lpslam_tpu.geometry import PinholeCamera
    from lpslam_tpu.io.benchmark import SyntheticBenchmark
    from lpslam_tpu.kernels.orb import OrbParams
    from lpslam_tpu.kernels.remap import remap_bilinear
    from lpslam_tpu.mapstore import MapConfig

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke

    h, w, chunk = 480, 640, smoke.CHUNK
    total = smoke.N_INIT + smoke.CHUNK * smoke.N_CHUNKS
    t0 = time.perf_counter()
    ds = SyntheticBenchmark(num_frames=total, h=h, w=w, seed=0, turns=1.08 * total / 556.0)
    frames = np.stack([np.clip(f.image, 0, 255).astype(np.uint8) for f in ds])
    intr = ds.intr
    K = np.array([[intr["fx"], 0, intr["cx"]], [0, intr["fy"], intr["cy"]], [0, 0, 1]])
    rmap = cv2.initUndistortRectifyMap(K, np.asarray(intr["dist"], np.float64), np.eye(3),
                                       K, (w, h), cv2.CV_32FC2)[0]
    render_s = time.perf_counter() - t0
    cam = PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    cfg = TrackerConfig(orb=OrbParams(num_keypoints=smoke.KEYPOINTS, num_levels=smoke.LEVELS),
                        map_cfg=MapConfig(128, 24576, smoke.KEYPOINTS))
    eng = MonoTracker(cam, cfg)
    t = 0
    while eng.status != TrackerStatus.TRACKING and t < smoke.N_INIT:
        eng.process(remap_bilinear(jnp.asarray(frames[t], jnp.float32), jnp.asarray(rmap)))
        t += 1
    init_frames = t
    ct = jdl.ChunkedTracker(eng, local_ba_every_chunk=False, rectify_map=rmap)
    ct.boundary_compact = False
    for _ in range(smoke.OPTION_CHUNKS):
        ct.process_chunk(frames[t:t + chunk])
        t += chunk
    ct.sync()
    sts, _, _, _, kf, _, _ = ct.collect()
    out = {"frames": int(len(sts)), "init_frames": init_frames,
           "tracked": int((sts == int(TrackerStatus.TRACKING)).sum()),
           "keyframes_inserted": int(kf.sum()), "n_kf": int(eng.map.n_kf),
           "render_s": render_s, "s": time.perf_counter() - t0}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_chunk_options.py
    phase17_reference()
