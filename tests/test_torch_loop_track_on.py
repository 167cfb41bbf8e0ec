"""Port parity, tracking after a loop correction: both packages track on
from one saved state.

The JAX VSLAMTracker drives tests/test_torch_loop_slice.py's 120x160 orbit
(its configuration and relaxed loop gates) to its first accepted closure;
chip_smoke.save_closure_states saves the map, the verdict and the
tracker's host state there. The orbit's 48 frames end five frames after
that closure, so the sequence runs on along the same orbit formula to
frame 66: three more chunks of 8. From the saved state both packages
apply the verdict as VSLAMTracker._loop_apply does and track the
remaining frames with loop closing off (chip_smoke.track_on).

Margins: equal statuses, keyframes inserted within 1, and per 16-frame
window the largest camera-centre distance within the parting rule of
tools/jax_closure_reference.py --track-on: 2 x the larger of the two
packages' one-ulp spreads on this orbit plus 1e-4 (SPREADS, measured by
`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_loop_track_on.py`).
That window check is a coarse bound: from the correction on the drive is
chaotic, and JAX's own spread reads 0.28 and 0.47 units in the two
windows. A per-frame check at the kf_t spread cannot stand in for it
either: the packages' features differ at descriptor ties, which a kf_t
move does not reach, so the first frame after the correction already
differs by 3.1e-3 units against one-ulp spreads of 2.4e-4 (JAX) and
7.5e-4 (port) (the same script). The test that can catch a port fault on
this path is test_track_frame_after_correction_given_jax_features: fed
JAX's features, the port's track_frame gives the same inliers and
associations and the pose within 1e-5.

Also the engine-state round trip (a state saved by either package loads
into both with equal fields) and the parting rule on hand-made drives.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.geometry.se3 import se3_exp
from lpslam_tpu.io.synthetic import make_sequence
from lpslam_tpu.loop.detector import LoopCloser as JLoopCloser
from lpslam_tpu.loop.detector import LoopConfig as JLoopConfig
from lpslam_tpu.mapstore.checkpoint import save_map as jax_save_map

from lpslam_tpu_torch.loop.detector import LoopConfig as TLoopConfig
from lpslam_tpu_torch.mapstore.checkpoint import save_map as torch_save_map

import chip_smoke

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import jax_closure_reference as closure_ref  # noqa: E402

torch.set_num_threads(1)

CONFIG = {"mode": "mono", "keypoints": 256, "levels": 2, "max_keyframes": 16,
          "max_landmarks": 2048, "loop_closure": True, "loop_async": False,
          "chunk_size": 8, "loop_global_ba_iters": 2}
GATES = dict(min_gap=6, min_score=0.12, consistency=1, global_ba_iters=2)
ORBIT = 48          # the loop slice's orbit; its formula runs on to FRAMES
FRAMES = 67
# per 16-frame window after the correction (frames 43-58, 59-66): the
# largest camera-centre distance between a package's drive and its drive
# from kf_t one ulp further from zero (my CPU run, torch.set_num_threads(1))
SPREADS = {"jax": [0.28217176459244137, 0.46583895391076613],
           "torch": [0.01916576142136782, 0.1154682048512217]}
TOL = [2 * max(j, t) + chip_smoke.PART_FLOOR for j, t in zip(SPREADS["jax"], SPREADS["torch"])]


def _orbit():
    """The loop slice's 48-frame orbit, run on to FRAMES frames: the same
    poses (make_sequence's orbit at tt = t / 47), so its first 48 frames
    are the slice's bytes."""
    def pose(t):
        tt = t / (ORBIT - 1)
        xi = np.array([0.6 * np.sin(2 * np.pi * tt), 0.3 * (1 - np.cos(2 * np.pi * tt)),
                       0.35 * np.sin(np.pi * tt), 0.04 * np.sin(2 * np.pi * tt),
                       0.06 * np.sin(2 * np.pi * tt), 0.03 * tt], np.float32)
        return se3_exp(jnp.asarray(xi))

    return make_sequence(num_frames=FRAMES, h=120, w=160, seed=1, motion="orbit", fx=115.0,
                         poses=[pose(t) for t in range(FRAMES)])


def _gates(tracker, config_cls):
    tracker._loop_cfg = lambda: config_cls(**GATES)


def _closure_state(directory: str) -> tuple:
    """(state prefix, frames, ground truth): the JAX drive's first accepted
    closure on the orbit, saved with its engine state into `directory`."""
    seq = _orbit()
    gt = np.asarray([p.t for p in seq.poses_wc], np.float64)
    api = closure_ref.jax_api()
    tracker = api.tracker(api.camera(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2]),
                          dict(CONFIG))
    _gates(tracker, JLoopConfig)
    saved, undo = chip_smoke.save_closure_states(
        JLoopCloser, directory, "jax", gt, jax_save_map, np.asarray,
        tracker_of=lambda: tracker, room={"kind": "orbit", "frames": FRAMES})
    try:
        for t in range(ORBIT):
            tracker.process_image(api.Entry(timestamp=t / 20.0, image=seq.images[t]))
            if saved:
                break
    finally:
        undo()
    assert saved and saved[0][1], saved        # the reference closes here
    frames = chip_smoke.Frames(np.asarray(seq.images), lambda t: seq.images[t])
    return saved[0][0], frames, gt


@pytest.fixture(scope="module")
def closure(tmp_path_factory):
    return _closure_state(str(tmp_path_factory.mktemp("closure")))


def _drive(pkg, closure, perturb=False):
    prefix, frames, _ = closure
    if pkg == "jax":
        api, cfg = closure_ref.jax_api(), JLoopConfig
    else:
        api, cfg = chip_smoke.port_api(torch.device("cpu")), TLoopConfig
    return chip_smoke.track_on(api, prefix, frames, perturb=perturb,
                               prepare=lambda tr: _gates(tr, cfg))


def _engine_fields(tracker, to_np) -> dict:
    e = tracker.engine
    out = {k: to_np(getattr(e.map, k)) for k in e.map._fields}
    for k in ("kf_desc", "lm_desc"):    # the port holds the words' int32 bit patterns
        out[k] = out[k].view(np.uint32)
    out.update(pose_R=to_np(e.pose.R), pose_t=to_np(e.pose.t), vel_R=to_np(e.velocity.R),
               vel_t=to_np(e.velocity.t), status=int(e.status),
               sigma_pos=np.asarray(e.last_sigma_pos), sigma_rot=e.last_sigma_rot,
               pending=tracker._loop_pending_kfs,
               boundary=tracker._chunk_tracker()._boundary_count,
               **{k: getattr(e, k) for k in chip_smoke.ENGINE_INTS})
    return out


def _loaded(pkg, prefix, cam, config):
    api = closure_ref.jax_api() if pkg == "jax" else chip_smoke.port_api(torch.device("cpu"))
    tracker = api.tracker(api.camera(*cam), config)
    chip_smoke.load_engine_state(api, tracker, prefix)
    return tracker, api.to_np


def test_engine_state_round_trip(closure, tmp_path):
    """The JAX-saved state loads into both packages with equal fields; the
    port's tracker saves it again (its map through its own save_map), and
    that loads into both with the same fields."""
    prefix = closure[0]
    with np.load(prefix + "_engine.npz") as f:
        saved = {k: f[k] for k in f.files}
    cam = [float(c) for c in saved["cam"]]
    config = dict(CONFIG)
    ref = None
    for src in ("jax", "torch"):
        if src == "torch":
            tracker, to_np = _loaded("torch", prefix, cam, config)
            prefix = str(tmp_path / "port_k7")
            torch_save_map(tracker.engine.map, prefix + "_map.npz")
            chip_smoke.save_engine_state(tracker, prefix + "_engine.npz", to_np,
                                         room={"kind": "orbit", "frames": FRAMES})
            with np.load(prefix + "_engine.npz") as f:
                again = {k: f[k] for k in f.files}
            assert again.keys() == saved.keys()
            for k in saved:
                np.testing.assert_array_equal(again[k], saved[k], err_msg=k)
        for pkg in ("jax", "torch"):
            tracker, to_np = _loaded(pkg, prefix, cam, config)
            fields = _engine_fields(tracker, to_np)
            assert fields["frame_id"] == int(saved["next_frame"]) == int(saved["frame_id"])
            assert fields["status"] == int(saved["status"])
            assert fields["pending"] == int(saved["loop_pending_kfs"]) > 0
            assert fields["boundary"] == int(saved["boundary_count"]) > 0
            if ref is None:
                ref = fields
                continue
            assert fields.keys() == ref.keys()
            for k in ref:
                np.testing.assert_array_equal(fields[k], ref[k], err_msg=f"{src} -> {pkg}: {k}")


def test_track_on_matches_jax(closure):
    ref = _drive("jax", closure)
    ours = _drive("torch", closure)
    assert ref["start_frame"] == ours["start_frame"] < ORBIT
    assert ref["fid"] == ours["fid"] == list(range(ref["start_frame"], FRAMES))
    assert ours["status"] == ref["status"]
    assert set(ref["status"]) == {"TRACKING"}
    assert abs(len(ours["keyframes_inserted"]) - len(ref["keyframes_inserted"])) <= 1, (
        ours["keyframes_inserted"], ref["keyframes_inserted"])
    assert ref["keyframes_inserted"]           # the drive maps after the correction
    dist = chip_smoke.window_distances(ours, ref)
    assert len(dist) == len(TOL)
    assert all(d <= t for d, t in zip(dist, TOL)), (dist, TOL)


def test_track_frame_after_correction_given_jax_features(closure, tmp_path):
    """From JAX's state just after the correction (the verdict applied, no
    frame fed), loaded into both packages, the next frame's track_frame fed
    JAX's ORB features: the same inliers and landmark associations, the
    pose within 1e-5. After a correction the packages' tracking differs only
    where their features do (descriptor bits at ties, tests/test_torch_orb.py)."""
    import jax

    from lpslam_tpu.frontend.tracker import track_frame as jax_track_frame
    from lpslam_tpu.geometry.se3 import se3_compose as jax_compose
    from lpslam_tpu.kernels.orb import extract_orb as jax_extract_orb
    from lpslam_tpu_torch.frontend.tracker import track_frame
    from lpslam_tpu_torch.geometry.se3 import se3_compose
    from lpslam_tpu_torch.kernels.orb import OrbFeatures

    prefix, frames, _ = closure
    keep = {}
    drive = chip_smoke.track_on(closure_ref.jax_api(), prefix, frames, stop=0, keep=keep,
                                prepare=lambda tr: _gates(tr, JLoopConfig))
    assert drive["fid"] == []
    pre = str(tmp_path / "after")
    jax_save_map(keep["tracker"].engine.map, pre + "_map.npz")
    chip_smoke.save_engine_state(keep["tracker"], pre + "_engine.npz", np.asarray)
    frame = drive["start_frame"]
    with np.load(prefix + "_engine.npz") as f:
        cam = [float(c) for c in f["cam"]]
    ej = _loaded("jax", pre, cam, dict(CONFIG))[0].engine
    et = _loaded("torch", pre, cam, dict(CONFIG))[0].engine
    cfg = ej.cfg
    fj = jax.tree.map(lambda x: x[0], jax.vmap(lambda im: jax_extract_orb(im, cfg.orb))(
        jnp.asarray(frames.raw[frame], jnp.float32)[None]))
    ft = OrbFeatures(*(torch.from_numpy(np.array(x)) for x in fj))
    ft = ft._replace(desc=torch.from_numpy(np.array(fj.desc).view(np.int32)))
    M, cap = ej.map.lm_pos.shape[0], cfg.track_local_cap
    cap = cap if cap and cap < M else None
    rj = jax_track_frame(ej.map, jax_compose(ej.velocity, ej.pose), ej.cam, fj,
                         cfg.match_radius, cfg.match_max_hamming, local_cap=cap)
    rt = track_frame(et.map, se3_compose(et.velocity, et.pose), et.cam, ft,
                     cfg.match_radius, cfg.match_max_hamming, local_cap=cap,
                     image_hw=frames.raw[frame].shape[-2:])
    assert int(rt.n_inliers) == int(rj.n_inliers) >= cfg.min_inliers
    np.testing.assert_array_equal(rt.kp_lm_idx.numpy(), np.asarray(rj.kp_lm_idx))
    np.testing.assert_allclose(rt.pose.R.numpy(), np.asarray(rj.pose.R), atol=1e-5)
    np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t), atol=1e-5)


def _fake(lost=(), kf=3, centres=None, start=100, n=48):
    c = np.zeros((n, 3)) if centres is None else np.asarray(centres, float)
    return {"fid": list(range(start, start + n)),
            "status": ["LOST" if start + i in lost else "TRACKING" for i in range(n)],
            "centre": c.tolist(), "keyframes_inserted": list(range(start, start + kf))}


@pytest.mark.parametrize("case,parts", [
    ("same", False),
    ("one_window_over", False),
    ("two_windows_over", True),
    ("within_spread", False),
    ("lost_in_one", True),
    ("lost_where_ulp_differs", False),
    ("keyframes_apart", True),
    ("keyframes_apart_as_ulp", False),
])
def test_parting_rule(case, parts):
    """chip_smoke.parting_of_runs on hand-made drives of three windows; a
    one-ulp drive equals its drive unless the case moves it."""
    shift = np.zeros((48, 3))
    if case == "one_window_over":
        shift[16:32, 0] = 1e-3
    elif case in ("two_windows_over", "within_spread"):
        shift[16:48, 0] = 1e-3
    runs = {"jax": _fake(), "torch": _fake(centres=shift)}
    if case.startswith("lost"):
        runs["torch"] = _fake(lost=(120,))
    if case.startswith("keyframes_apart"):
        runs["torch"] = _fake(kf=6)
    runs["jax_ulp"], runs["torch_ulp"] = runs["jax"], runs["torch"]
    if case == "within_spread":
        runs["jax_ulp"] = _fake(centres=np.tile([6e-4, 0, 0], (48, 1)))
    elif case == "lost_where_ulp_differs":
        runs["jax_ulp"] = _fake(lost=(120,))
    elif case == "keyframes_apart_as_ulp":
        runs["torch_ulp"] = _fake(kf=4)
    v = chip_smoke.parting_of_runs(runs)
    assert v["parts"] is parts, v


@pytest.mark.parametrize("sign", [1, -1])
def test_one_ulp(sign):
    """One ulp further from zero (a zero moves to +), or nearer to it (a
    zero stays)."""
    a = np.array([1.0, -1.0, 0.0, 3e-39], np.float32)
    b = chip_smoke.one_ulp(a, sign)
    assert b.dtype == np.float32
    if sign > 0:
        assert b[0] > 1 and b[1] < -1 and b[2] > 0 and b[3] > a[3]
    else:
        assert 0 < b[0] < 1 and -1 < b[1] < 0 and b[2] == 0 and 0 <= b[3] < a[3]
    steps = np.abs(b.view(np.int32) - a.view(np.int32))
    assert np.all(steps == ([1, 1, 1, 1] if sign > 0 else [1, 1, 0, 1]))


def test_track_moves_name_the_grid_moves():
    """The moves a track-on's spread is taken under: kf_t, then the grid
    one ulp each way (JAX_TRACK_ON_REF pins its spreads under these)."""
    assert chip_smoke.TRACK_MOVES == ("ulp", "grid_ulp", "grid_ulp_down")
    assert sorted(chip_smoke.GRID_MOVES.values()) == [-1, 1]
    ref = chip_smoke.JAX_TRACK_ON_REF
    assert ref["moves"] == list(chip_smoke.TRACK_MOVES) == list(ref["by_move"])
    for move in ref["moves"]:
        for pkg in ("jax", "torch_cpu"):
            assert len(ref["by_move"][move][pkg]) == len(ref["spread"][pkg])
    # the spread the phase gates on is the largest over the moves
    for pkg in ("jax", "torch_cpu"):
        assert ref["spread"][pkg] == [max(w) for w in zip(*(ref["by_move"][m][pkg]
                                                             for m in ref["moves"]))]
    assert chip_smoke.state_digest(chip_smoke.TRACK_ON_STATE) == ref["state_digest"]


if __name__ == "__main__":
    # the one-ulp spreads behind SPREADS
    import tempfile

    state = _closure_state(tempfile.mkdtemp(prefix="closure"))
    runs = {}
    for pkg in ("jax", "torch"):
        runs[pkg] = _drive(pkg, state)
        runs[pkg + "_ulp"] = _drive(pkg, state, perturb=True)
    print("SPREADS =", {pkg: chip_smoke.window_distances(runs[pkg + "_ulp"], runs[pkg])
                        for pkg in ("jax", "torch")})
    # the first frames after the correction, before the drive's chaos grows
    print("per frame, spreads:", {pkg: chip_smoke.window_distances(runs[pkg + "_ulp"], runs[pkg],
                                                                   window=1)[:6]
                                  for pkg in ("jax", "torch")},
          "torch vs jax:", chip_smoke.window_distances(runs["torch"], runs["jax"], window=1)[:6])
    print("torch vs jax:", chip_smoke.window_distances(runs["torch"], runs["jax"]),
          "keyframes", runs["jax"]["keyframes_inserted"], runs["torch"]["keyframes_inserted"])
