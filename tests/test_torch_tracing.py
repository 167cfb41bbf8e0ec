"""The port's tracing (lpslam_tpu_torch/utils/timing.py) and its spans in
the program:

- the shared clock: a span recorded inside a torch.profiler
  record_function range (CPU activity) lies within the range's start_ns /
  end_ns, the profiler's own clock;
- off by default: nothing is recorded, snapshot() is empty, a span is the
  shared no-op;
- the facility's rules: nesting and parents, frame ids inherited, a span
  directly inside one of its name counted once, the bounded buffer,
  ScopeTimer with explicit stats timing whether tracing is on or off;
- a small mono run through VSLAMTracker in chunks of 8 (120x160 orbit, 256
  keypoints) with tracing on: every frame has in <= pose <= out; the spans
  nest process_image > process_chunk > chunk_frame > track_frame > two
  pose_only_optimize a frame; poses and map are bit-equal to the same run
  with tracing off;
- pose_only_optimize on CPU tensors returns exactly what its eager body
  returns, records no pose_opt_graph_* span and captures no graph;
- on the card (marked ``cuda``, skipped here), the same small run with
  pose_only_optimize's CUDA graphs is bit-equal to the run with the graphed
  path patched to the eager body, and every pose_only_optimize span holds
  exactly one pose_opt_graph_replay.
"""
import time

import numpy as np
import pytest
import torch

from lpslam_tpu_torch.frontend import pose_opt
from lpslam_tpu_torch.geometry import PinholeCamera
from lpslam_tpu_torch.geometry.se3 import SE3
from lpslam_tpu_torch.geometry.so3 import so3_exp
from lpslam_tpu_torch.io.synthetic import make_sequence
from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry
from lpslam_tpu_torch.pipeline.trackers import VSLAMTracker
from lpslam_tpu_torch.utils import timing

torch.set_num_threads(1)

CONFIG = {"mode": "mono", "keypoints": 256, "levels": 2, "max_keyframes": 16,
          "max_landmarks": 2048, "chunk_size": 8}
FRAMES = 36


@pytest.fixture(autouse=True)
def tracing_off_after():
    timing.disable()
    timing.reset()
    yield
    timing.disable()
    timing.reset()


def test_span_lies_inside_the_profiler_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    timing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer_range"):
            time.sleep(0.002)
            with timing.span("inner"):
                time.sleep(0.002)
            time.sleep(0.002)
    timing.disable()
    (_, s0, s1, _, _), = timing.snapshot()["spans"]
    rng = [e for e in prof.profiler.kineto_results.events() if e.name() == "outer_range"]
    assert len(rng) == 1
    r0 = rng[0].start_ns()
    r1 = r0 + rng[0].duration_ns()
    assert r0 < s0 < s1 < r1, (r0, s0, s1, r1)
    # the sleeps put the span ~2 ms from each end of the range
    assert 1e6 < s0 - r0 < 50e6 and 1e6 < r1 - s1 < 50e6


def test_off_by_default_records_nothing():
    assert not timing.ENABLED
    sp = timing.span("a", 3)
    assert sp is timing.span("b")          # the shared no-op
    with sp:
        timing.stamp(3, "in")
    snap = timing.snapshot()
    assert snap["spans"] == [] and snap["stamps"] == [] and snap["totals"] == {}


def test_spans_nest_inherit_frames_and_count_a_reentered_name_once():
    timing.enable()
    with timing.span("a", 7):
        with timing.span("b"):
            with timing.span("b"):              # directly inside "b": merged
                timing.stamp(7, "pose")
        with timing.span("c", 8):
            pass
    with timing.span("d"):
        pass
    timing.disable()
    snap = timing.snapshot()
    names = [s[0] for s in snap["spans"]]
    assert names == ["a", "b", "c", "d"]
    (a, b, c, d) = snap["spans"]
    assert (a[3], b[3], c[3], d[3]) == (-1, 0, 0, -1)
    assert (a[4], b[4], c[4], d[4]) == (7, 7, 8, None)
    assert a[1] <= b[1] <= b[2] <= c[1] <= c[2] <= a[2] <= d[1] <= d[2]
    assert snap["totals"]["b"][1] == 1 and snap["totals"]["a"][2] >= snap["totals"]["b"][2]
    assert [(f, k) for f, k, _ in snap["stamps"]] == [(7, "pose")]


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(timing, "MAX_SPANS", 3)
    monkeypatch.setattr(timing, "MAX_STAMPS", 2)
    timing.enable()
    for i in range(5):
        with timing.span("x", i):
            timing.stamp(i, "in")
    timing.disable()
    snap = timing.snapshot()
    assert len(snap["spans"]) == 3 and len(snap["stamps"]) == 2
    assert snap["dropped"] == {"spans": 2, "stamps": 3}
    assert snap["totals"]["x"][1] == 5          # the totals still count every span


def test_scope_timer_with_stats_times_whether_tracing_is_on_or_off():
    stats = timing.TimingStats()
    with timing.ScopeTimer("x", stats):
        time.sleep(0.001)
    assert stats.totals()["x"][1] == 1 and timing.snapshot()["spans"] == []
    timing.enable()
    with timing.ScopeTimer("x", stats):
        pass
    with timing.ScopeTimer("y"):
        pass
    timing.disable()
    assert stats.totals()["x"][1] == 2 and "y" not in stats.totals()
    assert [s[0] for s in timing.snapshot()["spans"]] == ["x", "y"]
    assert stats.mean("x") > 0


@pytest.fixture(scope="module")
def seq():
    return make_sequence(num_frames=FRAMES, h=120, w=160, seed=1, motion="orbit", fx=115.0)


def _drive(seq, device="cpu"):
    K = seq.K
    tr = VSLAMTracker(PinholeCamera.make(K[0, 0], K[1, 1], K[0, 2], K[1, 2], device=device),
                      dict(CONFIG), device=device)
    results = []
    for t in range(FRAMES):
        results += tr.process_image(CameraQueueEntry(timestamp=t / 20.0,
                                                     image=seq.images[t])) or []
    results += tr.flush()
    m = tr.engine.map
    return tr, results, {k: v.clone() for k, v in m._asdict().items()}


@pytest.fixture(scope="module")
def runs(seq):
    timing.disable()
    timing.reset()
    off = _drive(seq)
    assert timing.snapshot()["spans"] == []
    timing.enable()
    on = _drive(seq)
    timing.disable()
    snap = timing.snapshot()
    timing.reset()
    return off, on, snap


def test_traced_run_equals_the_untraced_one_bit_for_bit(runs):
    (tr0, res0, map0), (tr1, res1, map1), _ = runs
    assert len(res0) == len(res1) > FRAMES // 2
    for a, b in zip(res0, res1):
        assert a.timestamp == b.timestamp and a.valid == b.valid
        assert np.array_equal(a.position, b.position)
        assert np.array_equal(a.orientation_wxyz, b.orientation_wxyz)
    for k in map0:
        assert torch.equal(map0[k], map1[k]), k
    assert tr1._chunked is not None      # the chunk loop ran
    assert [(f, s) for f, _, s in tr0.engine.trajectory] == \
        [(f, s) for f, _, s in tr1.engine.trajectory]


def test_every_frame_has_in_then_pose_then_out(runs):
    *_, snap = runs
    by_frame = {}
    for fid, kind, t in snap["stamps"]:
        assert kind in timing.FRAME_KINDS
        assert kind not in by_frame.setdefault(fid, {}), (fid, kind)
        by_frame[fid][kind] = t
    assert sorted(by_frame) == list(range(FRAMES))
    for fid, k in by_frame.items():
        assert set(k) == {"in", "pose", "out"}, (fid, k)
        assert k["in"] <= k["pose"] <= k["out"], (fid, k)
    # a chunk frame's result waits for the next boundary: its pose comes
    # before a later frame's hand-in
    held = [f for f, k in by_frame.items()
            if any(by_frame[g]["in"] < k["out"] for g in by_frame if g > f)]
    assert held


def test_spans_nest_down_to_two_pose_optimizations_a_frame(runs):
    *_, snap = runs
    spans = snap["spans"]

    def parent(i):
        return spans[i][3]

    frames = [i for i, s in enumerate(spans) if s[0] == "chunk_frame"]
    assert frames
    for i in frames:
        chunk = parent(i)
        assert spans[chunk][0] == "process_chunk"
        assert spans[parent(chunk)][0] == "process_image"
        tracks = [j for j, s in enumerate(spans) if s[0] == "track_frame" and parent(j) == i]
        assert len(tracks) == 1
        opts = [j for j, s in enumerate(spans)
                if s[0] == "pose_only_optimize" and parent(j) == tracks[0]]
        assert len(opts) == 2
        fid = spans[i][4]
        for j in tracks + opts:
            assert spans[j][4] == fid
            assert spans[i][1] <= spans[j][1] <= spans[j][2] <= spans[i][2]
    # every span closed, and a child inside its parent's interval
    for name, s0, s1, up, _ in spans:
        assert s0 is not None and s1 is not None and s0 <= s1, name
        if up >= 0:
            assert spans[up][1] <= s0 and s1 <= spans[up][2], name
    names = {s[0] for s in spans}
    assert {"chunk_extract", "chunk_boundary", "engine_process", "insert_keyframe",
            "local_ba"} <= names
    assert snap["totals"]["chunk_frame"][1] == len(frames)


def _pose_problem(n, seed):
    """A pose a few degrees and centimetres off the one that projects n
    landmarks to their pixels, with pixel noise, outliers, invalid rows and
    per-point variances of three pyramid levels."""
    rng = np.random.default_rng(seed)
    p_w = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 6, (n, 1))], 1)
    uv = p_w[:, :2] / p_w[:, 2:] * 300.0 + [320.0, 240.0] + rng.normal(0, 0.7, (n, 2))
    uv[: n // 10] += rng.uniform(-40, 40, (n // 10, 2))
    level = rng.integers(0, 3, n)
    valid = torch.from_numpy(rng.uniform(size=n) > 0.05)

    def T(a):
        return torch.tensor(np.asarray(a, np.float32))

    pose0 = SE3(so3_exp(T([0.02, -0.03, 0.01])), T([0.05, -0.04, 0.03]))
    cam = PinholeCamera.make(300.0, 300.0, 320.0, 240.0, device="cpu")
    return pose0, cam, T(p_w), T(uv), valid, T(1.44 ** level)


@pytest.mark.parametrize("iters,sigma", [(6, "levels"), (4, "levels"), (8, "ones"),
                                         (10, None)])
def test_pose_opt_on_the_cpu_runs_its_eager_body(monkeypatch, iters, sigma):
    monkeypatch.setattr(pose_opt, "_GRAPHS", {})
    pose0, cam, p_w, uv, valid, s2 = _pose_problem(700, iters)
    s2 = {"levels": s2, "ones": torch.ones_like(s2), None: None}[sigma]
    timing.enable()
    got = pose_opt.pose_only_optimize(pose0, cam, p_w, uv, valid, sigma2=s2, iters=iters)
    timing.disable()
    want = pose_opt._pose_only_optimize_eager(pose0, cam, p_w, uv, valid, s2, iters)
    for a, b in zip((*got.pose, *got[1:]), (*want.pose, *want[1:])):
        assert torch.equal(a, b)
    assert int(got.n_inliers) > 500
    assert [s[0] for s in timing.snapshot()["spans"]] == ["pose_only_optimize"]
    assert pose_opt._GRAPHS == {}


@pytest.mark.cuda
def test_graphed_pose_opt_leaves_the_run_bit_equal_on_card(seq, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    monkeypatch.setattr(pose_opt, "_GRAPHS", {})
    timing.enable()
    tr1, res1, map1 = _drive(seq, "cuda")
    timing.disable()
    snap = timing.snapshot()
    monkeypatch.setattr(pose_opt, "_graphed", pose_opt._pose_only_optimize_eager)
    tr0, res0, map0 = _drive(seq, "cuda")
    assert tr1._chunked is not None      # the chunk loop ran
    assert len(res0) == len(res1) > FRAMES // 2
    for a, b in zip(res0, res1):
        assert a.timestamp == b.timestamp and a.valid == b.valid
        assert np.array_equal(a.position, b.position)
        assert np.array_equal(a.orientation_wxyz, b.orientation_wxyz)
    assert [(f, s) for f, _, s in tr0.engine.trajectory] == \
        [(f, s) for f, _, s in tr1.engine.trajectory]
    for k in map0:
        assert torch.equal(map0[k], map1[k]), k

    spans = snap["spans"]
    children = {}
    for j, s in enumerate(spans):
        children.setdefault(s[3], []).append(s[0])
    tracks = [i for i, s in enumerate(spans) if s[0] == "track_frame"]
    assert tracks
    for i in tracks:
        assert children[i].count("pose_only_optimize") == 2
    opts = [i for i, s in enumerate(spans) if s[0] == "pose_only_optimize"]
    for i in opts:
        assert children[i].count("pose_opt_graph_replay") == 1
    # one capture per signature (track_frame's 6 and 4 iterations, and
    # relocalization's 8 if a frame was lost), each inside a call that
    # replays it right after
    caps = [i for i, s in enumerate(spans) if s[0] == "pose_opt_graph_capture"]
    assert 2 <= len(caps) == len(pose_opt._GRAPHS) <= 3
    for i in caps:
        assert spans[spans[i][3]][0] == "pose_only_optimize"
        assert children[spans[i][3]] == ["pose_opt_graph_capture", "pose_opt_graph_replay"]
    totals = snap["totals"]
    assert totals["pose_opt_graph_replay"][1] == totals["pose_only_optimize"][1] == len(opts)
