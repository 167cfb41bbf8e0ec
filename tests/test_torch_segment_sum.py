"""Port parity, the sorted segment sum (lpslam_tpu_torch.kernels.linalg
``segment_plan`` / ``segment_sum``) that bundle_adjust_cg, the sharded
global BA and the pose graph take their sums from, on the CPU.

- Bit-equal to ``index_add_`` on the CPU, whose sequential order is the
  stable sort's, at the shapes the solvers sum ((M,), (M, 3), (M, 3, 3),
  (M, 7, 7)), with empty segments, long runs and rows left out (ids -1
  and n, a solver's empty slots).
- Within fp32 rounding of the JAX package's ``jax.ops.segment_sum``
  (lpslam_tpu/backend/ba.py:376, dist/sharded_map.py:141) and of the pose
  graph's ``H.at[ei, :, ej, :].add`` (loop/pose_graph.py:100).
- The solvers unchanged: ``bundle_adjust_cg``, ``optimize_pose_graph`` (on
  the drift circle with a duplicated loop edge), the sharded global BA in a
  world of one and ``distributed_bundle_adjust`` give bit for bit what they
  gave with ``index_add_`` on the clamped ids (empty slots summed into
  landmark 0, as weight-0 zeros).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpslam_tpu_torch.kernels.linalg import segment_plan, segment_sum

SHAPES = [(), (3,), (3, 3), (7, 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests compare sums bit for bit on one CPU thread; the count
    the other test files run with is restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(shape, seed=0, m=500, n=64):
    """m rows of `shape` by n segments: segment 5 empty, segment 9 long."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, m)
    idx[idx == 5] = 6
    idx[: m // 5] = 9
    idx[m // 5: m // 4] = -1                    # left out, as a solver's empty slots
    idx[m // 4: m // 4 + 3] = n
    rng.shuffle(idx)
    vals = rng.normal(0, 1, (m, *shape)).astype(np.float32) * rng.choice(
        [1e-3, 1.0, 1e3], (m,) + (1,) * len(shape)).astype(np.float32)
    return idx, vals, n


def _kept_index_add(idx, vals, n):
    """index_add_ of the rows whose id is in [0, n), in source order."""
    keep = (idx >= 0) & (idx < n)
    return torch.zeros((n, *vals.shape[1:]), dtype=vals.dtype).index_add_(0, idx[keep],
                                                                          vals[keep])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_segment_sum_bit_equal_to_index_add(shape):
    idx, vals, n = _data(shape)
    ti, tv = torch.from_numpy(idx), torch.from_numpy(vals)
    plan = segment_plan(ti, n)
    got = segment_sum(tv, plan)
    want = _kept_index_add(ti, tv, n)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert (got[5] == 0).all()
    keep = (ti >= 0) & (ti < n)
    assert torch.equal(plan.offsets.diff(), torch.bincount(ti[keep], minlength=n))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_segment_sum_matches_jax_segment_sum(shape):
    idx, vals, n = _data(shape, seed=1)
    keep = (idx >= 0) & (idx < n)
    idx, vals = idx[keep], vals[keep]
    got = segment_sum(torch.from_numpy(vals), segment_plan(torch.from_numpy(idx), n)).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(idx), num_segments=n))
    # fp32 rounding of the sums: a few ulp of the largest magnitude summed
    scale = np.zeros((n, *shape), np.float32)
    np.add.at(scale, idx, np.abs(vals))
    assert (np.abs(got - want) <= 4 * np.finfo(np.float32).eps * scale).all()


def test_pose_graph_blocks_match_jax_scatter():
    rng = np.random.default_rng(2)
    K, E = 12, 40
    ei, ej = rng.integers(0, K, E), rng.integers(0, K, E)
    Hii, Hjj, Hij = (rng.normal(0, 1, (E, 7, 7)).astype(np.float32) for _ in range(3))
    H = jnp.zeros((K, 7, K, 7), jnp.float32)
    H = H.at[ei, :, ei, :].add(jnp.asarray(Hii))
    H = H.at[ej, :, ej, :].add(jnp.asarray(Hjj))
    H = H.at[ei, :, ej, :].add(jnp.asarray(Hij))
    H = H.at[ej, :, ei, :].add(jnp.asarray(Hij).transpose(0, 2, 1))
    ti, tj = torch.from_numpy(ei), torch.from_numpy(ej)
    plan = segment_plan(torch.cat([ti * K + ti, tj * K + tj, ti * K + tj, tj * K + ti]), K * K)
    T = torch.from_numpy
    ours = segment_sum(torch.cat([T(Hii), T(Hjj), T(Hij), T(Hij).transpose(-1, -2)]), plan)
    ours = ours.reshape(K, K, 7, 7).permute(0, 2, 1, 3).numpy()
    scale = np.abs(np.asarray(H)) + 1.0
    assert (np.abs(ours - np.asarray(H)) <= 8 * np.finfo(np.float32).eps * scale).all()


def _index_add_everywhere(monkeypatch):
    """The solvers' sums as they were: index_add_ on the ids clamped to 0."""
    from lpslam_tpu_torch.backend import ba
    from lpslam_tpu_torch.dist import sharded_ba, sharded_map
    from lpslam_tpu_torch.loop import pose_graph

    def plan(idx, n):
        return torch.clamp(idx.reshape(-1).to(torch.int64), min=0), n

    def index_add(vals, p):
        return torch.zeros((p[1], *vals.shape[1:]), dtype=vals.dtype).index_add_(0, p[0], vals)

    for mod in (ba, sharded_ba, sharded_map, pose_graph):
        monkeypatch.setattr(mod, "segment_plan", plan)
        monkeypatch.setattr(mod, "segment_sum", index_add)


def _ba_problem():
    """eval/scaling.py's problem at 8 x 256 x 64, every fifth slot empty."""
    from lpslam_tpu_torch.eval.scaling import build_problem

    prob = build_problem(8, 256, 64, seed=3, device="cpu")
    obs_lm = prob.obs_lm.clone()
    obs_lm[:, ::5] = -1
    return prob._replace(obs_lm=obs_lm)


def test_bundle_adjust_cg_unchanged(monkeypatch):
    from lpslam_tpu_torch.backend.ba import bundle_adjust_cg
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    cam = PinholeCamera.make(460.0, 460.0, 376.0, 240.0, device="cpu")
    got = bundle_adjust_cg(_ba_problem(), cam, iters=4)
    assert float(got.final_cost) < float(got.initial_cost)
    _index_add_everywhere(monkeypatch)
    want = bundle_adjust_cg(_ba_problem(), cam, iters=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pose_graph_unchanged(monkeypatch):
    from lpslam_tpu_torch.loop import pose_graph as tpg

    from test_torch_loop import _drift_circle

    fields, _, _ = _drift_circle()
    dup = {k: np.concatenate([v, v[-1:]]) if k.startswith("edge") else v
           for k, v in fields.items()}
    dup["edge_t"][-1] += np.float32([0.3, -0.2, 0.1])
    prob = tpg.PoseGraphProblem(**{k: torch.from_numpy(np.asarray(v)) for k, v in dup.items()})
    got = tpg.optimize_pose_graph(prob, iters=4)
    _index_add_everywhere(monkeypatch)
    want = tpg.optimize_pose_graph(prob, iters=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sharded_global_ba_world_of_one_unchanged(monkeypatch):
    from lpslam_tpu_torch.dist import make_mesh
    from lpslam_tpu_torch.dist.sharded_map import _sgba_local
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    cam = PinholeCamera.make(460.0, 460.0, 376.0, 240.0, device="cpu")
    mesh = make_mesh(1, device="cpu")
    got = _sgba_local(_ba_problem(), cam, 3, 8, mesh)
    _index_add_everywhere(monkeypatch)
    want = _sgba_local(_ba_problem(), cam, 3, 8, mesh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_distributed_bundle_adjust_unchanged(monkeypatch):
    from lpslam_tpu_torch.dist import distributed_bundle_adjust, make_mesh
    from lpslam_tpu_torch.geometry.camera import PinholeCamera

    cam = PinholeCamera.make(460.0, 460.0, 376.0, 240.0, device="cpu")
    mesh = make_mesh(1, device="cpu")
    got = distributed_bundle_adjust(_ba_problem(), cam, iters=3, mesh=mesh)
    _index_add_everywhere(monkeypatch)
    want = distributed_bundle_adjust(_ba_problem(), cam, iters=3, mesh=mesh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
