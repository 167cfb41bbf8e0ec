"""The port's profile, ablation and CPU-anchor tools (tools/*_torch.py) on
the CPU at tiny sizes, against the JAX tools they port.

Each tool's main runs with --device cpu (cpu_anchor_torch always measures
the CPU) and prints one JSON line holding the JAX tool's keys. The pieces
of profile_ba_parts_torch / profile_ba_opts_torch equal the JAX ops on the
same numpy inputs within 1e-5 relative (the largest difference over the
largest value: inverses, solves, segment sums, the coupling and Schur
products, projection residuals and Jacobians); gj_max_err < 1e-3. The
convergence tool's local_ba on a JAX map carried over by convert.py gives
JAX's final cost within the BA parity tolerance (1e-3 relative) at 4, 8
and 24 iterations. The ablation's rows report the hook values their child
processes read. Without a card, a tool asked for the card refuses, and so
does time_pose_opt_graph.py, whose pose problem the solve takes to its
inliers on the CPU.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lpslam_tpu.backend import ba as jba
from lpslam_tpu.geometry import PinholeCamera as JCam

from lpslam_tpu_torch import convert

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import ablate_ba_robustness_torch as ablate  # noqa: E402
import cpu_anchor_torch  # noqa: E402
import profile_ba_convergence_torch as conv  # noqa: E402
import profile_ba_opts_torch as opts  # noqa: E402
import profile_ba_parts_torch as parts  # noqa: E402
import profile_ba_torch  # noqa: E402
import profile_chunk_torch  # noqa: E402

from test_torch_mapping import _np_map, _scene_map, _tcam  # noqa: E402

torch.set_num_threads(1)

TINY = ["--width", "160", "--height", "120", "--keypoints", "256", "--max-keyframes", "16",
        "--max-landmarks", "2048"]
SHAPES = ["--C", "2", "--N", "64", "--Pn", "128", "--reps", "2"]


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_profile_chunk_prints_the_jax_keys(capsys):
    assert profile_chunk_torch.main(
        ["--device", "cpu", "--frames", "4", "--chunk", "4", *TINY]) == 0
    out = _last_json(capsys)
    for k in ("upload_ms_per_frame", "upload_fps_ceiling", "bench_loop_fps",
              *(f"{n}_{s}" for n in ("scan_only", "scan_boundary")
                for s in ("fps", "ms_per_frame", "keyframes"))):
        assert out[k] > 0, k
    assert out["scan_only_culls"] == 0 and out["hardware"]


def test_profile_ba_prints_the_jax_keys(capsys):
    assert profile_ba_torch.main(
        ["--device", "cpu", "--frames", "8", "--chunk", "4", *TINY]) == 0
    out = _last_json(capsys)
    assert out["scan_no_ba_ms_per_frame"] > 0 and out["scan_no_ba_fps"] > 0
    for w, i in profile_ba_torch.SHAPES:
        assert out[f"local_ba_w{w}_i{i}_ms"] > 0
    assert out["map"]["n_kf"] >= 2


def test_cpu_anchor_prints_the_jax_keys(capsys):
    assert cpu_anchor_torch.main(["--frames", "8", "--chunk", "8", *TINY]) == 0
    out = _last_json(capsys)
    assert out["metric"] == "cpu_anchor_tracked_fps" and out["unit"] == "frames/s"
    assert out["value"] > 0 and out["frames"] == 8 and out["keypoints"] == 256
    assert out["host_cpus"] >= 1 and out["cpu_model"] and out["torch_threads"] == 1


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_parts_pieces_equal_jax(capsys):
    assert parts.main(["--device", "cpu", *SHAPES]) == 0
    out = _last_json(capsys)
    x = parts.inputs(2, 64, 128)
    P = {k: fn() for k, (_, fn) in parts.pieces(x, torch.device("cpu")).items()}
    for k in P:
        assert out[k]["wall_ms"] > 0 and out[k]["label"], k
    j = {k: jnp.asarray(v) for k, v in x.items()}
    inv = np.asarray(jnp.linalg.inv(j["A"]))
    for k in ("inv3x3_lu", "inv3x3_adjugate", "inv3x3_guarded"):
        assert _rel(P[k], inv) <= 1e-5, k
    sol = np.asarray(jnp.linalg.solve(j["S"], j["b"]))
    for k in ("solve36_lu", "solve36_chol"):
        assert _rel(P[k], sol) <= 1e-5, k
    seg = np.asarray(jax.ops.segment_sum(j["JpTJp"], j["flat_lm"], num_segments=128))
    for k in ("segment_sum", "segment_sum_plan"):
        assert _rel(P[k], seg) <= 1e-5, k
    rows = jnp.repeat(jnp.arange(2), 64)
    hcp = np.asarray(jnp.zeros((2, 128, 6, 3)).at[rows, j["flat_lm"]].add(
        j["JcTJp"].reshape(-1, 6, 3)))
    for k in ("coupling_scatter", "coupling_onehot"):
        assert _rel(P[k], hcp) <= 1e-5, k
    hpi = np.linalg.inv(x["A"].astype(np.float64))
    schur = np.einsum("apij,pjk,bplk->aibl", x["Hcp0"], hpi, x["Hcp0"])
    for k in ("schur_einsum", "schur_matmul"):
        assert _rel(P[k], schur) <= 1e-4, k   # against float64: the adjugate's rounding
    cam = JCam.make(parts.FX, parts.FX, parts.CX, parts.CY)
    R = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (2, 3, 3))
    ref = jba._project_residuals(cam, R, j["t"], j["pts"], j["obs_lm"], j["obs_uv"])
    for a, b in zip(P["project_residuals"], ref):
        assert _rel(a, b) <= 1e-5


def test_opts_pieces_equal_jax(capsys):
    assert opts.main(["--device", "cpu", *SHAPES]) == 0
    out = _last_json(capsys)
    assert out["gj_max_err"] < 1e-3 and "TF32 off" in out["precision"]
    x = opts.inputs(2, 64, 128)
    P = {k: fn() for k, (_, fn) in opts.pieces(x, torch.device("cpu")).items()}
    for k in P:
        assert out[k]["wall_ms"] > 0, k
    j = {k: jnp.asarray(v) for k, v in x.items()}
    oh = (j["obs_lm"][:, :, None] == jnp.arange(128)[None, None, :]).astype(jnp.float32)
    hpp = np.asarray(jnp.einsum("cnp,cnij->pij", oh, j["JpTJp"]))
    hcp = np.asarray(jnp.einsum("cnp,cnij->cpij", oh, j["JcTJp"]))
    for k in ("onehot_Hpp_and_Hcp", "onehot_Hpp_and_Hcp_port"):
        assert _rel(P[k][0], hpp) <= 1e-5 and _rel(P[k][1], hcp) <= 1e-5, k
    T = jnp.einsum("apij,pjk->apik", j["Hcp0"], j["Hpi"]).transpose(0, 2, 1, 3)
    S = T.reshape(12, 384) @ j["Hcp0"].transpose(0, 2, 1, 3).reshape(12, 384).T
    assert _rel(P["schur_matmul"], S) <= 1e-5
    sol = np.asarray(jnp.linalg.solve(j["S0"], j["b0"]))
    assert _rel(P["solve36_gauss_jordan"], sol) <= 1e-3
    cam = JCam.make(opts.FX, opts.FX, opts.CX, opts.CY)
    R = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (2, 3, 3))
    ref = jba._project_residuals(cam, R, j["t"], j["pts"], j["obs_lm"], j["obs_uv"])
    for a, b in zip(P["project_residuals"], ref):
        assert _rel(a, b) <= 1e-5


def test_convergence_tool_runs_and_matches_jax_local_ba(capsys):
    assert conv.main(["--device", "cpu", "--mode", "mono", "--frames", "42",
                      "--iters", "2,4", *TINY]) == 0
    out = _last_json(capsys)
    assert out["metric"] == "local_ba_staged_lm_convergence" and out["window"] == 6
    snap = out["snapshots"][-1]
    assert snap["n_kf"] >= 6 and [r["iters"] for r in snap["by_iters"]] == [2, 4]
    assert snap["by_iters"][-1]["excess_vs_converged"] == 0.0
    # one JAX map, carried over: the port's local_ba at every count. At
    # iters = 4 (one LM step in each of the first two stages) the staged LM
    # is chaotic in fp32 on some of these toy maps in JAX itself (one ulp of
    # kf_t moves JAX's final cost by up to 0.31, _scene_map(5)); on
    # _scene_map(3) JAX's own one-ulp spread is <= 1e-6 at every count
    m_j, cam_j = _scene_map(3)
    per = conv.profile_snapshot(convert.map_from_numpy(_np_map(m_j), "cpu"), _tcam(),
                                [4, 8, 24], lambda: None)
    for r in per["by_iters"]:
        _, r_j = jba.local_ba(m_j, cam_j, window=6, iters=r["iters"], covisibility=True)
        np.testing.assert_allclose(r["final_cost"], float(r_j.final_cost), rtol=1e-3)
        assert r["wall_ms"] > 0


def test_ablation_rows_report_the_hooks_their_children_read(tmp_path, capsys):
    out_file = tmp_path / "ablation.json"
    assert ablate.main(["--device", "cpu", "--mode", "mono", "--frames", "10", *TINY,
                        "--out", str(out_file)]) == 0
    art = json.loads(out_file.read_text())
    assert _last_json(capsys) == art
    assert [r["config"] for r in art["rows"]] == [c[0] for c in ablate.CONFIGS]
    for row, (_, damping, tol) in zip(art["rows"], ablate.CONFIGS):
        assert "error" not in row and "rc" not in row, row
        assert row["ba_damping_read"] == row["damping"] == damping
        assert row["ba_guard_tol_read"] == row["guard_tol"] == float(tol)
        assert row["frames"] == 10 and row["loop_closure"] and row["wall_s"] > 0
        assert row["closures"] == []


@pytest.mark.parametrize("tool", [profile_chunk_torch, profile_ba_torch, conv, parts, opts,
                                  ablate])
def test_tools_ask_for_the_card_by_default(tool):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    with pytest.raises(SystemExit, match="--device cpu"):
        tool.main([])


def local_ba_spread(seeds=range(8), iters=(4, 6, 8, 12, 16, 24), covisibility=True):
    """Per toy map and iteration count: the port's final local_ba cost
    relative to JAX's, and JAX's own relative move when kf_t is one ulp
    up; the survey behind the maps and counts the convergence test uses
    (ROADMAP Queue 3)."""
    import jax.numpy as jnp

    from lpslam_tpu.mapstore import store as jstore
    from lpslam_tpu_torch.backend import ba as tba

    rows = []
    for seed in seeds:
        m_j, cam_j = _scene_map(seed)
        m_t = convert.map_from_numpy(_np_map(m_j), "cpu")
        d = _np_map(m_j)
        d["kf_t"] = np.nextafter(d["kf_t"], np.float32(np.inf)).astype(np.float32)
        m_u = jstore.MapStore(**{k: jnp.asarray(v) for k, v in d.items()})
        for it in iters:
            kw = dict(window=6, iters=it, covisibility=covisibility)
            ref = float(jba.local_ba(m_j, cam_j, **kw)[1].final_cost)
            ours = float(tba.local_ba(m_t, _tcam(), **kw)[1].final_cost)
            ulp = float(jba.local_ba(m_u, cam_j, **kw)[1].final_cost)
            rows.append({"seed": seed, "iters": it, "port_vs_jax": ours / ref - 1,
                         "jax_one_ulp": ulp / ref - 1})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_profile_tools.py [--temporal]
    local_ba_spread(covisibility="--temporal" not in sys.argv)


def test_pose_opt_graph_timer_refuses_without_a_card(monkeypatch, capsys):
    import time_pose_opt_graph as tool
    from lpslam_tpu_torch.frontend.pose_opt import pose_only_optimize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--n", "64"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
    # the problem it times is one the solve takes to its inliers
    pose0, cam, p_w, uv, valid, s2 = tool.pose_problem("cpu", 512, seed=2)
    res = pose_only_optimize(pose0, cam, p_w, uv, valid, sigma2=s2, iters=6)
    assert int(res.n_inliers) > 0.8 * int(valid.sum())
