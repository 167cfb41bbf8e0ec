"""Port parity, eval/scaling.py: build_problem gives the JAX tool's
problem (the same observations; poses through each package's se3_exp),
comm_model gives JAX's dict for the same arguments (the bandwidth flag
renamed), and main on a tiny problem in CPU worlds of 1 and 2 gives the JAX
tool's row keys with solutions within 2e-4 of the first world's (the bar of
tests/test_sharded_map.py:100); --model prints the measured compute rows,
the model rows and the sources of its two assumptions.
"""
import json

import numpy as np
import pytest
import torch

from lpslam_tpu.eval import scaling as jscaling
from lpslam_tpu_torch.eval import scaling

torch.set_num_threads(1)

TINY = ["--keyframes", "16", "--landmarks", "512", "--obs", "64", "--iters", "4",
        "--cg-iters", "8", "--repeats", "1"]


def test_build_problem_is_the_jax_tools():
    ref = jscaling.build_problem(16, 512, 64)
    ours = scaling.build_problem(16, 512, 64)
    for k in ("obs_lm", "cam_fixed", "point_valid", "points", "obs_sigma2"):
        np.testing.assert_array_equal(getattr(ours, k).numpy(), np.asarray(getattr(ref, k)), k)
    for k, tol in (("cam_R", 1e-6), ("cam_t", 1e-5), ("obs_uv", 1e-3)):
        np.testing.assert_allclose(getattr(ours, k).numpy(), np.asarray(getattr(ref, k)),
                                   atol=tol, err_msg=k)


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
@pytest.mark.parametrize("Pn,iters,cg,t1,bw,lat", [(16384, 6, 15, 0.35, 45.0, 2.0),
                                                   (4096, 8, 20, 0.02, 450.0, 11.5)])
def test_comm_model_equals_jax(n_hosts, Pn, iters, cg, t1, bw, lat):
    assert (scaling.comm_model(Pn, iters, cg, n_hosts, t1, link_gbs=bw, latency_us=lat)
            == jscaling.comm_model(Pn, iters, cg, n_hosts, t1, ar_bw_gbs=bw, latency_us=lat))


def test_main_on_cpu_worlds_matches_the_jax_rows(capsys, tmp_path):
    assert jscaling.main(TINY + ["--devices", "1,2"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    path = tmp_path / "scaling.json"
    assert scaling.main(TINY + ["--devices", "1,2", "--device", "cpu",
                                "--json-out", str(path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(path.read_text()) == out
    assert set(ref) <= set(out)
    assert out["problem"] == ref["problem"] and out["virtual_devices"] is True
    assert "solution identity" in out["note"]
    assert [r["devices"] for r in out["rows"]] == [1, 2]
    for ours, theirs in zip(out["rows"], ref["rows"]):
        assert set(theirs) <= set(ours)
        assert ours["backend"] == "gloo" and not ours["shared_card"]
        assert ours["max_sol_diff_vs_1dev"] < 2e-4
        assert abs(ours["final_cost"] - theirs["final_cost"]) <= 1e-3 * theirs["final_cost"]


def test_model_on_cpu(capsys):
    assert scaling.main(TINY + ["--device", "cpu", "--model"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["hosts_equivalent"] for r in out["measured_compute"]] == [1, 2, 4, 8]
    assert [r["keyframes_per_device"] for r in out["measured_compute"]] == [16, 8, 4, 4]
    assert [r["hosts"] for r in out["predicted"]] == [1, 2, 4, 8]
    a = out["assumptions"]
    assert a["allreduce_bw_GBs_per_device"] == scaling.NVLINK4_GBS
    assert "datasheet" in a["allreduce_bw_source"]
    assert a["collective_latency_us"] > 0 and "measured" in a["collective_latency_source"]
    assert out["predicted"][0]["t_comm_s"] > 0   # latency only: no wire in a world of one
    assert out["predicted"][0]["wire_MB_per_device"] == 0.0


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default runs on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        scaling.main(TINY)
