"""Port parity, the whole monocular slice: host initialization, then the
chunked tracking loop, in lpslam_tpu and lpslam_tpu_torch on the same frames.

Margins for the slice (the two packages round differently, so keypoint sets
beyond level 0, descriptor ties and LM paths drift apart over a run): the
port initializes on the same frame, tracks at least JAX's count - 1 frames,
keeps keyframes within +-1 and landmarks within +-15%, and reaches a Sim3 ATE
<= max(1.5 x JAX, JAX + 0.02 m). Also: the numpy fixture copies match the
JAX package's, the precision flags are set, the port imports no JAX, and
chip_smoke.py refuses to run without a card.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lpslam_tpu.eval import ate_rmse as j_ate
from lpslam_tpu.io import benchmark as jbench
from lpslam_tpu.io.synthetic import make_sequence, make_texture as j_texture

import lpslam_tpu_torch
from lpslam_tpu_torch.eval import ate_rmse as t_ate
from lpslam_tpu_torch.io import benchmark as tbench
from lpslam_tpu_torch.io.synthetic import make_texture as t_texture

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _run_slice(pkg, seq):
    if pkg == "jax":
        from lpslam_tpu.frontend import MonoTracker, TrackerConfig, TrackerStatus
        from lpslam_tpu.frontend.device_loop import ChunkedTracker
        from lpslam_tpu.geometry import PinholeCamera
        from lpslam_tpu.kernels.orb import OrbParams
        from lpslam_tpu.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2])
        kw = {}
    else:
        from lpslam_tpu_torch.frontend import MonoTracker, TrackerConfig, TrackerStatus
        from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
        from lpslam_tpu_torch.geometry import PinholeCamera
        from lpslam_tpu_torch.kernels.orb import OrbParams
        from lpslam_tpu_torch.mapstore import MapConfig

        cam = PinholeCamera.make(seq.K[0, 0], seq.K[1, 1], seq.K[0, 2], seq.K[1, 2],
                                 device="cpu")
        kw = {"device": "cpu"}
    cfg = TrackerConfig(orb=OrbParams(256, 2), map_cfg=MapConfig(16, 2048, 256))
    eng = MonoTracker(cam, cfg, **kw)
    t = 0
    while eng.status != TrackerStatus.TRACKING and t < 12:
        eng.process(seq.images[t])
        t += 1
    init_frame = t
    ct = ChunkedTracker(eng)
    while t + 8 <= len(seq.images):
        ct.process_chunk(np.stack(seq.images[t:t + 8]))
        t += 8
    ct.sync()
    sts, n_inl, pR, pt, kf, _, _ = ct.collect()
    tracked = sts == int(TrackerStatus.TRACKING)
    est = -np.einsum("bji,bj->bi", pR, pt)[tracked]
    gt = np.asarray([seq.poses_wc[init_frame + i].t for i in range(len(sts))])[tracked]
    return {
        "init_frame": init_frame,
        "tracked": int(tracked.sum()),
        "keyframes": eng._kf_count,
        "landmarks": eng.n_landmarks,
        "ate": j_ate(est, gt)[0],
        "status": int(eng.status),
    }


def test_slice_matches_jax():
    seq = make_sequence(num_frames=36, h=120, w=160, seed=1, motion="orbit", fx=115.0)
    ref = _run_slice("jax", seq)
    ours = _run_slice("torch", seq)
    assert ref["tracked"] == 24, ref  # the reference itself works here
    assert ours["init_frame"] == ref["init_frame"], (ours, ref)
    assert ours["tracked"] >= ref["tracked"] - 1, (ours, ref)
    assert abs(ours["keyframes"] - ref["keyframes"]) <= 1, (ours, ref)
    assert abs(ours["landmarks"] - ref["landmarks"]) <= 0.15 * ref["landmarks"], (ours, ref)
    assert ours["ate"] <= max(1.5 * ref["ate"], ref["ate"] + 0.02), (ours, ref)
    assert ours["status"] == ref["status"] == 2


def test_fixture_copies_match_reference():
    np.testing.assert_array_equal(t_texture(64, 96, seed=3), j_texture(64, 96, seed=3))
    kw = dict(num_frames=3, h=96, w=128, seed=2, turns=0.1)
    frames_j = [f.image for f in jbench.SyntheticBenchmark(**kw)]
    ds_t = tbench.SyntheticBenchmark(**kw)
    frames_t = [f.image for f in ds_t]
    for a, b in zip(frames_t, frames_j):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 1.0
    np.testing.assert_allclose(
        ds_t.ground_truth().positions,
        jbench.SyntheticBenchmark(**kw).ground_truth().positions, atol=1e-12,
    )
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(0, 0.1, (50, 3)), 0)
    est = 0.5 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(0, 0.01, gt.shape)
    for scale in (True, False):
        assert abs(t_ate(est, gt, scale)[0] - j_ate(est, gt, scale)[0]) <= 1e-9


def test_precision_flags():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    assert lpslam_tpu_torch.__version__


# the port's tools (tools/*_torch.py) and its benchmark (bench_torch.py, at
# the root) import no JAX either: the card's machine has none
PORT_TOOLS = ("profile_chunk_torch", "profile_ba_torch", "profile_ba_parts_torch",
              "profile_ba_opts_torch", "profile_ba_convergence_torch",
              "ablate_ba_robustness_torch", "cpu_anchor_torch", "bench_torch")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lpslam_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(lpslam_tpu_torch.__path__, "
        "'lpslam_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "sys.path.insert(0, 'tools')\n"
        f"for n in {PORT_TOOLS!r}: importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'lpslam_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 25, names\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_card(alone, tmp_path):
    """Without a CUDA card (and, alone, without the package beside it) the
    smoke script exits non-zero and prints no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: the script would run the real check")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, env=env, cwd=cwd, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chunked_tracker_api():
    from lpslam_tpu_torch.frontend import MonoTracker, TrackerConfig
    from lpslam_tpu_torch.frontend.device_loop import ChunkedTracker
    from lpslam_tpu_torch.geometry import PinholeCamera

    cam = PinholeCamera.make(120.0, 120.0, 80.0, 60.0, device="cpu")
    ct = ChunkedTracker(MonoTracker(cam, TrackerConfig(), device="cpu"))
    sts, n_inl, pR, pt, kf, sp, sr = ct.collect()
    assert sts.shape == (0,) and pR.shape == (0, 3, 3)
    assert not ct.ready
    with pytest.raises(AssertionError):
        ct.process_chunk(np.zeros((2, 120, 160), np.uint8))
