"""The comparison behind `correct` against a broken program: a run at a
small size on the CPU (the harness's look for a card skipped), with the
timed path broken underneath after set-up, must come out not correct; the
same run unbroken comes out correct. And, on the card only, the control:
the program with TF32 on for its float32 products fails the cell's own
limits.

    python -m pytest slam_bench/tests/test_slam_bench_faults.py -q   (~2 min)
"""
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slam_bench.cell import run_cell  # noqa: E402

SEED = 1234
SECONDS = 6.0
# limits for the 160x120, 256-keypoint copy of lpslam_mono_vga. At that
# size the mono map is erratic (seeds 20260817, 5, 77, 1234: worst segment
# 0.070-0.178, rotation 1.8-3.7 degrees per 8 frames, lost 0 / 0 / 0.16 / 0,
# median reprojection 0.79-71 px), so the map is not held here. Seed 1234
# reads feat bits 0, segment 0.104, rotation 1.82, lost 0; each fault reads
# past a limit on one number at least (unchanged state: lost 0.48; half the
# batch: feat bits 127; every third orientation turned by 20 degrees:
# rotation 16.6; descriptor altered: feat bits 32). The card's limits are in
# slam_bench/limits/.
SMALL_LIMITS = {"feat_bits_mean": 3.0, "traj_seg_rmse_m": 0.3, "rot_rpe_deg": 7.0,
                "lost_share": 0.05}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout-like root whose BENCHMARK.json points the mono cells at a
    160x120, 256-keypoint copy of the configuration."""
    root = tmp_path_factory.mktemp("small")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = next(c for c in bench["configs"] if c["name"] == "lpslam_mono_vga")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    cfg["sensor"]["width"], cfg["sensor"]["height"] = 160, 120
    cfg["tracker"].update(keypoints=256, max_landmarks=4096, max_keyframes=32)
    (root / "cfg.json").write_text(json.dumps(cfg))
    conf["file"] = "cfg.json"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, after_setup=None, seed=SEED):
    torch.set_num_threads(4)
    return run_cell(root, "mono_vga.replay16", seed, SECONDS, False, time.perf_counter(),
                    device="cpu", after_setup=after_setup, limits=SMALL_LIMITS)


def test_sound_run_is_correct(small_root):
    r = _run(small_root)
    assert r["correct"], r["numbers"]
    assert r["attempted"] > 0 and r["failed"] == 0


def _unchanged_state(monkeypatch):
    """The tracking step hands back the pose it was given."""
    from lpslam_tpu_torch.frontend import device_loop

    orig = device_loop.track_frame

    def step(m, pose_pred, *a, **k):
        return orig(m, pose_pred, *a, **k)._replace(pose=pose_pred)

    monkeypatch.setattr(device_loop, "track_frame", step)


def _half_batch(monkeypatch):
    """The chunk's second half takes the first half's features."""
    from lpslam_tpu_torch.frontend import device_loop

    orig = device_loop.extract_orb

    def extract(img, params):
        half = (img.shape[0] + 1) // 2
        f = orig(img[:half], params)
        return type(f)(*(torch.cat([x, x], 0)[:img.shape[0]] for x in f))

    monkeypatch.setattr(device_loop, "extract_orb", extract)


def _pose_altered(monkeypatch):
    """Every third result's orientation turned by 20 degrees."""
    from lpslam_tpu_torch.pipeline import trackers

    orig, calls = trackers.create_tracker_result_pose, [0]
    h = np.radians(10.0)

    def result(R, t):
        c, (w, x, y, z) = orig(R, t)
        calls[0] += 1
        if calls[0] % 3:
            return c, np.array([w, x, y, z])
        cz, sz = np.cos(h), np.sin(h)          # q times the turn (cos h, 0, 0, sin h)
        return c, np.array([w * cz - z * sz, x * cz + y * sz, y * cz - x * sz, z * cz + w * sz])

    monkeypatch.setattr(trackers, "create_tracker_result_pose", result)


def _descriptor_altered(monkeypatch):
    """Every extracted descriptor's first word inverted."""
    from lpslam_tpu_torch.frontend import device_loop

    orig = device_loop.extract_orb

    def extract(img, params):
        f = orig(img, params)
        desc = f.desc.clone()
        desc[..., 0] = ~desc[..., 0]
        return f._replace(desc=desc)

    monkeypatch.setattr(device_loop, "extract_orb", extract)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _pose_altered,
                                   _descriptor_altered], ids=lambda f: f.__name__[1:])
def test_broken_program_is_not_correct(small_root, monkeypatch, fault):
    r = _run(small_root, after_setup=lambda session: fault(monkeypatch))
    assert not r["correct"], r["numbers"]


@pytest.mark.cuda
def test_tf32_control_fails_the_cell_limits():
    """The control on the card at the cell's own size: TF32 on for the
    program's float32 products."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import lpslam_tpu_torch  # noqa: F401

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        r = run_cell(ROOT, "mono_vga.replay16", SEED, 10.0, False, time.perf_counter())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
    assert not r["correct"], r["numbers"]
