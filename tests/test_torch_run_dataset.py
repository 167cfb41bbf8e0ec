"""Port parity, the dataset evaluator: lpslam_tpu_torch.eval.run_dataset
against lpslam_tpu.eval.run_dataset, and the EuRoC / TUM readers.

- `--bench room` at 160x120 (256 keypoints, 2 levels, MapConfig(16, 2048)),
  mono with the chunk loop (48 frames) and stereo on the host path (40), the
  lens distortion undone in the frame path by RectifyProcessor: tracked
  frames within 1 of JAX's and ATE within max(1.5 x JAX, JAX + 0.02 m).
- A few room frames rendered into an EuRoC tree (8-bit gray PNG pairs) and
  a TUM tree (gray PNG + 16-bit depth PNG), written by io/png.py, read the
  same frames, depths and ground truth through both packages' readers; the
  port's run_dataset runs --euroc and --tum on them to its result line.
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOM = ["--bench", "room", "--width", "160", "--height", "120",
        "--keypoints", "256", "--levels", "2", "--max-keyframes", "16",
        "--max-landmarks", "2048"]


def _run(pkg, args, tmp_path):
    out = str(tmp_path / f"{pkg}.json")
    if pkg == "jax":
        from lpslam_tpu.eval import run_dataset
    else:
        from lpslam_tpu_torch.eval import run_dataset

        args = args + ["--device", "cpu"]
    assert run_dataset.main(args + ["--json-out", out]) == 0
    return json.loads(open(out).read())


@pytest.mark.parametrize("mode,frames,extra", [("mono", 48, ["--chunk", "8"]),
                                               ("stereo", 40, [])])
def test_room_matches_jax(tmp_path, mode, frames, extra):
    args = ROOM + ["--mode", mode, "--frames", str(frames)] + extra
    ref, ours = _run("jax", args, tmp_path), _run("torch", args, tmp_path)
    assert ours["frames"] == ref["frames"] == frames
    assert ref["tracked"] >= 20, ref
    assert ours["tracked"] >= ref["tracked"] - 1, (ours, ref)
    assert ours["ate_rmse"] <= max(1.5 * ref["ate_rmse"], ref["ate_rmse"] + 0.02), (ours, ref)
    assert ours["rectify_ms_per_frame"] > 0


def _write_trees(root, n=4, h=480, w=752):
    """The room rendered into EuRoC and TUM directory layouts."""
    from lpslam_tpu_torch.io import SyntheticBenchmark
    from lpslam_tpu_torch.io.png import write_png

    ds = SyntheticBenchmark(num_frames=n, h=h, w=w, seed=2, stereo=True, with_depth=True)
    frames = list(ds)
    gt = ds.ground_truth()
    u8 = lambda x: np.clip(np.round(x), 0, 255).astype(np.uint8)  # noqa: E731
    euroc = os.path.join(root, "euroc")
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(euroc, "mav0", cam, "data"))
    os.makedirs(os.path.join(euroc, "mav0", "state_groundtruth_estimate0"))
    tum = os.path.join(root, "tum")
    os.makedirs(os.path.join(tum, "rgb"))
    os.makedirs(os.path.join(tum, "depth"))
    rows, rgb, dep, gtl, gtt = [], [], [], [], []
    for i, f in enumerate(frames):
        ns = 1_403_636_579_763_555_584 + i * 50_000_000
        name = f"{ns}.png"
        write_png(os.path.join(euroc, "mav0", "cam0", "data", name), u8(f.image))
        write_png(os.path.join(euroc, "mav0", "cam1", "data", name), u8(f.image_right))
        rows.append(f"{ns},{name}")
        p = gt.positions[i]
        gtl.append(f"{ns},{p[0]},{p[1]},{p[2]},1.0,0.0,0.0,0.0")
        ts = 1305031102.0 + i * 0.05
        write_png(os.path.join(tum, "rgb", f"{ts:.6f}.png"), u8(f.image))
        write_png(os.path.join(tum, "depth", f"{ts + 0.004:.6f}.png"),
                  np.round(f.depth * 5000).astype(np.uint16))
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        dep.append(f"{ts + 0.004:.6f} depth/{ts + 0.004:.6f}.png")
        gtt.append(f"{ts:.4f} {p[0]} {p[1]} {p[2]} 0 0 0 1")
    for cam in ("cam0", "cam1"):
        with open(os.path.join(euroc, "mav0", cam, "data.csv"), "w") as fh:
            fh.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    with open(os.path.join(euroc, "mav0", "state_groundtruth_estimate0", "data.csv"), "w") as fh:
        fh.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n" + "\n".join(gtl) + "\n")
    for fname, lines in (("rgb.txt", rgb), ("depth.txt", dep), ("groundtruth.txt", gtt)):
        with open(os.path.join(tum, fname), "w") as fh:
            fh.write("# comment\n" + "\n".join(lines) + "\n")
    return euroc, tum


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return _write_trees(str(tmp_path_factory.mktemp("trees")))


def test_dataset_readers_match_jax(trees):
    from lpslam_tpu.io import datasets as jd
    from lpslam_tpu_torch.io import datasets as td

    euroc, tum = trees
    for a, b in ((td.EurocDataset(euroc), jd.EurocDataset(euroc)),
                 (td.TumRgbdDataset(tum), jd.TumRgbdDataset(tum))):
        fa, fb = list(a), list(b)
        assert len(fa) == len(fb) == len(a) == len(b) == 4
        for x, y in zip(fa, fb):
            assert x.timestamp == y.timestamp
            for k in ("image", "image_right", "depth"):
                u, v = getattr(x, k), getattr(y, k)
                assert (u is None) == (v is None), k
                if u is not None:
                    assert u.dtype == v.dtype == np.float32
                    np.testing.assert_array_equal(u, v, err_msg=k)
        ga, gb = a.ground_truth(), b.ground_truth()
        for k in ("timestamps", "positions", "quaternions_wxyz"):
            np.testing.assert_array_equal(getattr(ga, k), getattr(gb, k), err_msg=k)
        q = ga.timestamps[[0, 2]] + 0.01
        np.testing.assert_array_equal(ga.positions_at(q), gb.positions_at(q))
    assert fa[0].depth is not None and fa[0].depth.max() > 0.5
    np.testing.assert_array_equal(td.euroc_stereo_extrinsics()[0], jd.euroc_stereo_extrinsics()[0])


@pytest.mark.parametrize("which", ["euroc", "tum"])
def test_run_dataset_on_the_trees(trees, tmp_path, which):
    from lpslam_tpu_torch.eval import run_dataset

    root = trees[0] if which == "euroc" else trees[1]
    mode = "stereo" if which == "euroc" else "rgbd"
    out = str(tmp_path / "r.json")
    assert run_dataset.main([f"--{which}", root, "--mode", mode, "--keypoints", "256",
                             "--levels", "2", "--max-keyframes", "8", "--max-landmarks",
                             "2048", "--device", "cpu", "--json-out", out]) == 0
    res = json.loads(open(out).read())
    assert res["frames"] == 4 and res["mode"] == mode and res["device"] == "cpu"
    assert res["rectify_ms_per_frame"] > 0          # both intrinsics carry distortion


def test_rpe_matches_jax():
    from lpslam_tpu.eval import rpe_rmse as jrpe
    from lpslam_tpu_torch.eval import rpe_rmse

    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(size=(30, 3)), 0)
    est = 0.5 * gt + rng.normal(scale=0.05, size=gt.shape)
    for d in (1, 3):
        assert rpe_rmse(est, gt, d) == jrpe(est, gt, d)


@pytest.mark.parametrize("brief", ["polar", "binned", "gather", "exact"])
def test_brief_mode_choices(tmp_path, monkeypatch, brief):
    """--brief-mode takes the JAX tool's four choices and reaches the
    extraction: the mode's descriptor function runs on every extraction
    (the moment maps only off the polar path), and the room tracks."""
    from lpslam_tpu_torch.kernels import orb

    calls = []
    for name in ("orientation_maps", "polar_brief_from_patches", "_binned_from_patches",
                 "steered_brief_gather", "steered_brief"):
        orig = getattr(orb, name)
        monkeypatch.setattr(orb, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    out = _run("torch", ROOM + ["--mode", "mono", "--frames", "32", "--chunk", "8",
                                "--brief-mode", brief], tmp_path)
    want = {"polar": "polar_brief_from_patches", "binned": "_binned_from_patches",
            "gather": "steered_brief_gather", "exact": "steered_brief"}[brief]
    assert set(calls) == ({want} if brief == "polar" else {want, "orientation_maps"}), calls
    assert calls.count(want) >= 2 * 10          # 2 levels, every extraction
    assert out["frames"] == 32 and out["tracked"] >= 20, out


def test_brief_mode_unknown_choice_refused():
    from lpslam_tpu.eval import run_dataset as jrun
    from lpslam_tpu_torch.eval import run_dataset as trun

    for mod in (jrun, trun):
        with pytest.raises(SystemExit):
            mod.main(ROOM + ["--brief-mode", "hexagonal", "--frames", "2"])
