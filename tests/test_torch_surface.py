"""Port parity, the package surface: every name a JAX subpackage's
``__init__`` exports is exported by the port's, compared by AST (nothing is
imported), with an allowlist that is now empty; no subpackage is missing. Then the helpers that surface brought in, against JAX on the
CPU: so3.vee / quat_normalize, se3_from_Rt / se3_retract / se3_to_matrix /
se3_from_matrix / se3_adjoint, and three helpers no test held before:
io.synthetic.warp_homography, SlamManager.vehicle_pose_from_marker and
pipeline.queues.FramerateCompute.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

ALLOWED_GAPS = set()                # every JAX export is ported
ALLOWED_MISSING_PACKAGES = set()   # every JAX subpackage is ported


def _exports(path: Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
    return names


def test_every_jax_export_is_ported_or_allowlisted():
    gaps, missing = set(), set()
    for init in sorted((REPO / "lpslam_tpu").glob("*/__init__.py")):
        sub = init.parent.name
        ours = REPO / "lpslam_tpu_torch" / sub / "__init__.py"
        if not ours.exists():
            missing.add(sub)
            continue
        gaps |= {(sub, n) for n in _exports(init) - _exports(ours)}
    assert missing == ALLOWED_MISSING_PACKAGES
    assert gaps == ALLOWED_GAPS, sorted(gaps ^ ALLOWED_GAPS)


def test_exports_resolve():
    import importlib

    for init in sorted((REPO / "lpslam_tpu_torch").glob("*/__init__.py")):
        mod = importlib.import_module(f"lpslam_tpu_torch.{init.parent.name}")
        for name in _exports(init):
            assert hasattr(mod, name), (init.parent.name, name)


def _rng_rot(rng, n):
    from lpslam_tpu.geometry.so3 import so3_exp

    return np.array(so3_exp(jnp.asarray(rng.normal(0, 1.0, (n, 3)), jnp.float32)))


@pytest.mark.parametrize("fn", ["vee", "quat_normalize"])
def test_so3_helpers_match_jax(fn):
    from lpslam_tpu.geometry import so3 as jso3
    from lpslam_tpu_torch.geometry import so3 as tso3

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(5, 3, 3)) if fn == "vee" else
         np.concatenate([rng.normal(size=(4, 4)), np.zeros((1, 4))])).astype(np.float32)
    ref = np.asarray(getattr(jso3, fn)(jnp.asarray(x)))
    ours = getattr(tso3, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_se3_helpers_match_jax():
    from lpslam_tpu.geometry import se3 as jse3
    from lpslam_tpu_torch.geometry import se3 as tse3

    rng = np.random.default_rng(1)
    R = _rng_rot(rng, 4)
    t = rng.normal(size=(4, 3)).astype(np.float32)
    xi = rng.normal(0, 0.3, (4, 6)).astype(np.float32)
    J = jse3.se3_from_Rt(R, t)
    T = tse3.se3_from_Rt(torch.from_numpy(R), torch.from_numpy(t))
    np.testing.assert_array_equal(T.R.numpy(), np.asarray(J.R))
    tol = dict(rtol=1e-5, atol=1e-6)
    for name in ("se3_to_matrix", "se3_adjoint"):
        np.testing.assert_allclose(getattr(tse3, name)(T).numpy(),
                                   np.asarray(getattr(jse3, name)(J)), **tol)
    Jr = jse3.se3_retract(J, jnp.asarray(xi))
    Tr = tse3.se3_retract(T, torch.from_numpy(xi))
    np.testing.assert_allclose(Tr.R.numpy(), np.asarray(Jr.R), **tol)
    np.testing.assert_allclose(Tr.t.numpy(), np.asarray(Jr.t), **tol)
    M = tse3.se3_to_matrix(T)
    back = tse3.se3_from_matrix(M)
    Jb = jse3.se3_from_matrix(jnp.asarray(M.numpy()))
    np.testing.assert_array_equal(back.R.numpy(), np.asarray(Jb.R))
    np.testing.assert_array_equal(back.t.numpy(), np.asarray(Jb.t))


def test_warp_homography_matches_jax():
    from lpslam_tpu.io.synthetic import warp_homography as jwarp
    from lpslam_tpu_torch.io import warp_homography

    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    H = np.array([[1.05, 0.02, -3.0], [-0.01, 0.97, 2.5], [1e-4, -2e-4, 1.0]])
    for shape in (None, (30, 60)):
        ours = warp_homography(img, H, shape)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, jwarp(img, H, shape))
    assert (warp_homography(img, np.diag([1.0, 1.0, 1.0]) + [[0, 0, 100], [0, 0, 0], [0, 0, 0]])
            [:, :40] == 128.0).all()                      # outside the source


def test_vehicle_pose_from_marker_matches_jax():
    from lpslam_tpu.pipeline.manager import SlamManager as JManager
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    ours, ref = SlamManager(device="cpu"), JManager()
    q = np.array([0.9, 0.1, -0.3, 0.2])
    q /= np.linalg.norm(q)
    for m in (ours, ref):
        m.add_marker(7, [1.0, -2.0, 0.5], q)
    meas_q = np.array([0.8, -0.2, 0.1, 0.4]) / np.linalg.norm([0.8, -0.2, 0.1, 0.4])
    a = ours.vehicle_pose_from_marker(7, [0.3, 0.2, 1.5], meas_q)
    b = ref.vehicle_pose_from_marker(7, [0.3, 0.2, 1.5], meas_q)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-12)
    assert ours.vehicle_pose_from_marker(8, [0, 0, 0], meas_q) is None


def test_framerate_compute_matches_jax(monkeypatch):
    from lpslam_tpu.pipeline import queues as jq
    from lpslam_tpu_torch.pipeline import queues as tq

    clock = iter(np.cumsum(np.tile([0.05, 0.07, 0.04], 20)).tolist())
    now = {"t": 0.0}
    for mod in (jq, tq):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now["t"])
    ours, ref = tq.FramerateCompute(window=10), jq.FramerateCompute(window=10)
    assert ours.fps == ref.fps == 0.0
    seen = []
    for t in clock:
        now["t"] = t
        ours.tick()
        ref.tick()
        assert ours.fps == ref.fps
        seen.append(ours.fps)
    assert seen[-1] == pytest.approx(3 / (0.05 + 0.07 + 0.04))   # 9 gaps of 0.16 / 3 s
