"""Port parity, geometry / matching / small solvers: lpslam_tpu_torch vs
lpslam_tpu on the same numpy inputs (fp32 on both sides).

Tolerances: Lie-group and camera maps 1e-5 absolute (fp32 rounding of a few
chained ops); matching indices bit-equal (integer Hamming distances, argmin
ties to the lowest index on both sides); 6x6/3x3 solves 1e-4 relative;
pose-only optimization and triangulation 1e-3 (iterated fp32 solves whose
summation order differs between XLA and torch).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.frontend import init2v as jinit
from lpslam_tpu.frontend import pose_opt as jpose
from lpslam_tpu.frontend import triangulate as jtri
from lpslam_tpu.geometry import camera as jcam
from lpslam_tpu.geometry import se3 as jse3
from lpslam_tpu.geometry import so3 as jso3
from lpslam_tpu.io.benchmark import BENCH_CAM
from lpslam_tpu.kernels import linalg as jlin
from lpslam_tpu.kernels import match as jmatch

from lpslam_tpu_torch.frontend import init2v as tinit
from lpslam_tpu_torch.frontend import pose_opt as tpose
from lpslam_tpu_torch.frontend import triangulate as ttri
from lpslam_tpu_torch.geometry import camera as tcam
from lpslam_tpu_torch.geometry import se3 as tse3
from lpslam_tpu_torch.geometry import so3 as tso3
from lpslam_tpu_torch.kernels import linalg as tlin
from lpslam_tpu_torch.kernels import match as tmatch

torch.set_num_threads(1)

T = torch.from_numpy


def _np(x):
    return np.array(x)  # a writable copy, so torch.from_numpy takes it as is


def _close(a, b, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol)


def _cams():
    fx, fy, cx, cy = 115.0, 118.0, 80.0, 60.0
    return (jcam.PinholeCamera.make(fx, fy, cx, cy),
            tcam.PinholeCamera.make(fx, fy, cx, cy, device="cpu"))


def test_so3_se3_maps():
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.8, (64, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-5  # the small-angle series branch
    p = rng.normal(0, 2, (64, 3)).astype(np.float32)
    _close(tso3.hat(T(xi[:, 3:])).numpy(), jso3.hat(jnp.asarray(xi[:, 3:])))
    Rj = jso3.so3_exp(jnp.asarray(xi[:, 3:]))
    Rt = tso3.so3_exp(T(xi[:, 3:]))
    _close(Rt.numpy(), Rj)
    _close(tso3.so3_log(Rt).numpy(), jso3.so3_log(Rj), atol=2e-5)
    Tj = jse3.se3_exp(jnp.asarray(xi))
    Tt = tse3.se3_exp(T(xi))
    _close(Tt.R.numpy(), Tj.R)
    _close(Tt.t.numpy(), Tj.t)
    _close(tse3.se3_log(Tt).numpy(), jse3.se3_log(Tj), atol=3e-5)
    Cj = jse3.se3_compose(Tj, jse3.se3_inverse(jse3.SE3(Tj.R[::-1], Tj.t[::-1])))
    Ct = tse3.se3_compose(Tt, tse3.se3_inverse(tse3.SE3(Tt.R.flip(0), Tt.t.flip(0))))
    _close(Ct.R.numpy(), Cj.R)
    _close(Ct.t.numpy(), Cj.t, atol=2e-5)
    _close(tse3.se3_apply(Tt, T(p)).numpy(), jse3.se3_apply(Tj, jnp.asarray(p)), atol=2e-5)


def test_camera_models():
    jc, tc = _cams()
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.normal(0, 1, (50, 2)), rng.uniform(0.5, 5, (50, 1))], 1)
    p = p.astype(np.float32)
    uv_j = jcam.project_pinhole(jc, jnp.asarray(p))
    uv_t = tcam.project_pinhole(tc, T(p))
    _close(uv_t.numpy(), uv_j, atol=1e-4)  # pixels ~1e2: fp32 ulp ~1e-5
    _close(tcam.unproject_pinhole(tc, uv_t).numpy(), jcam.unproject_pinhole(jc, uv_j))
    dist = np.asarray(BENCH_CAM["dist"], np.float32)
    xy = rng.uniform(-0.8, 0.8, (100, 2)).astype(np.float32)
    _close(tcam.distort_radtan(T(xy), T(dist)).numpy(),
           jcam.distort_radtan(jnp.asarray(xy), jnp.asarray(dist)))
    _close(tcam.undistort_points_radtan(T(xy), T(dist)).numpy(),
           jcam.undistort_points_radtan(jnp.asarray(xy), jnp.asarray(dist)))


def test_undistort_map_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    K = np.array([[BENCH_CAM["fx"], 0, BENCH_CAM["cx"]],
                  [0, BENCH_CAM["fy"], BENCH_CAM["cy"]], [0, 0, 1.0]])
    dist = np.asarray(BENCH_CAM["dist"], np.float64)
    h, w = BENCH_CAM["height"], BENCH_CAM["width"]
    ref = cv2.initUndistortRectifyMap(K, dist, np.eye(3), K, (w, h), cv2.CV_32FC2)[0]
    ours = tcam.undistort_map_radtan(K, dist, (h, w))
    assert ours.shape == ref.shape == (h, w, 2) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-3


def _desc_set(rng, n, base=None, flip=0.1):
    if base is None:
        return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    bits = np.unpackbits(base.view(np.uint8), axis=1)
    bits ^= (rng.random(bits.shape) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1).view(np.uint32)


def test_hamming_and_matchers_bit_equal():
    rng = np.random.default_rng(2)
    da = _desc_set(rng, 300)
    db = np.concatenate([_desc_set(rng, 200, da[:200]), _desc_set(rng, 150)])
    va = rng.random(300) < 0.9
    vb = rng.random(350) < 0.9
    ta, tb = T(da.view(np.int32)), T(db.view(np.int32))
    np.testing.assert_array_equal(
        tmatch.hamming_matrix_mxu(ta, tb).numpy(),
        _np(jmatch.hamming_matrix_mxu(jnp.asarray(da), jnp.asarray(db))).astype(np.float32),
    )
    i_j, ok_j = jmatch.match_mutual_nn(jnp.asarray(da), jnp.asarray(db),
                                       jnp.asarray(va), jnp.asarray(vb), 80, 0.9)
    i_t, ok_t = tmatch.match_mutual_nn(ta, tb, T(va), T(vb), 80, 0.9)
    np.testing.assert_array_equal(i_t.numpy(), _np(i_j))
    np.testing.assert_array_equal(ok_t.numpy(), _np(ok_j))
    assert ok_t.sum() > 100

    uv_a = rng.uniform(0, 160, (300, 2)).astype(np.float32)
    uv_b = np.concatenate([uv_a[:200] + rng.normal(0, 3, (200, 2)),
                           rng.uniform(0, 160, (150, 2))]).astype(np.float32)
    i_j, ok_j = jmatch.match_projected(jnp.asarray(da), jnp.asarray(uv_a), jnp.asarray(va),
                                       jnp.asarray(db), jnp.asarray(uv_b), jnp.asarray(vb),
                                       radius=8.0, max_distance=80)
    i_t, ok_t = tmatch.match_projected(ta, T(uv_a), T(va), tb, T(uv_b), T(vb),
                                       radius=8.0, max_distance=80)
    np.testing.assert_array_equal(i_t.numpy(), _np(i_j))
    np.testing.assert_array_equal(ok_t.numpy(), _np(ok_j))

    ang_a = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 350).astype(np.float32)
    ang_b[:200] = ang_a[:200] - 0.3
    oc_j = jmatch.orientation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), i_j, ok_j)
    oc_t = tmatch.orientation_consistency(T(ang_a), T(ang_b), i_t, ok_t)
    np.testing.assert_array_equal(oc_t.numpy(), _np(oc_j))


def test_linalg_solvers():
    rng = np.random.default_rng(3)
    A = rng.normal(0, 1, (32, 6, 6))
    spd = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    m3 = spd[:, :3, :3]
    _close(tlin.inv3x3(T(m3)).numpy(), jlin.inv3x3(jnp.asarray(m3)), rtol=1e-4, atol=1e-5)
    bad = m3.copy()
    bad[0] = np.outer([1, 2, 3], [1, 2, 3])  # singular: the guard zeroes it
    g_t = tlin.inv3x3_guarded(T(bad)).numpy()
    _close(g_t, jlin.inv3x3_guarded(jnp.asarray(bad)), rtol=1e-4, atol=1e-5)
    assert not g_t[0].any()
    _close(tlin.inv6x6_spd(T(spd)).numpy(), jlin.inv6x6_spd(jnp.asarray(spd)),
           rtol=1e-4, atol=1e-4)
    _close(tlin.solve_spd_6x6(T(spd[0]), T(b)).numpy(),
           jlin.solve_spd_6x6(jnp.asarray(spd[0]), jnp.asarray(b)), rtol=1e-4, atol=1e-4)


def _scene(seed, n=400):
    """Points in front of two cameras, noisy pixel observations."""
    jc, tc = _cams()
    rng = np.random.default_rng(seed)
    pw = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 6, (n, 1))], 1)
    R2 = np.asarray(jso3.so3_exp(jnp.asarray([0.02, -0.05, 0.01], jnp.float32)))
    t2 = np.array([-0.4, 0.05, 0.02], np.float32)
    uv1 = _np(jcam.project_pinhole(jc, jnp.asarray(pw, jnp.float32)))
    uv2 = _np(jcam.project_pinhole(jc, jnp.asarray(pw @ R2.T + t2, jnp.float32)))
    uv1 = (uv1 + rng.normal(0, 0.5, uv1.shape)).astype(np.float32)
    uv2 = (uv2 + rng.normal(0, 0.5, uv2.shape)).astype(np.float32)
    uv2[:40] += rng.uniform(-30, 30, (40, 2)).astype(np.float32)  # outliers
    return jc, tc, pw.astype(np.float32), R2.astype(np.float32), t2, uv1, uv2


def test_pose_only_optimize():
    jc, tc, pw, R2, t2, _, uv2 = _scene(4)
    valid = np.ones(len(pw), bool)
    valid[-20:] = False
    R0 = np.asarray(jso3.so3_exp(jnp.asarray([0.03, -0.02, 0.0], jnp.float32))) @ R2
    t0 = (t2 + np.array([0.05, -0.03, 0.04])).astype(np.float32)
    rj = jpose.pose_only_optimize(jse3.SE3(jnp.asarray(R0), jnp.asarray(t0)), jc,
                                  jnp.asarray(pw), jnp.asarray(uv2), jnp.asarray(valid),
                                  iters=6)
    rt = tpose.pose_only_optimize(tse3.SE3(T(R0), T(t0)), tc, T(pw), T(uv2), T(valid),
                                  iters=6)
    _close(rt.pose.R.numpy(), rj.pose.R, atol=1e-4)
    _close(rt.pose.t.numpy(), rj.pose.t, atol=1e-4)
    assert np.sum(rt.inlier.numpy() != _np(rj.inlier)) <= 1
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1
    _close(rt.final_cost.numpy(), rj.final_cost, rtol=1e-3)
    _close(rt.sigma_pos.numpy(), rj.sigma_pos, rtol=1e-3, atol=1e-6)
    # the optimum is the true pose up to the pixel noise
    assert np.abs(rt.pose.t.numpy() - t2).max() < 0.02


def test_triangulate_and_two_view_init():
    jc, tc, pw, R2, t2, uv1, uv2 = _scene(5)
    T1j = jse3.SE3(jnp.eye(3), jnp.zeros(3))
    T2j = jse3.SE3(jnp.asarray(R2), jnp.asarray(t2))
    T1t = tse3.SE3(torch.eye(3), torch.zeros(3))
    T2t = tse3.SE3(T(R2), T(t2))
    pj, ij = jtri.triangulate_midpoint(T1j, T2j, jc, jnp.asarray(uv1), jnp.asarray(uv2))
    pt, it = ttri.triangulate_midpoint(T1t, T2t, tc, T(uv1), T(uv2))
    _close(pt.numpy(), pj, atol=1e-3, rtol=1e-4)
    for k in ("z1", "z2", "cos_parallax"):
        _close(it[k].numpy(), ij[k], atol=1e-3, rtol=1e-4)

    # outcomes of the homography bootstrap: the sign conventions of the two
    # SVDs differ, so compare H up to scale, the chosen pose and the mask
    valid = np.ones(len(uv1), bool)
    x1 = _np(jcam.unproject_pinhole(jc, jnp.asarray(uv1)))[:, :2]
    x2 = _np(jcam.unproject_pinhole(jc, jnp.asarray(uv2)))[:, :2]
    Hj, _ = jinit.homography_irls(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid))
    Ht, _ = tinit.homography_irls(T(x1), T(x2), T(valid))
    Hj, Ht = _np(Hj), Ht.numpy()
    _close(Ht / np.linalg.norm(Ht), Hj / np.linalg.norm(Hj), atol=1e-4)
    rj = jinit.two_view_init_homography(jc, jnp.asarray(uv1), jnp.asarray(uv2),
                                        jnp.asarray(valid))
    rt = tinit.two_view_init_homography(tc, T(uv1), T(uv2), T(valid))
    assert bool(rt.ok) == bool(rj.ok)
    _close(rt.T2cw.numpy(), rj.T2cw, atol=1e-3)
    assert np.mean(rt.point_ok.numpy() == _np(rj.point_ok)) >= 0.99
    assert abs(int(rt.n_good) - int(rj.n_good)) <= 0.01 * len(uv1)
