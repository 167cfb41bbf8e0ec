"""Port parity, the Hamming matrix and the matchers built on it:
lpslam_tpu_torch.kernels.match against lpslam_tpu.kernels.match on the CPU.

Both forms of the distance are exact integers, so everything is bit-equal:
``hamming_matrix`` (the popcount; on the CPU its plain SWAR version, the
reference the CUDA kernel is held to on the card) equals JAX's
``hamming_matrix`` and both packages' ±1 products, at shapes including 0
rows, 1 x 1, odd sizes, all-equal and all-complement descriptors; and the
port's ``match_mutual_nn`` / ``match_projected`` (always the popcount) and
``match_stereo`` give JAX's indices and flags with either ``use_mxu``.

``match_projected_reference``, the plain version the fused CUDA kernel is
held to on the card, gives JAX's ``match_projected`` indices and flags bit
for bit on the cases the kernel must get right: ties at equal distance
(descriptors from a pool of 8: the lowest index wins), pairs exactly on the
window's edge (offsets 3, 4 at radius 5) and just outside it, NaN pixels,
rows with nothing in the window, rows with ``valid_q`` false, a Hamming
gate above BIG (an empty valid row is then ok, in both) and Nq = 0; for
Nk = 0 both packages raise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lpslam_tpu.kernels import match as jmatch

from lpslam_tpu_torch.kernels import hamming_matrix
from lpslam_tpu_torch.kernels import match as tmatch

torch.set_num_threads(1)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _cases():
    rng = np.random.default_rng(5)
    a = _desc(rng, 57)
    yield "random 57x131", a, _desc(rng, 131)
    yield "1x1", a[:1], a[1:2]
    yield "0x5", a[:0], a[:5]
    yield "5x0", a[:5], a[:0]
    yield "equal", a, a
    yield "complement", a, ~a
    yield "extremes", np.array([[0] * 8, [0xFFFFFFFF] * 8, [0x80000000] * 8], np.uint32), a[:7]


@pytest.mark.parametrize("case", [c[0] for c in _cases()])
def test_hamming_matrix_matches_jax(case):
    _, a, b = next(c for c in _cases() if c[0] == case)
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    ours = hamming_matrix(ta, tb)
    assert ours.dtype == torch.int32 and ours.shape == (len(a), len(b))
    ref = np.asarray(jmatch.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), tmatch.hamming_matrix_mxu(ta, tb).numpy())
    if case == "equal":
        assert (np.diag(ref) == 0).all()
    if case == "complement":
        assert (np.diag(ref) == 256).all()


def test_hamming_dispatch_refuses_other_devices():
    a = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        hamming_matrix(a.to("meta"), a.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tmatch.hamming_matrix_cuda(a, a)


def _matching_inputs(seed=3, na=90, nb=110):
    """Descriptors with planted near-duplicates, so the gates pass some."""
    rng = np.random.default_rng(seed)
    b = _desc(rng, nb)
    a = _desc(rng, na)
    src = rng.choice(nb, na // 2, replace=False)
    flips = rng.integers(0, 2, (na // 2, 8), dtype=np.uint32) << rng.integers(0, 32, (na // 2, 8),
                                                                             dtype=np.uint32)
    a[: na // 2] = b[src] ^ flips
    va, vb = rng.random(na) > 0.1, rng.random(nb) > 0.1
    uv_b = rng.uniform(0, 160, (nb, 2)).astype(np.float32)
    uv_a = rng.uniform(0, 160, (na, 2)).astype(np.float32)
    uv_a[: na // 2] = uv_b[src] + rng.normal(0, 3, (na // 2, 2)).astype(np.float32)
    return a, b, va, vb, uv_a, uv_b


def test_matchers_match_jax_in_both_forms():
    a, b, va, vb, uv_a, uv_b = _matching_inputs()
    T = torch.from_numpy
    ta, tb = T(a.view(np.int32)), T(b.view(np.int32))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    i_t, ok_t = tmatch.match_mutual_nn(ta, tb, T(va), T(vb), 80, 0.9)
    assert 20 < int(ok_t.sum()) < len(a)
    p_t, pok_t = tmatch.match_projected(ta, T(uv_a), T(va), tb, T(uv_b), T(vb), 15.0, 80)
    assert 20 < int(pok_t.sum()) < len(a)
    for use_mxu in (False, True):
        i_j, ok_j = jmatch.match_mutual_nn(ja, jb, jnp.asarray(va), jnp.asarray(vb), 80, 0.9,
                                           use_mxu=use_mxu)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        i_j, ok_j = jmatch.match_projected(ja, jnp.asarray(uv_a), jnp.asarray(va), jb,
                                           jnp.asarray(uv_b), jnp.asarray(vb), 15.0, 80,
                                           use_mxu=use_mxu)
        np.testing.assert_array_equal(pok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(i_j))


def test_match_stereo_matches_jax():
    from lpslam_tpu.kernels import stereo as jstereo

    from lpslam_tpu_torch.kernels import stereo as tstereo

    a, b, va, vb, uv_a, uv_b = _matching_inputs(seed=7)
    # the planted pairs lie within 3 px (sigma) of each other: gates wide
    # enough to keep most of them, narrow enough to mask most other pairs
    gates = dict(y_margin=8.0, min_disparity=-8.0, max_disparity=8.0, max_hamming=80)
    T = torch.from_numpy
    d_t, i_t, ok_t = tstereo.match_stereo(T(a.view(np.int32)), T(uv_a), T(va),
                                          T(b.view(np.int32)), T(uv_b), T(vb), **gates)
    d_j, i_j, ok_j = jstereo.match_stereo(jnp.asarray(a), jnp.asarray(uv_a), jnp.asarray(va),
                                          jnp.asarray(b), jnp.asarray(uv_b), jnp.asarray(vb),
                                          **gates)
    assert 20 < int(ok_t.sum()) < len(a)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def _projected_cases():
    """(name, desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp, radius,
    max_distance) for match_projected: 60 queries x 90 keypoints in a 64 x 48
    frame unless the case says otherwise."""
    rng = np.random.default_rng(11)
    nq, nk = 60, 90

    def pix(n):
        return rng.uniform(0, [64, 48], (n, 2)).astype(np.float32)

    dq, dk = _desc(rng, nq), _desc(rng, nk)
    vq, vk = rng.random(nq) > 0.1, rng.random(nk) > 0.1
    yield "random", dq, pix(nq), vq, dk, pix(nk), vk, 12.0, 128
    pool = _desc(rng, 8)
    tq, tk = pool[rng.integers(0, 8, nq)], pool[rng.integers(0, 8, nk)]
    yield "ties", tq, pix(nq), vq, tk, pix(nk), vk, 20.0, 256
    # every query (at whole pixels, so the offsets are exact) sees keypoints
    # at offsets (3, 4) and (-3, -4) (on the edge of radius 5), and at
    # (3, 4.0001) and (0, 5.5) (outside) with its own descriptor
    uq = np.floor(pix(nq))
    uk = np.concatenate([uq + [3, 4], uq + np.float32([-3, -4]), uq + np.float32([3, 4.0001]),
                         uq + np.float32([0, 5.5])]).astype(np.float32)
    ek = np.concatenate([dq ^ 7, dq ^ 0xFF, dq, dq]).astype(np.uint32)
    yield ("window edge", dq, uq, np.ones(nq, bool), ek, uk, np.ones(4 * nq, bool), 5.0, 80)
    nan_q, nan_k = pix(nq), pix(nk)
    nan_q[::5, 0] = np.nan
    nan_k[::3, 1] = np.nan
    yield "nan pixels", tq, nan_q, vq, tk, nan_k, vk, 25.0, 256
    far = pix(nq)
    far[::2] += 1000.0                          # nothing in these rows' windows
    vq_half = vq.copy()
    vq_half[1::4] = False
    yield "empty and invalid rows", dq, far, vq_half, dk, pix(nk), vk, 15.0, 128
    yield "gate above BIG", dq, far, vq_half, dk, pix(nk), vk, 15.0, 2_000_000_000
    yield "no queries", dq[:0], pix(0), vq[:0], dk, pix(nk), vk, 25.0, 80


@pytest.mark.parametrize("case", [c[0] for c in _projected_cases()])
def test_match_projected_reference_matches_jax(case):
    _, dq, uq, vq, dk, uk, vk, radius, max_d = next(
        c for c in _projected_cases() if c[0] == case)
    T = torch.from_numpy
    idx, ok = tmatch.match_projected_reference(T(dq.view(np.int32)), T(uq), T(vq),
                                               T(dk.view(np.int32)), T(uk), T(vk),
                                               radius, max_d)
    assert idx.dtype == torch.int64 and ok.dtype == torch.bool and idx.shape == (len(dq),)
    got = tmatch.match_projected(T(dq.view(np.int32)), T(uq), T(vq), T(dk.view(np.int32)),
                                 T(uk), T(vk), radius, max_d)
    assert torch.equal(got[0], idx) and torch.equal(got[1], ok)    # the CPU dispatch
    for use_mxu in (False, True):
        i_j, ok_j = jmatch.match_projected(jnp.asarray(dq), jnp.asarray(uq), jnp.asarray(vq),
                                           jnp.asarray(dk), jnp.asarray(uk), jnp.asarray(vk),
                                           radius, max_d, use_mxu=use_mxu)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    if case == "ties":
        # equal minima abound, and the lowest index among them wins
        D = tmatch.hamming_matrix_reference(T(dq.view(np.int32)), T(dk.view(np.int32)))
        D = D.numpy().astype(np.float64)
        inside = ((uq[:, None, :] - uk[None, :, :]) ** 2).sum(-1) <= radius ** 2
        D = np.where(inside & vq[:, None] & vk[None, :], D, 1e9)
        tied = (D == D.min(1, keepdims=True)).sum(1) > 1
        assert (tied & ok.numpy()).sum() >= 10
        np.testing.assert_array_equal(idx.numpy(), D.argmin(1))
    if case == "window edge":
        # the (3, 4) keypoint (index q) is inside the window: its descriptor
        # differs from the query's by 3 bits, the (-3, -4) one by 8, and the
        # equal descriptor lies outside (by 1e-4 px, or 5.5 px away)
        np.testing.assert_array_equal(idx.numpy(), np.arange(len(dq)))
        assert ok.all()
    if case == "empty and invalid rows":
        empty = (uq[:, 0] > 500) | ~vq
        assert (idx.numpy()[empty] == 0).all() and not ok.numpy()[empty].any()
        assert ok.numpy()[~empty].any()
    if case == "gate above BIG":
        np.testing.assert_array_equal(ok.numpy(), vq)


def test_match_projected_without_keypoints_raises_in_both():
    z = np.zeros((3, 8), np.uint32)
    uv = np.zeros((3, 2), np.float32)
    v = np.ones(3, bool)
    T = torch.from_numpy
    with pytest.raises(IndexError):
        tmatch.match_projected(T(z.view(np.int32)), T(uv), T(v), T(z[:0].view(np.int32)),
                               T(uv[:0]), T(v[:0]), 25.0, 80)
    with pytest.raises(ValueError):
        jmatch.match_projected(jnp.asarray(z), jnp.asarray(uv), jnp.asarray(v),
                               jnp.asarray(z[:0]), jnp.asarray(uv[:0]), jnp.asarray(v[:0]),
                               25.0, 80)


def test_match_projected_dispatch_refuses_other_devices():
    d = torch.zeros((3, 8), dtype=torch.int32)
    uv = torch.zeros((3, 2))
    v = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="device"):
        tmatch.match_projected(*(x.to("meta") for x in (d, uv, v, d, uv, v)), 25.0, 80)
    with pytest.raises(ValueError, match="CUDA"):
        tmatch.match_projected_cuda(d, uv, v, d, uv, v, 25.0, 80)
