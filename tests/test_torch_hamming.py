"""Port parity, the Hamming matrix and the matchers built on it:
lpslam_tpu_torch.kernels.match against lpslam_tpu.kernels.match on the CPU.

Both forms of the distance are exact integers, so everything is bit-equal:
``hamming_matrix`` (the popcount; on the CPU its plain SWAR version, the
reference the CUDA kernel is held to on the card) equals JAX's
``hamming_matrix`` and both packages' ±1 products, at shapes including 0
rows, 1 x 1, odd sizes, all-equal and all-complement descriptors; and the
port's ``match_mutual_nn`` / ``match_projected`` (always the popcount) and
``match_stereo`` give JAX's indices and flags with either ``use_mxu``.
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
