"""Binary-descriptor matching (port of lpslam_tpu/kernels/match.py).

Two hand-written CUDA kernels (csrc/hamming.cu) and their plain versions:

- ``hamming_matrix``: XOR and popcount of the packed words, int32, the
  distances of every matcher but the projected one. On the card the dense
  kernel (the tensor cores' single-bit AND + popcount product), on the CPU
  ``hamming_matrix_reference`` (a SWAR popcount).
- ``match_projected``: tracking's window-masked matcher in one launch on the
  card (no distance matrix is written), ``match_projected_reference`` on
  the CPU.

Any other device raises; there is no fallback. The JAX package's default form,
``hamming_matrix_mxu`` (the ±1 product d = (256 - a·b) / 2 as an fp32
matmul, exact because every partial sum is an integer of magnitude <= 256),
gives the same integers; it stays as an export and as the tests' yardstick,
so the matchers take the same pairs as JAX's with either ``use_mxu``.
Row/column argmins pick the lowest index on ties, as jnp.argmin does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda
from .fast import topk_stable

BITS = 256
WORDS = 8
BIG = 1e9
SOURCE = "hamming.cu"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_PROJECTED_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
_MAX_ROWS = 65535 * 64      # the kernel's grid.y limit times its rows per block

# kernel launches made by hamming_matrix_cuda since the last reset
LAUNCHES = 0
# kernel launches made by match_projected_cuda since the last reset
PROJECTED_LAUNCHES = 0


def _unpack_pm1(desc):
    """(..., N, 8) int32 bit patterns -> (..., N, 256) float32 in {-1, +1}."""
    words = desc.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], BITS).to(torch.float32) * 2.0 - 1.0


def hamming_matrix_mxu(desc_a, desc_b):
    """(Na, 8) x (Nb, 8) descriptors -> (Na, Nb) float32 Hamming distances."""
    dot = _unpack_pm1(desc_a) @ _unpack_pm1(desc_b).transpose(-1, -2)
    return (BITS - dot) * 0.5


_REF_PAIRS = 1 << 18    # pairs per block of the plain version: 8 MB of bytes


def _popcount_block(desc_a, desc_b):
    """(na, 8) x (nb, 8) int32 -> (na, nb) int32: XOR of the 32 bytes, a
    SWAR popcount in each byte, then the byte counts summed through int64
    views of 8 bytes (every sum stays below 2^63, so nothing overflows)."""
    x = desc_a.view(torch.uint8)[:, None, :] ^ desc_b.view(torch.uint8)[None, :, :]
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    x = (x + (x >> 4)) & 0x0F                            # each byte: its popcount
    w = x.view(torch.int64)                              # (na, nb, 4) of 8 counts
    s = w[..., 0] + w[..., 1] + w[..., 2] + w[..., 3]    # each byte <= 32
    s = (s & 0x00FF00FF00FF00FF) + ((s >> 8) & 0x00FF00FF00FF00FF)
    s = (s & 0x0000FFFF0000FFFF) + ((s >> 16) & 0x0000FFFF0000FFFF)
    return ((s & 0xFFFFFFFF) + (s >> 32)).to(torch.int32)


def hamming_matrix_reference(desc_a, desc_b):
    """(Na, 8) x (Nb, 8) int32 bit patterns -> (Na, Nb) int32 Hamming
    distances, by blocks of rows of desc_a (see _popcount_block)."""
    desc_a, desc_b = desc_a.contiguous(), desc_b.contiguous()
    rows = max(1, _REF_PAIRS // max(desc_b.shape[0], 1))
    if desc_a.shape[0] <= rows:
        return _popcount_block(desc_a, desc_b)
    return torch.cat([_popcount_block(desc_a[i:i + rows], desc_b)
                      for i in range(0, desc_a.shape[0], rows)])


def _check_cuda_args(desc_a, desc_b):
    if desc_a.device.type != "cuda" or desc_b.device != desc_a.device:
        raise ValueError("hamming_matrix_cuda needs both tensors on one CUDA device")
    if desc_a.dtype != torch.int32 or desc_b.dtype != torch.int32:
        raise TypeError("hamming_matrix_cuda takes int32 bit patterns")
    if not (desc_a.is_contiguous() and desc_b.is_contiguous()):
        raise ValueError("hamming_matrix_cuda takes contiguous tensors")
    if desc_a.dim() != 2 or desc_b.dim() != 2 or desc_a.shape[1] != WORDS \
            or desc_b.shape[1] != WORDS:
        raise ValueError(f"shapes {tuple(desc_a.shape)} / {tuple(desc_b.shape)}: "
                         f"want (Na, {WORDS}) / (Nb, {WORDS})")
    if desc_a.shape[0] > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows of desc_a")


def launch_hamming(desc_a, desc_b, out):
    """Launch the kernel on checked, non-empty tensors into ``out`` (Na, Nb);
    the one place that counts a launch."""
    global LAUNCHES
    fn = _cuda.entry(SOURCE, "lpslam_hamming", _ARGTYPES)
    _cuda.launch(fn, desc_a.device, desc_a.data_ptr(), desc_b.data_ptr(), out.data_ptr(),
                 desc_a.shape[0], desc_b.shape[0])
    LAUNCHES += 1


def hamming_matrix_cuda(desc_a, desc_b):
    """The CUDA kernel: (Na, 8) and (Nb, 8) int32 contiguous tensors on one
    CUDA device -> (Na, Nb) int32. Launches nothing when Na or Nb is 0."""
    _check_cuda_args(desc_a, desc_b)
    out = torch.empty((desc_a.shape[0], desc_b.shape[0]), dtype=torch.int32,
                      device=desc_a.device)
    if out.numel():
        launch_hamming(desc_a, desc_b, out)
    return out


def hamming_matrix(desc_a, desc_b):
    """(Na, 8) x (Nb, 8) descriptors -> (Na, Nb) int32 Hamming distances;
    see the module docstring for which version runs."""
    if desc_a.device.type == "cpu":
        return hamming_matrix_reference(desc_a, desc_b)
    if desc_a.device.type == "cuda":
        return hamming_matrix_cuda(desc_a.contiguous(), desc_b.contiguous())
    raise ValueError(f"no Hamming matrix for device {desc_a.device}")


def _distances(desc_a, desc_b):
    return hamming_matrix(desc_a, desc_b).to(torch.float32)


def match_mutual_nn(desc_a, desc_b, valid_a, valid_b,
                    max_distance: int = 50, ratio: float = 0.9):
    """Mutual nearest neighbours with Lowe-ratio and distance gates.
    Returns (idx_b (Na,) int64, ok (Na,) bool)."""
    D = _distances(desc_a, desc_b)
    D = torch.where(valid_a[:, None] & valid_b[None, :], D, BIG)
    best_b = torch.argmin(D, dim=1)
    rows = torch.arange(D.shape[0], device=D.device)
    d1 = D[rows, best_b]
    D2 = D.clone()
    D2[rows, best_b] = BIG
    d2 = torch.amin(D2, dim=1)
    best_a_of_b = torch.argmin(D, dim=0)
    mutual = best_a_of_b[best_b] == rows
    ok = mutual & (d1 <= max_distance) & (d1 <= ratio * d2) & valid_a
    return best_b, ok


def match_projected_reference(desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp,
                              radius, max_distance: int = 80):
    """The plain version of ``match_projected``: the (Nq, Nk) distance
    matrix, masked outside the window and where either side is invalid,
    then its row argmin (lowest index on ties)."""
    D = _distances(desc_q, desc_kp)
    d2px = torch.sum((uv_q[:, None, :] - uv_kp[None, :, :]) ** 2, dim=-1)
    in_window = d2px <= radius * radius
    D = torch.where(in_window & valid_q[:, None] & valid_kp[None, :], D, BIG)
    best = torch.argmin(D, dim=1)
    d1 = torch.gather(D, 1, best[:, None])[:, 0]
    ok = (d1 <= max_distance) & valid_q
    return best, ok


def _aligned(x):
    """``x`` contiguous and 16-byte aligned (the kernel's bulk copies and
    vector loads need it): a copy where a view starts off the alignment."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def match_projected_cuda(desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp,
                         radius: float, max_distance: int = 80):
    """The fused CUDA kernel: queries (Nq, 8) int32 / (Nq, 2) float32 /
    (Nq,) bool and keypoints the same with Nk rows, on one CUDA device;
    ``radius`` and ``max_distance`` Python numbers (compared in fp32, as
    PyTorch compares a float32 tensor with a Python scalar). Returns (idx
    (Nq,) int64, ok (Nq,) bool). Launches nothing when Nq is 0; raises for
    Nk of 0, as the plain version's argmin does."""
    global PROJECTED_LAUNCHES
    tensors = (desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp)
    dev = desc_q.device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("match_projected_cuda needs every tensor on one CUDA device")
    if isinstance(radius, torch.Tensor) or isinstance(max_distance, torch.Tensor):
        raise TypeError("match_projected_cuda takes radius and max_distance as numbers")
    nq, nk = desc_q.shape[0], desc_kp.shape[0]
    for name, x, dtype, shape in (
            ("desc_q", desc_q, torch.int32, (nq, WORDS)), ("uv_q", uv_q, torch.float32, (nq, 2)),
            ("valid_q", valid_q, torch.bool, (nq,)),
            ("desc_kp", desc_kp, torch.int32, (nk, WORDS)),
            ("uv_kp", uv_kp, torch.float32, (nk, 2)), ("valid_kp", valid_kp, torch.bool, (nk,))):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {x.dtype} {tuple(x.shape)}, want {dtype} {shape}")
    if nk == 0:
        raise IndexError("argmin(): Expected reduction dim 1 to have non-zero size.")
    idx = torch.empty((nq,), dtype=torch.int64, device=dev)
    ok = torch.empty((nq,), dtype=torch.bool, device=dev)
    if nq == 0:
        return idx, ok
    args = [_aligned(x) for x in tensors]
    fn = _cuda.entry(SOURCE, "lpslam_match_projected", _PROJECTED_ARGTYPES)
    _cuda.launch(fn, dev, *(x.data_ptr() for x in args), idx.data_ptr(), ok.data_ptr(),
                 nq, nk, float(np.float32(radius * radius)), float(np.float32(max_distance)))
    PROJECTED_LAUNCHES += 1
    return idx, ok


def match_projected(desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp,
                    radius, max_distance: int = 80):
    """Match queries (projected landmarks) against frame keypoints inside a
    pixel window. Returns (idx (Nq,) int64, ok (Nq,) bool): the fused
    kernel for CUDA tensors, the plain version for CPU ones."""
    if desc_q.device.type == "cpu":
        return match_projected_reference(desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp,
                                         radius, max_distance)
    if desc_q.device.type == "cuda":
        return match_projected_cuda(desc_q, uv_q, valid_q, desc_kp, uv_kp, valid_kp,
                                    radius, max_distance)
    raise ValueError(f"no projected matcher for device {desc_q.device}")


def orientation_consistency(angle_a, angle_b, idx, ok, bins: int = 30,
                            keep_top: int = 3):
    """Keep matches whose angle difference falls into the `keep_top` most
    populated of `bins` histogram bins (ties: lowest bin first)."""
    diff = angle_a - angle_b[idx]
    diff = torch.remainder(diff + np.pi, 2 * np.pi) - np.pi
    bin_idx = torch.clamp(
        ((diff + np.pi) * (bins / (2 * np.pi))).to(torch.int64), 0, bins - 1
    )
    hist = torch.zeros(bins, dtype=torch.int64, device=ok.device)
    hist.index_add_(0, bin_idx, ok.to(torch.int64))
    _, top_bins = topk_stable(hist, keep_top)
    in_top = torch.any(bin_idx[:, None] == top_bins[None, :], dim=1)
    return ok & in_top
