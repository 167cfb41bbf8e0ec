"""Fused two-threshold FAST-9/16 score + 3x3 NMS: the port of the TPU kernel
lpslam_tpu/kernels/pallas_fast.py:fast_nms_score_pallas.

- ``fast_nms_score_cuda``: the hand-written CUDA kernel (csrc/fast_nms.cu),
  one launch per pyramid level for a whole (B, H, W) batch.
- ``fast_nms_score_reference``: the plain PyTorch version — ``fast_score`` at
  both thresholds, the blend with the fixed ceiling, ``nms3x3`` — the same
  math as the Pallas kernel's small-level fallback (pallas_fast.py:126-132).
- ``fast_nms_score``: the dispatcher — CPU tensors take the plain version,
  CUDA tensors the kernel, anything else raises. There is no fallback.

The low-threshold ceiling is the fixed bound 1e-3 / (1 + 255 * 16) rounded to
float32, as the Pallas kernel builds it (pallas_fast.py:138); the composite
that ``extract_orb`` runs by default uses the frame's max instead.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda
from .fast import fast_score, nms3x3

LO_CEILING = float(np.float32(1e-3 / (1.0 + 255.0 * 16.0)))

# kernel launches made by fast_nms_score_cuda since the last reset
LAUNCHES = 0


def fast_nms_score_reference(img, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """(B, H, W) float32 images -> (B, H, W) blended, non-max-suppressed
    FAST scores, in plain PyTorch."""
    s_hi, _ = fast_score(img, thr_hi)
    s_lo, _ = fast_score(img, thr_lo)
    ceiling = torch.tensor(LO_CEILING, dtype=torch.float32, device=img.device)
    return nms3x3(torch.where(s_hi > 0, 1.0 + s_hi, s_lo * ceiling))


def fast_nms_score_cuda(img, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """The CUDA kernel: (B, H, W) float32 contiguous images on a CUDA device
    -> (B, H, W) scores."""
    global LAUNCHES
    if img.device.type != "cuda":
        raise ValueError("fast_nms_score_cuda needs a CUDA tensor")
    if img.dtype != torch.float32:
        raise TypeError("fast_nms_score_cuda takes float32 images")
    if not img.is_contiguous():
        raise ValueError("fast_nms_score_cuda takes a contiguous tensor")
    if img.dim() != 3:
        raise ValueError(f"shape {tuple(img.shape)}: want (B, H, W)")
    b, h, w = img.shape
    lib = build()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
    status = lib.lpslam_fast_nms_score(
        img.data_ptr(), out.data_ptr(), b, h, w,
        float(thr_hi), float(thr_lo), LO_CEILING, stream,
    )
    _cuda.check(status, "lpslam_fast_nms_score")
    LAUNCHES += 1
    return out


def fast_nms_score(img, thr_hi: float = 20.0, thr_lo: float = 7.0):
    """(B, H, W) level images -> (B, H, W) scores; see the module docstring
    for which version runs."""
    if img.device.type == "cpu":
        return fast_nms_score_reference(img, thr_hi, thr_lo)
    if img.device.type == "cuda":
        return fast_nms_score_cuda(img.contiguous(), thr_hi, thr_lo)
    raise ValueError(f"no FAST+NMS score for device {img.device}")


def build():
    """Compile (first call only) and load the kernel's library."""
    lib = _cuda.load_library("fast_nms.cu")
    fn = lib.lpslam_fast_nms_score
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
