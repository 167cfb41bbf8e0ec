"""Fused two-threshold FAST-9/16 score + 3x3 NMS: the port of the TPU kernel
lpslam_tpu/kernels/pallas_fast.py:fast_nms_score_pallas.

The score has the JAX package's two forms, which differ only in the ceiling
that scales the low-threshold score under the high-threshold one:
- the fixed ceiling 1e-3 / (1 + 255 * 16) rounded to float32, as the Pallas
  kernel builds it (pallas_fast.py:138): ``frame_ceiling=False``, what
  ``OrbParams(use_pallas=True)`` runs;
- each frame's own 1e-3 / (1 + max low-threshold score), the composite of
  ``extract_orb``'s default (lpslam_tpu/kernels/orb.py:520-525):
  ``frame_ceiling=True``.
The Pallas kernel takes the ceiling as an operand, and so does the CUDA
kernel: one float per frame on the device.

- ``fast_nms_score_cuda``: the hand-written CUDA kernels (csrc/fast_nms.cu),
  one launch per pyramid level for a whole (B, H, W) batch; with
  ``frame_ceiling=True`` one launch of the max pass (``fast_lo_max_cuda``)
  before it, and the ceiling formed on the device by the plain version's
  expression, with no host read.
- ``fast_nms_score_reference``: the plain PyTorch version — ``fast_score`` at
  both thresholds, the blend, ``nms3x3`` — the same math as the Pallas
  kernel's small-level fallback (pallas_fast.py:126-132) or as the composite.
- ``fast_nms_score``: the dispatcher — CPU tensors take the plain version,
  CUDA tensors the kernels, anything else raises. There is no fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda
from .fast import fast_score, nms3x3

LO_CEILING = float(np.float32(1e-3 / (1.0 + 255.0 * 16.0)))
SOURCE = "fast_nms.cu"
_SCORE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
_MAX_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]

# launches of the score kernel and of the max pass since the last reset
LAUNCHES = 0
MAX_LAUNCHES = 0

_FIXED_CEILINGS: dict = {}


def frame_lo_ceiling(max_lo):
    """The composite's ceiling from a frame's maximum low-threshold score: one
    correctly rounded float32 division, as the JAX package computes it
    (``1e-3 / tensor`` is torch's ``reciprocal() * 1e-3``, rounded twice and
    one ulp off on some frames)."""
    return torch.full_like(max_lo, 1e-3) / (1.0 + max_lo)


def fast_lo_max_reference(img, thr_lo: float = 7.0):
    """(B, H, W) images -> (B,) maxima of the low-threshold FAST score."""
    return torch.amax(fast_score(img, thr_lo)[0], dim=(-2, -1))


def fast_nms_score_reference(img, thr_hi: float = 20.0, thr_lo: float = 7.0,
                             frame_ceiling: bool = False):
    """(B, H, W) float32 images -> (B, H, W) blended, non-max-suppressed
    FAST scores, in plain PyTorch."""
    s_hi, _ = fast_score(img, thr_hi)
    s_lo, _ = fast_score(img, thr_lo)
    if frame_ceiling:
        # high-threshold corners dominate, low-threshold ones fill in
        ceiling = frame_lo_ceiling(torch.amax(s_lo, dim=(-2, -1), keepdim=True))
    else:
        ceiling = torch.tensor(LO_CEILING, dtype=torch.float32, device=img.device)
    return nms3x3(torch.where(s_hi > 0, 1.0 + s_hi, s_lo * ceiling))


def _check_cuda_image(img, who: str):
    if img.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor")
    if img.dtype != torch.float32:
        raise TypeError(f"{who} takes float32 images")
    if not img.is_contiguous():
        raise ValueError(f"{who} takes a contiguous tensor")
    if img.dim() != 3:
        raise ValueError(f"shape {tuple(img.shape)}: want (B, H, W)")


def _fixed_ceiling(device, b: int):
    """A device tensor of at least ``b`` copies of LO_CEILING, kept per device."""
    t = _FIXED_CEILINGS.get(device)
    if t is None or t.shape[0] < b:
        t = torch.full((max(b, 16),), LO_CEILING, dtype=torch.float32, device=device)
        if not torch.cuda.is_current_stream_capturing():
            _FIXED_CEILINGS[device] = t
    return t


def launch_lo_max(img, frame_max, thr_lo: float):
    """Launch the max pass on a checked image batch: joins each
    frame's maximum low-threshold score into ``frame_max`` (B,), which the
    caller has zeroed; the one place that counts this launch."""
    global MAX_LAUNCHES
    b, h, w = img.shape
    fn = _cuda.entry(SOURCE, "lpslam_fast_lo_max", _MAX_ARGTYPES)
    _cuda.launch(fn, img.device, img.data_ptr(), frame_max.data_ptr(), b, h, w, float(thr_lo))
    MAX_LAUNCHES += 1


def launch_score(img, ceiling, out, thr_hi: float, thr_lo: float):
    """Launch the score kernel on a checked image batch with
    ``ceiling`` (>= B floats on the device) into ``out``; the one place that
    counts this launch."""
    global LAUNCHES
    b, h, w = img.shape
    fn = _cuda.entry(SOURCE, "lpslam_fast_nms_score", _SCORE_ARGTYPES)
    _cuda.launch(fn, img.device, img.data_ptr(), ceiling.data_ptr(), out.data_ptr(),
                 b, h, w, float(thr_hi), float(thr_lo))
    LAUNCHES += 1


def fast_lo_max_cuda(img, thr_lo: float = 7.0):
    """The max pass alone: (B, H, W) float32 contiguous images on a CUDA
    device -> (B,) maxima of the low-threshold FAST score."""
    _check_cuda_image(img, "fast_lo_max_cuda")
    frame_max = torch.zeros(img.shape[0], dtype=torch.float32, device=img.device)
    launch_lo_max(img, frame_max, thr_lo)
    return frame_max


def fast_nms_score_cuda(img, thr_hi: float = 20.0, thr_lo: float = 7.0,
                        frame_ceiling: bool = False):
    """The CUDA kernels: (B, H, W) float32 contiguous images on a CUDA device
    -> (B, H, W) scores. The kernel drops a pixel that is no corner at
    ``thr_lo`` before it looks at ``thr_hi``, so ``thr_hi < thr_lo`` raises."""
    _check_cuda_image(img, "fast_nms_score_cuda")
    if not thr_hi >= thr_lo:
        raise ValueError(f"fast_nms_score_cuda needs thr_hi >= thr_lo, got {thr_hi} < {thr_lo}")
    if frame_ceiling:
        ceiling = frame_lo_ceiling(fast_lo_max_cuda(img, thr_lo))
    else:
        ceiling = _fixed_ceiling(img.device, img.shape[0])
    out = torch.empty_like(img)
    launch_score(img, ceiling, out, thr_hi, thr_lo)
    return out


def fast_nms_score(img, thr_hi: float = 20.0, thr_lo: float = 7.0,
                   frame_ceiling: bool = False):
    """(B, H, W) level images -> (B, H, W) scores; see the module docstring
    for which version runs."""
    if img.device.type == "cpu":
        return fast_nms_score_reference(img, thr_hi, thr_lo, frame_ceiling)
    if img.device.type == "cuda":
        return fast_nms_score_cuda(img.contiguous(), thr_hi, thr_lo, frame_ceiling)
    raise ValueError(f"no FAST+NMS score for device {img.device}")
