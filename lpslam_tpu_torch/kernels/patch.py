"""32x32 patch extraction around ORB keypoints: the port of the TPU kernel
lpslam_tpu/kernels/pallas_patch.py:extract_patches_pallas.

- ``extract_patches_cuda``: the hand-written CUDA kernel (csrc/patch.cu),
  one launch per pyramid level for a whole chunk of frames.
- ``extract_patches_reference``: the plain PyTorch gather with the same
  rounding and clamping, which the kernel is held against.
- ``extract_patches``: the dispatcher — CPU tensors take the plain version,
  CUDA tensors the kernel, anything else raises. There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _cuda

PATCH = 32
PB = PATCH // 2

# kernel launches made by extract_patches_cuda since the last reset
LAUNCHES = 0


def _corners(xy, h: int, w: int):
    """Rounded (half-to-even), clamped top-left corners (x0, y0), int64."""
    x0 = torch.clamp(torch.round(xy[..., 0]).to(torch.int64) - PB, 0, w - PATCH)
    y0 = torch.clamp(torch.round(xy[..., 1]).to(torch.int64) - PB, 0, h - PATCH)
    return x0, y0


def extract_patches_reference(blurred, xy):
    """(B, H, W) images, (B, N, 2) keypoints -> (B, N, 1024) patches, as a
    plain PyTorch gather."""
    b, h, w = blurred.shape
    x0, y0 = _corners(xy, h, w)                                   # (B, N)
    off = torch.arange(PATCH, device=blurred.device)
    rows = y0[..., None, None] + off[:, None]                     # (B, N, 32, 1)
    cols = x0[..., None, None] + off[None, :]                     # (B, N, 1, 32)
    flat_idx = (rows * w + cols).reshape(b, -1)
    out = torch.gather(blurred.reshape(b, -1), 1, flat_idx)
    return out.reshape(b, xy.shape[1], PATCH * PATCH)


def extract_patches_cuda(blurred, xy):
    """The CUDA kernel: (B, H, W) float32 contiguous images and (B, N, 2)
    float32 contiguous keypoints on one CUDA device -> (B, N, 1024)."""
    global LAUNCHES
    if blurred.device.type != "cuda" or xy.device != blurred.device:
        raise ValueError("extract_patches_cuda needs both tensors on one CUDA device")
    if blurred.dtype != torch.float32 or xy.dtype != torch.float32:
        raise TypeError("extract_patches_cuda takes float32 tensors")
    if not (blurred.is_contiguous() and xy.is_contiguous()):
        raise ValueError("extract_patches_cuda takes contiguous tensors")
    if blurred.dim() != 3 or xy.dim() != 3 or xy.shape[0] != blurred.shape[0] \
            or xy.shape[2] != 2:
        raise ValueError(
            f"shapes {tuple(blurred.shape)} / {tuple(xy.shape)}: want (B,H,W) / (B,N,2)"
        )
    b, h, w = blurred.shape
    n = xy.shape[1]
    if h < PATCH or w < PATCH:
        raise ValueError(f"level {h}x{w} is smaller than a {PATCH}x{PATCH} patch")
    lib = build()
    out = torch.empty((b, n, PATCH * PATCH), dtype=torch.float32, device=blurred.device)
    with torch.cuda.device(blurred.device):
        stream = torch.cuda.current_stream().cuda_stream
    status = lib.lpslam_extract_patches(
        blurred.data_ptr(), xy.data_ptr(), out.data_ptr(), b, h, w, n, stream
    )
    _cuda.check(status, "lpslam_extract_patches")
    LAUNCHES += 1
    return out


def extract_patches(blurred, xy):
    """(B, H, W) level images, (B, N, 2) keypoints -> (B, N, 1024) patches;
    see the module docstring for which version runs."""
    if blurred.device.type == "cpu":
        return extract_patches_reference(blurred, xy)
    if blurred.device.type == "cuda":
        return extract_patches_cuda(blurred.contiguous(), xy.contiguous())
    raise ValueError(f"no patch extraction for device {blurred.device}")


def build():
    """Compile (first call only) and load the kernel's library."""
    lib = _cuda.load_library("patch.cu")
    fn = lib.lpslam_extract_patches
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
