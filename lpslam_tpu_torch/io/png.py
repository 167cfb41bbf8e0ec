"""PNG reading and writing with numpy and the standard library's zlib — the
port's stand-in for the ``cv2.imread`` / ``cv2.imwrite`` calls of the JAX
package (file sources, mask images, dataset readers, frame dumps).

Reading covers non-interlaced 8-bit gray, RGB and RGBA and 16-bit gray,
with all five row filters. The filters are undone along anti-diagonals: a
byte depends on its left, upper and upper-left neighbours only, so every
pixel of one anti-diagonal is independent of the others and one numpy step
handles them all.

``imread_gray`` gives what OpenCV's ``imread(path, IMREAD_GRAYSCALE)``
gives: 16-bit samples keep their high byte, and colour is weighted as
``int(0.2989807129 R + 0.5869750977 G + 0.1140441895 B)`` in double
precision, truncated (the 15-bit weights 9797, 19234 and 3737 / 32768).
``imread_unchanged`` gives ``IMREAD_UNCHANGED``: gray as stored, colour in
B, G, R(, A) order. Writing covers 8- and 16-bit gray with filter 0.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}
# IMREAD_GRAYSCALE's weights of R, G and B
_GRAY_R, _GRAY_G, _GRAY_B = 0.2989807129, 0.5869750977, 0.1140441895


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + w * bpp) bytes -> (h, w, bpp)."""
    rows = raw[: h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    ftype = rows[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    data = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if not ftype.any():
        return data.astype(np.uint8)
    if (ftype <= 2).all():
        # None / Sub / Up only: a row is one cumulative sum or one addition
        out = np.empty((h, w, bpp), np.int32)
        prev = np.zeros((w, bpp), np.int32)
        for r in range(h):
            row = data[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0)
            elif ftype[r] == 2:
                row = row + prev
            prev = out[r] = row & 255
        return out.astype(np.uint8)
    # out[r + 1, x + 1] is pixel (r, x); row 0 and column 0 are the zero
    # neighbours outside the image
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        f = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 0, f == 1, f == 2, f == 3], [0, a, b, (a + b) >> 1], paeth)
        out[r + 1, x + 1] = (data[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The image as stored: (H, W) uint8 or uint16 gray, (H, W, 3) RGB or
    (H, W, 4) RGBA uint8. Raises ValueError on a file it cannot read."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (depth == 16 and ctype != 0):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (w * bpp + 1):
        raise ValueError("truncated PNG data")
    px = _unfilter(raw, h, w, bpp)
    if depth == 16:
        return (px[..., 0].astype(np.uint16) << 8) | px[..., 1]
    return px[..., 0] if ch == 1 else px


def _try_read(path: str) -> Optional[np.ndarray]:
    if not os.path.isfile(path):
        return None
    try:
        return read_png(path)
    except (ValueError, zlib.error, struct.error):
        return None


def to_gray8(img: np.ndarray) -> np.ndarray:
    """A read_png result as IMREAD_GRAYSCALE's uint8 (H, W)."""
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    r, g, b = (img[..., i].astype(np.float64) for i in range(3))
    return (_GRAY_R * r + _GRAY_G * g + _GRAY_B * b).astype(np.uint8)


def imread_gray(path: str) -> Optional[np.ndarray]:
    """uint8 (H, W) as ``cv2.imread(path, IMREAD_GRAYSCALE)``; None when the
    file is missing or unreadable."""
    img = _try_read(path)
    return None if img is None else to_gray8(img)


def imread_unchanged(path: str) -> Optional[np.ndarray]:
    """As ``cv2.imread(path, IMREAD_UNCHANGED)``: gray as stored (uint8 or
    uint16), colour in B, G, R(, A) order; None when missing or unreadable."""
    img = _try_read(path)
    if img is None or img.ndim == 2:
        return img
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][: img.shape[2]]])


def write_png(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint8 or uint16 gray image (filter 0 on every row)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError("write_png takes a 2-D uint8 or uint16 image")
    h, w = img.shape
    depth = 8 if img.dtype == np.uint8 else 16
    rows = np.ascontiguousarray(img, ">u2" if depth == 16 else np.uint8).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
