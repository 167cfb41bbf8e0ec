"""Baseline 8-bit grey JPEG: the encoder and decoder the record / replay
path, the image callback and ``add_image_from_buffer(compressed=)`` use,
where the JAX package calls OpenCV.

``encode_gray`` and ``decode_gray`` run the native codec
(``csrc/jpeg.cpp``, C++17, built with g++ at first use into ``_build/``
and called through ctypes, which releases the GIL for the call). The numpy
codec below stays as its plain reference, ``encode_gray_reference`` and
``decode_gray_reference``; the two give the same bytes, pixels, None and
ValueError (``tests/test_torch_jpeg.py``). Where the codec cannot be built,
the numpy codec runs instead: a warning says so once, ``jpeg_backend()``
reads "numpy" and ``jpeg_build_error()`` keeps the compiler's output.
``CODEC_CALLS`` counts the calls by backend.

- ``encode_gray(img_u8, quality)`` writes the bytes of
  ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])`` (OpenCV
  with libjpeg-turbo) for a 2-D uint8 image: a JFIF 1.01 APP0, one DQT (the
  Annex K luminance table under IJG quality scaling), SOF0 with one
  component at 1x1, the two standard luminance Huffman tables, one scan.
  The samples are edge-replicated to a multiple of 8, transformed by the
  integer forward DCT of libjpeg's ``jfdctint.c`` and quantized by rounding
  division; the reference's entropy stage is vectorized (symbols from
  ``np.nonzero``, codes from lookup arrays, bits packed with ``np.packbits``).
- ``decode_gray(data)`` returns what ``cv2.imdecode(buf, IMREAD_GRAYSCALE)``
  returns: a uint8 (H, W) image, or None where OpenCV gives none (no JPEG
  signature, a structural error, or data that ends in the middle of a scan).
  It takes any Huffman and 8- or 16-bit quantization tables, grey and YCbCr
  frames at any sampling factors with full-resolution luma (for YCbCr only
  the luma is decoded, as libjpeg does for grey output), one or several
  sequential scans, restart intervals, libjpeg's recovery from a scan cut
  short by a marker (zero bits, then mid-grey blocks), the ``jidctint.c``
  integer inverse DCT with its range limit, and the EXIF orientation, which
  OpenCV applies under IMREAD_GRAYSCALE. It raises ValueError, naming what
  it met, on progressive, arithmetic-coded, lossless, hierarchical and
  12-bit files, on RGB, CMYK and 2- or 4-component frames, and on frames
  whose luma is subsampled below a chroma plane.

The reference's entropy decoder is a table-driven Python loop: a 16-bit
lookup gives a code's symbol and length, and, for AC codes whose extra bits
fit the same 16 bits, the run and the coefficient at once.
"""
from __future__ import annotations

import ctypes
import functools
import struct
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

# zig-zag index -> natural (row-major) index
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# ITU T.81 Annex K.1, luminance, natural order
_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)

# Annex K.3 Huffman tables as DHT payloads: class/id, 16 counts, values
_STD_DHT = {
    (0, 0): "0000010501010101010100000000000000000102030405060708090a0b",
    (1, 0): "100002010303020403050504040000017d01020300041105122131410613516107227114328191a1"
            "082342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a4344454647"
            "48494a535455565758595a636465666768696a737475767778797a838485868788898a92939495"
            "969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
            "d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (0, 1): "0100030101010101010101010000000000000102030405060708090a0b",
    (1, 1): "11000201020404030407050404000102770001020311040521310612415107617113223281081442"
            "91a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a43444546"
            "4748494a535455565758595a636465666768696a737475767778797a82838485868788898a9293"
            "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6"
            "d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
}


def _std_table(tc: int, th: int):
    raw = bytes.fromhex(_STD_DHT[(tc, th)])
    counts = list(raw[1:17])
    return counts, list(raw[17:17 + sum(counts)])


# libjpeg's islow fixed-point constants (CONST_BITS 13)
_CB, _P1 = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# -- encoder ----------------------------------------------------------------


def _quant_table(quality: int) -> np.ndarray:
    """IJG quality scaling of the Annex K luminance table (natural order,
    baseline: capped at 255), as ``jpeg_set_quality(..., force_baseline)``."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((_LUMA_QUANT * scale + 50) // 100, 1, 255)


def _fdct_pass(d, pass2: bool):
    """One pass of jfdctint.c's forward DCT along the last axis of d
    (..., 8) int64."""
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = np.empty_like(d)
    n = _CB + _P1 if pass2 else _CB - _P1
    if pass2:
        out[..., 0] = _descale(t10 + t11, _P1)
        out[..., 4] = _descale(t10 - t11, _P1)
    else:
        out[..., 0] = (t10 + t11) << _P1
        out[..., 4] = (t10 - t11) << _P1
    z1 = (t12 + t13) * _F0541
    out[..., 2] = _descale(z1 + t13 * _F0765, n)
    out[..., 6] = _descale(z1 - t12 * _F1847, n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1175
    t4, t5, t6, t7 = t4 * _F0298, t5 * _F2053, t6 * _F3072, t7 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    out[..., 7] = _descale(t4 + z1 + z3, n)
    out[..., 5] = _descale(t5 + z2 + z4, n)
    out[..., 3] = _descale(t6 + z2 + z3, n)
    out[..., 1] = _descale(t7 + z1 + z4, n)
    return out


def _canonical_codes(counts, values):
    """(code, length) per symbol value of a DHT (Annex C)."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[values[k]], len_of[values[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_DC_CODES = _canonical_codes(*_std_table(0, 0))
_AC_CODES = _canonical_codes(*_std_table(1, 0))


def _bit_length(a):
    """Bit length of |a| (0 for 0), elementwise."""
    return np.frexp(np.abs(a).astype(np.float64))[1].astype(np.int64)


def _extra_bits(v, size):
    """The magnitude bits JPEG appends after a symbol of category `size`."""
    return np.where(v < 0, v + (1 << size) - 1, v)


def _entropy_code(zz: np.ndarray) -> bytes:
    """Huffman-code the zig-zag ordered (nb, 64) coefficients of one
    component in block order, pad with 1-bits, stuff 0x00 after 0xFF."""
    nb = zz.shape[0]
    dc = zz[:, 0]
    diff = np.diff(dc, prepend=0)
    dsize = _bit_length(diff)
    # AC: one event per nonzero, preceded by its zero-run-length (ZRL)
    # symbols; an EOB unless the block's last coefficient is nonzero
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prevk = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prevk - 1
    nzrl, r = run // 16, run % 16
    asize = _bit_length(v)
    # order key within a block: DC 0, ZRLs 2p-1, the nonzero at k 2k, EOB 127
    zb = np.repeat(b, nzrl)
    zi = np.arange(len(zb)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    zp = np.repeat(prevk, nzrl) + 16 * (zi + 1)
    last = np.full(nb, 0)
    np.maximum.at(last, b, k)
    eob_b = np.nonzero(last < 63)[0]
    dcode, dlen = _DC_CODES
    acode, alen = _AC_CODES
    sym = (r << 4) | asize
    key = np.concatenate([np.arange(nb) * 128, b * 128 + 2 * k, zb * 128 + 2 * zp - 1,
                          eob_b * 128 + 127])
    code = np.concatenate([dcode[dsize], acode[sym], np.full(len(zb), acode[0xF0]),
                           np.full(len(eob_b), acode[0])])
    clen = np.concatenate([dlen[dsize], alen[sym], np.full(len(zb), alen[0xF0]),
                           np.full(len(eob_b), alen[0])])
    extra = np.concatenate([_extra_bits(diff, dsize), _extra_bits(v, asize),
                            np.zeros(len(zb) + len(eob_b), np.int64)])
    xlen = np.concatenate([dsize, asize, np.zeros(len(zb) + len(eob_b), np.int64)])
    order = np.argsort(key, kind="stable")
    val = ((code << xlen) | extra)[order]
    length = (clen + xlen)[order]
    # each code (<= 27 bits) lands in one or two 32-bit words; the parts
    # cover disjoint bits, so a float64 bincount (exact below 2**53) ORs them
    total = int(length.sum())
    pad = (-total) % 8
    val = np.append(val, (1 << pad) - 1)                # 1-bits to the byte
    length = np.append(length, pad)
    start = np.cumsum(length) - length
    word, off = start >> 5, start & 31
    over = off + length - 32                            # bits into the next word
    head = np.where(over > 0, val >> np.maximum(over, 0), val << np.maximum(-over, 0))
    tail = np.where(over > 0, (val & ((1 << np.maximum(over, 0)) - 1)) << (32 - over), 0)
    n_words = (total + pad + 31) >> 5
    words = (np.bincount(word, head, n_words + 2)
             + np.bincount(word + 1, tail, n_words + 2))[:n_words].astype(np.uint32)
    out = words.astype(">u4").view(np.uint8)[:(total + pad) >> 3]
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _checked_image(img) -> np.ndarray:
    """The image as an array, or the ValueError both encoders raise."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8 or img.size == 0:
        raise ValueError(f"encode_gray takes a non-empty 2-D uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    if h > 65535 or w > 65535:
        raise ValueError(f"image {w}x{h} exceeds the JPEG limit of 65535")
    return img


def encode_gray_reference(img, quality: int = 90) -> bytes:
    """The numpy encoder: a 2-D uint8 image as baseline JPEG bytes, equal to
    OpenCV's ``imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``."""
    img = _checked_image(img)
    h, w = img.shape
    q = _quant_table(quality)
    pad = np.pad(img, ((0, (-h) % 8), (0, (-w) % 8)), mode="edge").astype(np.int64) - 128
    bh, bw = pad.shape[0] // 8, pad.shape[1] // 8
    blocks = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    coef = _fdct_pass(_fdct_pass(blocks, False).swapaxes(1, 2), True).swapaxes(1, 2)
    qq = (q << 3).reshape(8, 8)
    mag = (np.abs(coef) + (qq >> 1)) // qq
    quant = np.where(coef < 0, -mag, mag).reshape(-1, 64)[:, _ZIGZAG]
    dht = b"".join(_segment(0xC4, bytes.fromhex(_STD_DHT[t])) for t in ((0, 0), (1, 0)))
    return b"".join([
        b"\xff\xd8",
        _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xDB, b"\x00" + q[_ZIGZAG].astype(np.uint8).tobytes()),
        _segment(0xC0, struct.pack(">BHHBBBB", 8, h, w, 1, 1, 0x11, 0)),
        dht,
        _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00"),
        _entropy_code(quant),
        b"\xff\xd9",
    ])


# -- decoder ----------------------------------------------------------------


class _Corrupt(Exception):
    """A structural error: libjpeg stops, OpenCV returns no image."""


def _idct_pass(d, last: bool = False):
    """One pass of jidctint.c's inverse DCT along the last axis of d
    (..., 8) int64; `last` descales to samples."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _F0541
    t2, t3 = z1 - z3 * _F1847, z1 + z2 * _F0765
    t0, t1 = (d[..., 0] + d[..., 4]) << _CB, (d[..., 0] - d[..., 4]) << _CB
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    n = _CB + _P1 + 3 if last else _CB - _P1
    out = np.empty_like(d)
    for i, v in enumerate((t10 + t3, t11 + t2, t12 + t1, t13 + t0,
                           t13 - t0, t12 - t1, t11 - t2, t10 - t3)):
        out[..., i] = _descale(v, n)
    return out


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_blocks(coef, q) -> np.ndarray:
    """(n, 64) natural-order coefficients and an (64,) quantization table
    -> (n, 8, 8) uint8 samples, as libjpeg-turbo's SIMD islow IDCT: jidctint.c's
    arithmetic on 16-bit lanes (coefficients and their dequantized products
    wrap to 16 bits, the first pass saturates to them, and the samples
    saturate to [0, 255]). Valid streams never reach those limits."""
    d = _wrap16(_wrap16(np.asarray(coef, np.int64).reshape(-1, 8, 8))
                * q.reshape(8, 8).astype(np.int64))
    ws = np.clip(_idct_pass(d.swapaxes(1, 2)), -32768, 32767).swapaxes(1, 2)
    return np.clip(_idct_pass(ws, last=True) + 128, 0, 255).astype(np.uint8)


class _Huff:
    """A DHT's decoding tables: `lut[w16]` = length << 8 | symbol of the
    code that starts the 16-bit window w16 (length 17, symbol 0 where no
    code does: libjpeg's bad-code recovery); for AC tables `fast[w16]` =
    (bits, run, value) where the code and its extra bits fit 16 bits."""

    def __init__(self, counts, values, is_dc: bool):
        if sum(counts) > 256:
            raise _Corrupt("bad Huffman table")
        if is_dc and any(v > 15 for v in values):
            raise _Corrupt("bad DC Huffman table")
        lut = np.full(1 << 16, (17 << 8), np.int64)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= (1 << length):
                    raise _Corrupt("bad Huffman table")
                lo = code << (16 - length)
                lut[lo:lo + (1 << (16 - length))] = (length << 8) | values[k]
                code += 1
                k += 1
            code <<= 1
        self.lut = lut.tolist()
        self.fast = None
        if not is_dc:
            w = np.arange(1 << 16, dtype=np.int64)
            ln, sym = lut >> 8, lut & 0xFF
            run, size = sym >> 4, sym & 15
            total = ln + size
            ok = (ln <= 16) & (size > 0) & (total <= 16)
            raw = (w >> np.clip(16 - total, 0, 16)) & ((1 << size) - 1)
            val = np.where(raw < (1 << np.maximum(size - 1, 0)), raw - (1 << size) + 1, raw)
            self.fast = [(int(t), int(r), int(v)) if o else None
                         for t, r, v, o in zip(total.tolist(), run.tolist(),
                                               val.tolist(), ok.tolist())]




@functools.lru_cache(maxsize=16)
def _huff(counts: tuple, values: tuple, is_dc: bool) -> _Huff:
    """A _Huff per distinct table (immutable once built); the standard
    tables recur in every file, and building one takes tens of ms."""
    return _Huff(counts, values, is_dc)


def _windows(seg: bytes, pad: int) -> list:
    """w[i] = the 64 bits from byte i of `seg` followed by `pad` zero bytes."""
    b = np.frombuffer(seg + bytes(pad + 8), np.uint8).astype(np.uint64)
    w = np.zeros(len(seg) + pad + 1, np.uint64)
    for j in range(8):
        w |= b[j:j + len(w)] << np.uint64(56 - 8 * j)
    return w.tolist()


def _unstuff(data: bytes, start: int):
    """The entropy-coded bytes from `start` to the next marker: (the bytes
    with each FF00 made FF, the raw offset after each of them, the offset of
    the marker or None where the data ends first)."""
    n = len(data)
    out = bytearray()
    raw_end = []
    i = start
    while True:
        j = data.find(b"\xff", i)
        if j < 0:
            j = n
        out += data[i:j]
        raw_end.extend(range(i + 1, j + 1))
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1
        if k >= n:                              # no marker; a last FF is unreadable
            return bytes(out), raw_end, None
        if data[k] != 0:
            return bytes(out), raw_end, k - 1
        out.append(0xFF)
        raw_end.append(k + 1)
        i = k + 1


class _Suspended(Exception):
    """The scan needs bytes past the end of the data: libjpeg suspends, and
    OpenCV returns no image."""


class _BitFill:
    """Where a scan runs to the end of the data with no marker, libjpeg-turbo
    suspends when a bit-buffer refill cannot load 57 bits. This follows its
    refills: decode_mcu_fast (taken while >= 512 raw bytes per block of the
    MCU are unread, and never with restart intervals) loads 6 bytes before a
    code or extra bits when <= 16 bits are left; decode_mcu_slow loads to 57
    bits when a code (at least 8 bits of look-ahead) or the extra bits do not
    fit what is left."""

    def __init__(self, raw_end, raw_total: int, fast_ok: bool):
        self.raw_end = raw_end          # raw offset after each data byte
        self.raw_total = raw_total
        self.fast_ok = fast_ok
        self.loaded = 0                 # data bytes in the bit buffer
        self.fast = False

    def begin_mcu(self, blocks: int):
        read = self.raw_end[self.loaded - 1] if self.loaded else 0
        self.fast = self.fast_ok and self.raw_total - read >= 512 * blocks

    def _take(self, p: int, nbits: int):
        left = 8 * self.loaded - p
        if self.fast:
            if left <= 16:
                self.loaded += 6
        elif left < nbits:
            need = (p + 57 + 7) // 8
            if need > len(self.raw_end):
                raise _Suspended
            self.loaded = need

    def code(self, p: int, length: int):
        self._take(p, max(8, length))

    def bits(self, p: int, s: int):
        self._take(p, s)


def _decode_interval(seg: bytes, fill, blocks, mcus: int, first: int, store, coefs,
                     pad: int) -> bool:
    """Decode `mcus` MCUs, numbered from `first`, of one restart interval
    from its unstuffed bytes. blocks: per block of an MCU (DC _Huff, AC
    _Huff, component slot, block number in the component's part of the
    MCU); store(slot, mcu, nth) -> offset into `coefs` (None: decode and
    discard). True when the data ran out (libjpeg's insufficient_data: the
    MCU that ran out is decoded from zero bits, the later ones left zero)."""
    W = _windows(seg, pad)
    end = 8 * len(seg)
    pred = [0] * 4
    p = 0
    for m in range(first, first + mcus):
        if fill is not None:
            fill.begin_mcu(len(blocks))
        for dct, act, slot, nth in blocks:
            base = store(slot, m, nth)
            # DC: code, then `s` extra bits, a difference to the prediction
            w = (W[p >> 3] << (p & 7)) >> 32 & 0xFFFFFFFF
            e = dct.lut[w >> 16]
            ln, s = e >> 8, e & 0xFF
            if fill is not None:
                fill.code(p, ln)
                if s:
                    fill.bits(p + ln, s)
            if s:
                r = (w >> (32 - ln - s)) & ((1 << s) - 1)
                pred[slot] += r if r >= (1 << (s - 1)) else r + 1 - (1 << s)
            p += ln + s
            if base is not None:
                coefs[base] = pred[slot]
            lut, fast = act.lut, act.fast
            k = 1
            while k < 64:
                w = (W[p >> 3] << (p & 7)) >> 32 & 0xFFFFFFFF
                if fill is None:
                    f = fast[w >> 16]
                    if f is not None:           # code and extra bits in 16
                        p += f[0]
                        k += f[1]
                        if base is not None:
                            coefs[base + _ZIG[k if k < 64 else 63]] = f[2]
                        k += 1
                        continue
                e = lut[w >> 16]
                ln, run, s = e >> 8, (e >> 4) & 15, e & 15
                if fill is not None:
                    fill.code(p, ln)
                    if s:
                        fill.bits(p + ln, s)
                if s:
                    k += run
                    r = (w >> (32 - ln - s)) & ((1 << s) - 1)
                    if base is not None:
                        coefs[base + _ZIG[k if k < 64 else 63]] = (
                            r if r >= (1 << (s - 1)) else r + 1 - (1 << s))
                elif run == 15:                 # ZRL
                    k += 15
                else:                           # EOB
                    p += ln
                    break
                p += ln + s
                k += 1
        if p > end:
            return True
    return False


_ZIG = _ZIGZAG.tolist()

_REFUSED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical",
    0xC7: "hierarchical", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded",
    0xCB: "arithmetic-coded", 0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded",
    0xCF: "arithmetic-coded",
}


def _exif_orientation(payload: bytes) -> int:
    """Tag 0x0112 of IFD0 in an APP1 Exif payload; 1 when absent or bad."""
    if not payload.startswith(b"Exif\x00\x00"):
        return 1
    t = payload[6:]
    if t[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if t[:2] == b"II" else ">"
    try:
        off = struct.unpack_from(e + "I", t, 4)[0]
        for i in range(struct.unpack_from(e + "H", t, off)[0]):
            tag, typ = struct.unpack_from(e + "HH", t, off + 2 + 12 * i)
            if tag == 0x0112 and typ == 3:
                v = struct.unpack_from(e + "H", t, off + 10 + 12 * i)[0]
                return v if 1 <= v <= 8 else 1
    except struct.error:
        return 1
    return 1


def _orient(img: np.ndarray, o: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation for EXIF orientation o (1-8)."""
    if o >= 5:
        img = img.T
    if o in (2, 6):
        img = img[:, ::-1]
    elif o in (3, 7):
        img = img[::-1, ::-1]
    elif o in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_gray_reference(data) -> Optional[np.ndarray]:
    """The numpy decoder: JPEG bytes -> (H, W) uint8, as
    ``cv2.imdecode(buf, IMREAD_GRAYSCALE)``; None where that returns None."""
    data = bytes(data)
    if data[:3] != b"\xff\xd8\xff":
        return None
    try:
        return _Decoder(data).run()
    except (_Corrupt, _Suspended, struct.error, IndexError):
        # IndexError, struct.error: a marker segment shorter than its fields
        return None


class _Decoder:
    """One file's markers, tables and luma coefficients."""

    def __init__(self, data: bytes):
        self.data = data
        self.qt: dict = {}
        self.ht: dict = {}
        self.frame = None
        self.restart = 0
        self.jfif = False
        self.adobe_transform = None
        self.orientation = 1
        self.coefs = None
        self.single_scan = None

    def _segment(self, i: int):
        """Next marker at or after i: (marker, payload, offset after it)."""
        data, n = self.data, len(self.data)
        while i < n and data[i] != 0xFF:        # stray bytes
            i += 1
        while i < n and data[i] == 0xFF:        # fill bytes
            i += 1
        if i >= n:
            raise _Suspended
        m = data[i]
        i += 1
        if m in (0xD8, 0xD9, 0x01) or 0xD0 <= m <= 0xD7:
            return m, b"", i
        if i + 2 > n:
            raise _Suspended
        length = struct.unpack_from(">H", data, i)[0]
        if length < 2:
            raise _Corrupt("bad marker length")
        if i + length > n:
            raise _Suspended
        return m, data[i + 2:i + length], i + length

    def run(self) -> np.ndarray:
        i = 2
        while True:
            m, seg, i = self._segment(i)
            if m == 0xD9:
                if self.single_scan is None:
                    raise _Corrupt("no image")
                break
            if m == 0xD8:
                raise _Corrupt("second SOI")
            if m in _REFUSED_SOF:
                raise ValueError(f"decode_gray: {_REFUSED_SOF[m]} JPEG (SOF{m - 0xC0}) is "
                                 "not supported; baseline and extended sequential only")
            if m in (0xC0, 0xC1):
                self._sof(seg)
            elif m == 0xC4:
                self._dht(seg)
            elif m == 0xDB:
                self._dqt(seg)
            elif m == 0xDD:
                self.restart = struct.unpack_from(">H", seg, 0)[0]
            elif m == 0xE0 and seg.startswith(b"JFIF\x00"):
                self.jfif = True
            elif m == 0xE1 and self.orientation == 1:
                self.orientation = _exif_orientation(seg)
            elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
                self.adobe_transform = seg[11]
            elif m == 0xDA:
                i = self._scan(seg, i)
                if self.single_scan:
                    break                       # libjpeg outputs as it reads one scan
            elif not (m in (0xCC, 0xDC, 0xFE, 0x01) or 0xD0 <= m <= 0xD7 or 0xE0 <= m <= 0xEF):
                raise _Corrupt("unknown marker")            # libjpeg: JERR_UNKNOWN_MARKER
        y = self.frame["comps"][0]
        # a luma plane no scan named latched no table: libjpeg's multipliers
        # stay zero, so its blocks come out mid-grey
        q = y["q"] if y["q"] is not None else np.zeros(64, np.int64)
        img = _idct_blocks(np.asarray(self.coefs, np.int64), q)
        bh, bw = y["bh"], y["bw"]
        img = img.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        return _orient(img[:self.frame["h"], :self.frame["w"]], self.orientation)

    def _sof(self, seg: bytes):
        if self.frame is not None:
            raise _Corrupt("second SOF")
        prec, h, w, nc = struct.unpack_from(">BHHB", seg, 0)
        if prec != 8:
            raise ValueError(f"decode_gray: {prec}-bit JPEG is not supported (8-bit only)")
        if h == 0 or w == 0 or nc == 0 or len(seg) < 6 + 3 * nc:
            raise _Corrupt("empty image")
        comps = []
        for c in range(nc):
            cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise _Corrupt("bad sampling factor")
            comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq, "q": None})
        if nc == 3:
            # libjpeg's default_decompress_parms: JFIF means YCbCr, else
            # the Adobe transform, else the component ids
            ids = tuple(c["id"] for c in comps)
            rgb = not self.jfif and (self.adobe_transform == 0 or (
                self.adobe_transform is None and ids == (82, 71, 66)))
            if rgb:
                raise ValueError("decode_gray: RGB JPEG is not supported (grey and YCbCr only)")
        elif nc != 1:
            raise ValueError(f"decode_gray: {nc}-component JPEG is not supported "
                             "(grey and YCbCr only)")
        hmax = max(c["h"] for c in comps)
        vmax = max(c["v"] for c in comps)
        y = comps[0]
        if (y["h"], y["v"]) != (hmax, vmax):
            raise ValueError("decode_gray: luma subsampled below a chroma plane is not "
                             "supported")
        self.mx, self.my = _ceil_div(w, 8 * hmax), _ceil_div(h, 8 * vmax)
        for c in comps:                         # blocks in a scan of c alone
            c["bx"] = _ceil_div(_ceil_div(w * c["h"], hmax), 8)
            c["by"] = _ceil_div(_ceil_div(h * c["v"], vmax), 8)
        y["bw"], y["bh"] = self.mx * y["h"], self.my * y["v"]
        self.coefs = [0] * (y["bw"] * y["bh"] * 64)
        self.frame = {"h": h, "w": w, "comps": comps}

    def _dht(self, seg: bytes):
        j = 0
        while j < len(seg):
            tc, th = seg[j] >> 4, seg[j] & 15
            counts = list(seg[j + 1:j + 17])
            values = list(seg[j + 17:j + 17 + sum(counts)])
            if tc > 1 or th > 3 or len(counts) < 16 or len(values) < sum(counts):
                raise _Corrupt("bad DHT")
            self.ht[(tc, th)] = (counts, values)
            j += 17 + len(values)

    def _dqt(self, seg: bytes):
        j = 0
        while j < len(seg):
            pq, tq = seg[j] >> 4, seg[j] & 15
            if tq > 3 or pq > 1:
                raise _Corrupt("bad DQT")
            vals = struct.unpack_from(">64H" if pq else "64B", seg, j + 1)
            j += 129 if pq else 65
            tab = np.zeros(64, np.int64)
            tab[_ZIGZAG] = vals
            self.qt[tq] = tab

    def _tables(self, t: int):
        """DC and AC _Huff for an SOS table byte; libjpeg-turbo takes the
        standard tables for ids 0 / 1 that no DHT defined (motion JPEG)."""
        out = []
        for tc, th in ((0, t >> 4), (1, t & 15)):
            tab = self.ht.get((tc, th))
            if tab is None:
                if th > 1:
                    raise _Corrupt("no Huffman table")
                tab = _std_table(tc, th)
            out.append(_huff(tuple(tab[0]), tuple(tab[1]), tc == 0))
        return out

    def _scan(self, seg: bytes, i: int) -> int:
        """Decode one scan whose entropy-coded data starts at byte i; returns
        the offset of the marker that ends it."""
        if self.frame is None:
            raise _Corrupt("SOS before SOF")
        comps = self.frame["comps"]
        ns = seg[0]
        if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
            raise _Corrupt("bad SOS")
        if seg[1 + 2 * ns:4 + 2 * ns] != b"\x00\x3f\x00":
            raise _Corrupt("bad sequential scan parameters")
        scomps = []
        for c in range(ns):
            match = [k for k in comps if k["id"] == seg[1 + 2 * c]]
            if not match:
                raise _Corrupt("bad component in SOS")
            k = match[0]
            if k["q"] is None:                  # latched at the component's first scan
                if k["tq"] not in self.qt:
                    raise _Corrupt("no quantization table")
                k["q"] = self.qt[k["tq"]]
            scomps.append((k, *self._tables(seg[2 + 2 * c])))
        if self.single_scan is None:
            self.single_scan = ns == len(comps)
        y = comps[0]
        yslot = next((s for s, sc in enumerate(scomps) if sc[0] is y), None)
        if ns == 1:
            bx = scomps[0][0]["bx"]
            total = bx * scomps[0][0]["by"]
            blocks = [(scomps[0][1], scomps[0][2], 0, 0)]

            def store(slot, m, nth):
                return None if yslot is None else ((m // bx) * y["bw"] + m % bx) * 64
        else:
            total = self.mx * self.my
            blocks = [(dct, act, slot, nth) for slot, (k, dct, act) in enumerate(scomps)
                      for nth in range(k["h"] * k["v"])]
            hy, vy, mx, bw = y["h"], y["v"], self.mx, y["bw"]

            def store(slot, m, nth):
                if slot != yslot:
                    return None
                return (((m // mx) * vy + nth // hy) * bw + (m % mx) * hy + nth % hy) * 64
        interval = self.restart or total
        done, pos = 0, i
        data = self.data
        while done < total:
            mcus = min(interval, total - done)
            unstuffed, raw_end, marker = _unstuff(data, pos)
            fill = None
            if marker is None:
                fill = _BitFill([r - pos for r in raw_end], len(data) - pos, not self.restart)
            try:
                short = _decode_interval(unstuffed, fill, blocks, mcus, done, store,
                                         self.coefs, 8)
            except IndexError:                  # ran far past a marker: more zero bits
                short = _decode_interval(unstuffed, fill, blocks, mcus, done, store,
                                         self.coefs, 2 * 64 * 4 * len(blocks))
            done += mcus
            if marker is None:
                return len(data)
            pos = marker
            if done < total:
                if 0xD0 <= data[marker + 1] <= 0xD7:
                    pos = marker + 2            # the restart marker
                elif short:
                    # libjpeg keeps its out-of-data flag against a marker
                    # that is no restart: the rest of the scan stays zero
                    return pos
        return pos


# -- the native codec -----------------------------------------------------------

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "jpeg.cpp"

CODEC_CALLS = {"encode_native": 0, "encode_numpy": 0, "decode_native": 0, "decode_numpy": 0}
_calls_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib_state = {"tried": False, "lib": None, "error": None}


def _count(key: str) -> None:
    with _calls_lock:
        CODEC_CALLS[key] += 1


def _codec():
    """The native codec's library, built and loaded once per process; None
    when it cannot be built (warned once, not retried)."""
    with _lib_lock:
        if _lib_state["tried"]:
            return _lib_state["lib"]
        _lib_state["tried"] = True
        from ..native import build_library

        path, error, _ = build_library(SOURCE, "lpslam_jpeg")
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                i64, p = ctypes.c_int64, ctypes.c_void_p
                lib.lpslam_jpeg_encode_gray.argtypes = [p, i64, i64, ctypes.c_int, p, i64]
                lib.lpslam_jpeg_encode_gray.restype = i64
                lib.lpslam_jpeg_decode_gray.argtypes = [
                    ctypes.c_char_p, i64, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_int),
                    ctypes.c_char_p, i64]
                lib.lpslam_jpeg_decode_gray.restype = ctypes.c_int
                lib.lpslam_jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
                lib.lpslam_jpeg_free.restype = None
                _lib_state["lib"] = lib
            except (OSError, AttributeError) as exc:
                error = f"loading {path}: {exc!r}"
        if _lib_state["lib"] is None:
            _lib_state["error"] = error
            warnings.warn("lpslam_tpu_torch.io.jpeg: the native JPEG codec is unavailable, "
                          f"the numpy codec runs instead: {error}", RuntimeWarning, stacklevel=3)
        return _lib_state["lib"]


def jpeg_backend() -> str:
    """"native" when the C++ codec is built and loaded (building it on the
    first call), else "numpy"."""
    return "native" if _codec() is not None else "numpy"


def jpeg_build_error() -> Optional[str]:
    """Why the native codec is unavailable (the compiler's output), or None."""
    return _lib_state["error"]


def encode_gray(img, quality: int = 90) -> bytes:
    """A 2-D uint8 image as baseline JPEG bytes, equal to OpenCV's
    ``imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``: the native
    codec, or ``encode_gray_reference`` where it cannot be built."""
    img = _checked_image(img)
    lib = _codec()
    if lib is None:
        _count("encode_numpy")
        return encode_gray_reference(img, quality)
    img = np.ascontiguousarray(img)
    h, w = img.shape
    # a block codes to at most 64 symbols of <= 27 bits, doubled by stuffing
    cap = 1024 + 512 * ((h + 7) // 8) * ((w + 7) // 8)
    out = np.empty(cap, np.uint8)
    n = lib.lpslam_jpeg_encode_gray(img.ctypes.data, h, w, min(max(int(quality), 1), 100),
                                    out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"encode_gray: {cap} bytes did not hold a {w}x{h} image")
    _count("encode_native")
    return out[:n].tobytes()


def decode_gray(data) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W) uint8, as ``cv2.imdecode(buf, IMREAD_GRAYSCALE)``;
    None where that returns None: the native codec, or
    ``decode_gray_reference`` where it cannot be built."""
    data = bytes(data)
    lib = _codec()
    if lib is None:
        _count("decode_numpy")
        return decode_gray_reference(data)
    _count("decode_native")
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w, o = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)
    rc = lib.lpslam_jpeg_decode_gray(data, len(data), ctypes.byref(out), ctypes.byref(h),
                                     ctypes.byref(w), ctypes.byref(o), msg, len(msg))
    if rc == 1:
        return None
    if rc == 2:
        raise ValueError(msg.value.decode())
    if rc != 0:
        raise MemoryError(f"decode_gray: no memory for the image ({len(data)} bytes of JPEG)")
    try:
        img = np.ctypeslib.as_array(out, shape=(h.value, w.value)).copy()
    finally:
        lib.lpslam_jpeg_free(out)
    return _orient(img, o.value)
