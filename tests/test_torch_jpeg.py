"""Port parity, the JPEG codec (lpslam_tpu_torch/io/jpeg.py) against OpenCV,
which the JAX package calls (lpslam_tpu/pipeline/record.py). Every test of
the codec runs on both backends: the native codec (csrc/jpeg.cpp, which
encode_gray / decode_gray call) and the numpy reference
(encode_gray_reference / decode_gray_reference).

- encode: bytes equal to ``cv2.imencode(".jpg", img,
  [IMWRITE_JPEG_QUALITY, q])`` on grey images at q 1 / 50 / 70 / 90 / 95 /
  100 and sizes 1x1, 45x67, 48x64, 120x160; float32 input is clipped and
  truncated as the JAX ``_encode_jpeg`` does.
- decode: equal to ``cv2.imdecode(buf, IMREAD_GRAYSCALE)`` on its own
  output, on OpenCV's grey output, on OpenCV's colour output at sampling
  4:4:4 / 4:2:2 / 4:2:0, with restart intervals, with optimized Huffman
  tables, with each EXIF orientation, on separate scans per component (a
  16-bit table, restart intervals, a frame whose luma no scan names), and
  on cut and padded streams (None wherever OpenCV gives None); ValueError
  on a progressive file.
- native against numpy: hypothesis properties over sizes 1-80 x 1-80 and
  qualities 1-100 (the same bytes, the same pixels), every truncation of
  four small files and random byte flips in them (the same pixels, the
  same None, or a ValueError with the same text in both).
"""
import struct

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")

from lpslam_tpu.pipeline.record import _encode_jpeg as jax_encode_jpeg  # noqa: E402
from lpslam_tpu_torch.io import jpeg  # noqa: E402

torch.set_num_threads(1)

SIZES = [(1, 1), (45, 67), (48, 64), (120, 160)]
QUALITIES = [1, 50, 70, 90, 95, 100]
BACKENDS = {"native": (jpeg.encode_gray, jpeg.decode_gray),
            "numpy": (jpeg.encode_gray_reference, jpeg.decode_gray_reference)}


@pytest.fixture(params=list(BACKENDS))
def codec(request):
    """(encode, decode) of one backend; the native one must have built."""
    if request.param == "native":
        assert jpeg.jpeg_backend() == "native", jpeg.jpeg_build_error()
    return BACKENDS[request.param]


def _image(h, w, seed=0, noise=20.0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = 128 + 60 * np.sin(xx / 7.0) + 40 * np.cos(yy / 5.0) + rng.normal(0, noise, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv_encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def _cv_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


def _assert_decodes_as_cv2(decode, data):
    ref = _cv_decode(data)
    ours = decode(data)
    if ref is None:
        assert ours is None
    else:
        assert ours is not None and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", SIZES)
def test_encode_matches_cv2(codec, size):
    encode, decode = codec
    for seed, noise in ((0, 20.0), (1, 80.0)):
        img = _image(*size, seed=seed, noise=noise)
        for q in QUALITIES:
            data = encode(img, q)
            assert data == _cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, q), (size, q)
            _assert_decodes_as_cv2(decode, data)    # ours, so OpenCV's grey output too


def test_float_input_clipped_and_truncated_as_jax(codec, monkeypatch):
    from lpslam_tpu_torch.pipeline import record

    monkeypatch.setattr(record, "encode_gray", codec[0])
    rng = np.random.default_rng(3)
    img = rng.uniform(-40.0, 300.0, (45, 67)).astype(np.float32)
    assert record._encode_jpeg(img, 90) == jax_encode_jpeg(img, 90)
    assert record._encode_jpeg(img.astype(np.uint8) * 0 + 7, 70) == jax_encode_jpeg(
        np.full((45, 67), 7, np.uint8), 70)


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_decode_colour_luma_as_cv2(codec, sampling):
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    rng = np.random.default_rng(4)
    for h, w in SIZES[1:]:
        grey = _image(h, w, seed=5)
        bgr = np.stack([grey, np.roll(grey, 3, 1), 255 - grey], -1)
        bgr = np.clip(bgr + rng.normal(0, 10, bgr.shape), 0, 255).astype(np.uint8)
        for q in (50, 90):
            _assert_decodes_as_cv2(codec[1], _cv_encode(bgr, cv2.IMWRITE_JPEG_QUALITY, q,
                                                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                        factor))


def test_decode_restart_intervals_and_optimized_tables(codec):
    decode = codec[1]
    for h, w in SIZES:
        img = _image(h, w, seed=6)
        colour = np.stack([img, img[::-1], np.roll(img, 5, 1)], -1)
        for src in (img, colour):
            for rst in (1, 3, 10):
                _assert_decodes_as_cv2(decode, _cv_encode(src, cv2.IMWRITE_JPEG_RST_INTERVAL,
                                                          rst))
            _assert_decodes_as_cv2(decode, _cv_encode(src, cv2.IMWRITE_JPEG_OPTIMIZE, 1))
            _assert_decodes_as_cv2(decode, _cv_encode(src, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                      cv2.IMWRITE_JPEG_RST_INTERVAL, 2))


def _with_exif(data, orientation, big_endian=False):
    e = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(e + "I", 0)
    payload = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:]


def test_exif_orientation_applied_as_cv2(codec):
    encode, decode = codec
    img = _image(45, 67, seed=7)
    data = encode(img, 90)
    for o in range(1, 9):
        for big in (False, True):
            tagged = _with_exif(data, o, big)
            ours = decode(tagged)
            np.testing.assert_array_equal(ours, _cv_decode(tagged))
    # orientation 6 really turns the picture (OpenCV applies EXIF here)
    assert decode(_with_exif(data, 6)).shape == (67, 45)


def test_bad_input_none_where_cv2_none(codec):
    encode, decode = codec
    img = _image(48, 64, seed=8, noise=60.0)
    data = encode(img, 90)
    rng = np.random.default_rng(9)
    cases = [data[:cut] for cut in (2, 3, 20, 100, 300, len(data) // 4, len(data) // 2,
                                    len(data) - 10, len(data) - 3, len(data) - 2,
                                    len(data) - 1)]
    cases += [data[:len(data) // 2] + b"\xff\xd9",           # cut short by EOI
              data[:-2] + bytes(100),                         # no EOI, padded
              data[:-2] + bytes(4),
              data + b"trailing",
              bytes(rng.integers(0, 256, 1000, dtype=np.uint8)),
              b"\xff\xd8\xff" + bytes(rng.integers(0, 256, 500, dtype=np.uint8)),
              b"\xff\xd8"]
    rst = _cv_encode(img, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    cases += [rst[:len(rst) // 2], rst[:len(rst) // 2] + b"\xff\xd9"]
    for i, case in enumerate(cases):
        ref = _cv_decode(case)
        ours = decode(case)
        if ref is None:
            assert ours is None, i
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=str(i))
    assert _cv_decode(data[:len(data) // 2]) is None        # the cut is a real case


def test_progressive_refused(codec):
    img = _image(48, 64, seed=10)
    data = _cv_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    with pytest.raises(ValueError, match="progressive"):
        codec[1](data)


def test_encode_rejects_non_uint8_2d(codec):
    encode = codec[0]
    with pytest.raises(ValueError):
        encode(np.zeros((4, 4, 3), np.uint8), 90)
    with pytest.raises(ValueError):
        encode(np.zeros((4, 4), np.float32), 90)


# -- separate scans per component, built by hand (OpenCV writes one) ---------


def _seg(marker, payload):
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _scan_data(img, q, restart=0):
    """A component's entropy-coded blocks (1x1 sampling), with RST markers
    every `restart` blocks."""
    h, w = img.shape
    pad = np.pad(img, ((0, (-h) % 8), (0, (-w) % 8)), mode="edge").astype(np.int64) - 128
    bh, bw = pad.shape[0] // 8, pad.shape[1] // 8
    blocks = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    coef = jpeg._fdct_pass(jpeg._fdct_pass(blocks, False).swapaxes(1, 2), True).swapaxes(1, 2)
    qq = (q << 3).reshape(8, 8)
    mag = (np.abs(coef) + (qq >> 1)) // qq
    quant = np.where(coef < 0, -mag, mag).reshape(-1, 64)[:, jpeg._ZIGZAG]
    step = restart or len(quant)
    parts = [jpeg._entropy_code(quant[i:i + step]) for i in range(0, len(quant), step)]
    return b"".join(p + (bytes([0xFF, 0xD0 + n % 8]) if n < len(parts) - 1 else b"")
                    for n, p in enumerate(parts))


def _multiscan_file(img, luma_scan=True):
    """A 3-component JFIF frame at 1x1 sampling, one scan per component: Cb,
    then (with a restart interval of 3) Y, then Cr; Cb and Cr take a 16-bit
    quantization table."""
    h, w = img.shape
    q8, q16 = jpeg._quant_table(90), jpeg._quant_table(40) * 3
    dht = b"".join(_seg(0xC4, bytes.fromhex(jpeg._STD_DHT[t])) for t in ((0, 0), (1, 0)))
    parts = [b"\xff\xd8", _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
             _seg(0xDB, b"\x00" + q8[jpeg._ZIGZAG].astype(np.uint8).tobytes()
                  + b"\x11" + q16[jpeg._ZIGZAG].astype(">u2").tobytes()),
             _seg(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x11, 0, 2, 0x11, 1,
                                                                  3, 0x11, 1])),
             dht, _seg(0xDA, bytes([1, 2, 0x00, 0, 63, 0])) + _scan_data(255 - img, q16)]
    if luma_scan:
        parts += [_seg(0xDD, struct.pack(">H", 3)),
                  _seg(0xDA, bytes([1, 1, 0x00, 0, 63, 0])) + _scan_data(img, q8, restart=3),
                  _seg(0xDD, struct.pack(">H", 0))]
    parts += [_seg(0xDA, bytes([1, 3, 0x00, 0, 63, 0])) + _scan_data(img[::-1], q16),
              b"\xff\xd9"]
    return b"".join(parts)


def test_decode_separate_scans_as_cv2(codec):
    decode = codec[1]
    for h, w in SIZES:
        data = _multiscan_file(_image(h, w, seed=11))
        assert _cv_decode(data) is not None
        _assert_decodes_as_cv2(decode, data)
        for cut in (len(data) // 3, len(data) // 2, len(data) - 40):
            _assert_decodes_as_cv2(decode, data[:cut])


def test_luma_without_a_scan_decodes_mid_grey_as_cv2(codec):
    """No scan names the luma: libjpeg latches no table for it and outputs
    mid-grey (the numpy decoder raised AttributeError here before)."""
    data = _multiscan_file(_image(24, 40, seed=12), luma_scan=False)
    out = codec[1](data)
    np.testing.assert_array_equal(out, _cv_decode(data))
    assert (out == 128).all()


# -- the native codec against the numpy reference -----------------------------


def _outcome(decode, data):
    try:
        out = decode(data)
    except ValueError as exc:
        return ("ValueError", str(exc))
    return None if out is None else (out.shape, out.tobytes())


def _assert_same_outcome(data):
    assert _outcome(jpeg.decode_gray, data) == _outcome(jpeg.decode_gray_reference, data)


@pytest.fixture(scope="module")
def native():
    assert jpeg.jpeg_backend() == "native", jpeg.jpeg_build_error()


def _small_files():
    img = _image(16, 24, seed=13, noise=40.0)
    colour = np.stack([img, img[::-1], 255 - img], -1)
    return {"grey": jpeg.encode_gray_reference(img, 90),
            "colour_420_rst": _cv_encode(colour, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 1),
            "optimized": _cv_encode(img, cv2.IMWRITE_JPEG_OPTIMIZE, 1),
            "multiscan": _multiscan_file(img[:8, :16])}


SMALL_FILES = _small_files()


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 80), w=st.integers(1, 80), quality=st.integers(1, 100),
       seed=st.integers(0, 2**31 - 1), noise=st.sampled_from([0.0, 20.0, 120.0]))
def test_native_codec_equals_numpy_on_random_images(native, h, w, quality, seed, noise):
    img = _image(h, w, seed=seed, noise=noise)
    data = jpeg.encode_gray(img, quality)
    assert data == jpeg.encode_gray_reference(img, quality)
    np.testing.assert_array_equal(jpeg.decode_gray(data), jpeg.decode_gray_reference(data))


@pytest.mark.parametrize("name", list(SMALL_FILES))
def test_native_decoder_equals_numpy_on_every_truncation(native, name):
    data = SMALL_FILES[name]
    for cut in range(len(data) + 1):
        _assert_same_outcome(data[:cut])
    _assert_same_outcome(data + bytes(64))


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(name=st.sampled_from(list(SMALL_FILES)), flips=st.lists(
    st.tuples(st.floats(0.0, 1.0, exclude_max=True), st.integers(0, 255)),
    min_size=1, max_size=4))
def test_native_decoder_equals_numpy_on_byte_flips(native, name, flips):
    data = bytearray(SMALL_FILES[name])
    for where, value in flips:
        data[int(where * len(data))] = value
    _assert_same_outcome(bytes(data))
