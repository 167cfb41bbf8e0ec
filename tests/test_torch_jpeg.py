"""Port parity, the numpy baseline JPEG codec (lpslam_tpu_torch/io/jpeg.py)
against OpenCV, which the JAX package calls (lpslam_tpu/pipeline/record.py).

- encode_gray: bytes equal to ``cv2.imencode(".jpg", img,
  [IMWRITE_JPEG_QUALITY, q])`` on grey images at q 1 / 50 / 70 / 90 / 95 /
  100 and sizes 1x1, 45x67, 48x64, 120x160; float32 input is clipped and
  truncated as the JAX ``_encode_jpeg`` does.
- decode_gray: equal to ``cv2.imdecode(buf, IMREAD_GRAYSCALE)`` on its own
  output, on OpenCV's grey output, on OpenCV's colour output at sampling
  4:4:4 / 4:2:2 / 4:2:0, with restart intervals, with optimized Huffman
  tables, with each EXIF orientation, and on cut and padded streams (None
  wherever OpenCV gives None); ValueError on a progressive file.
"""
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from lpslam_tpu.pipeline.record import _encode_jpeg as jax_encode_jpeg  # noqa: E402
from lpslam_tpu_torch.io.jpeg import decode_gray, encode_gray  # noqa: E402

torch.set_num_threads(1)

SIZES = [(1, 1), (45, 67), (48, 64), (120, 160)]
QUALITIES = [1, 50, 70, 90, 95, 100]


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


def _assert_decodes_as_cv2(data):
    ref = _cv_decode(data)
    ours = decode_gray(data)
    if ref is None:
        assert ours is None
    else:
        assert ours is not None and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", SIZES)
def test_encode_matches_cv2(size):
    for seed, noise in ((0, 20.0), (1, 80.0)):
        img = _image(*size, seed=seed, noise=noise)
        for q in QUALITIES:
            data = encode_gray(img, q)
            assert data == _cv_encode(img, cv2.IMWRITE_JPEG_QUALITY, q), (size, q)
            _assert_decodes_as_cv2(data)            # ours, so OpenCV's grey output too


def test_float_input_clipped_and_truncated_as_jax():
    from lpslam_tpu_torch.pipeline.record import _encode_jpeg

    rng = np.random.default_rng(3)
    img = rng.uniform(-40.0, 300.0, (45, 67)).astype(np.float32)
    assert _encode_jpeg(img, 90) == jax_encode_jpeg(img, 90)
    assert _encode_jpeg(img.astype(np.uint8) * 0 + 7, 70) == jax_encode_jpeg(
        np.full((45, 67), 7, np.uint8), 70)


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_decode_colour_luma_as_cv2(sampling):
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    rng = np.random.default_rng(4)
    for h, w in SIZES[1:]:
        grey = _image(h, w, seed=5)
        bgr = np.stack([grey, np.roll(grey, 3, 1), 255 - grey], -1)
        bgr = np.clip(bgr + rng.normal(0, 10, bgr.shape), 0, 255).astype(np.uint8)
        for q in (50, 90):
            _assert_decodes_as_cv2(_cv_encode(bgr, cv2.IMWRITE_JPEG_QUALITY, q,
                                              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor))


def test_decode_restart_intervals_and_optimized_tables():
    for h, w in SIZES:
        img = _image(h, w, seed=6)
        colour = np.stack([img, img[::-1], np.roll(img, 5, 1)], -1)
        for src in (img, colour):
            for rst in (1, 3, 10):
                _assert_decodes_as_cv2(_cv_encode(src, cv2.IMWRITE_JPEG_RST_INTERVAL, rst))
            _assert_decodes_as_cv2(_cv_encode(src, cv2.IMWRITE_JPEG_OPTIMIZE, 1))
            _assert_decodes_as_cv2(_cv_encode(src, cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                              cv2.IMWRITE_JPEG_RST_INTERVAL, 2))


def _with_exif(data, orientation, big_endian=False):
    e = ">" if big_endian else "<"
    import struct

    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
    tiff += struct.pack(e + "I", 0)
    payload = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:]


def test_exif_orientation_applied_as_cv2():
    img = _image(45, 67, seed=7)
    data = encode_gray(img, 90)
    for o in range(1, 9):
        for big in (False, True):
            tagged = _with_exif(data, o, big)
            ours = decode_gray(tagged)
            np.testing.assert_array_equal(ours, _cv_decode(tagged))
    # orientation 6 really turns the picture (OpenCV applies EXIF here)
    assert decode_gray(_with_exif(data, 6)).shape == (67, 45)


def test_bad_input_none_where_cv2_none():
    img = _image(48, 64, seed=8, noise=60.0)
    data = encode_gray(img, 90)
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
        ours = decode_gray(case)
        if ref is None:
            assert ours is None, i
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=str(i))
    assert _cv_decode(data[:len(data) // 2]) is None        # the cut is a real case


def test_progressive_refused():
    img = _image(48, 64, seed=10)
    data = _cv_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    with pytest.raises(ValueError, match="progressive"):
        decode_gray(data)


def test_encode_rejects_non_uint8_2d():
    with pytest.raises(ValueError):
        encode_gray(np.zeros((4, 4, 3), np.uint8), 90)
    with pytest.raises(ValueError):
        encode_gray(np.zeros((4, 4), np.float32), 90)
