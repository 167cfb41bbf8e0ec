"""Port parity, the pipeline's I/O and frame processing, on the CPU.

- io/png.py against OpenCV: files cv2.imwrite wrote (8-bit gray, BGR, BGRA,
  16-bit gray) and files carrying every one of the five row filters read
  bit-equal to cv2.imread (IMREAD_GRAYSCALE and IMREAD_UNCHANGED); the
  writer's files read back bit-equal in both readers.
- The manager's BGR(A) -> gray is bit-equal to cv2.cvtColor on uint8 and
  within 1e-4 on float32; NV12, YUYV and the stacked stereo layouts give
  the JAX manager's frames exactly.
- Blackout and AdjustIntensity equal JAX's output exactly.
- RectifyProcessor (numpy grids, port remap) against the JAX one (cv2 grids
  for mono, cv2.stereoRectify for the pair) on the 160x120 room: grids
  within 1e-3 px (mono equal, the pair 4.6e-4 px: the rectified focal
  length differs by 9.4e-6 relative, so K_new is held within 2e-5), frames
  within 1e-3 gray levels for mono and 0.1 for the pair (0.05 measured on
  the room's sharpest edges).
- make_sequence frames within 1e-3 gray levels of JAX's, poses within 1e-6;
  imu_from_poses within 1e-4 rad/s and 1e-6 relative; waypoint_trajectory equal.
- Map files cross between the packages in both directions, equal field by
  field; nearest-neighbour mask resizing equals cv2.INTER_NEAREST.
"""
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from lpslam_tpu.io.synthetic import make_texture

from lpslam_tpu_torch.io import png
from lpslam_tpu_torch.pipeline.queues import CameraQueueEntry

torch.set_num_threads(1)


def _texture_u8(h, w, seed):
    return np.clip(make_texture(h, w, seed=seed), 0, 255).astype(np.uint8)


def _png_with_all_filters(path, img):
    """A PNG whose rows cycle through filters 0-4 (8-bit gray/RGB/RGBA as
    uint8, 16-bit gray as uint16)."""
    if img.dtype == np.uint16:
        raw, ctype, depth, bpp = img.astype(">u2").view(np.uint8), 0, 16, 2
    else:
        ctype = {2: 0, 3: 2, 4: 6}[img.ndim if img.ndim == 2 else img.shape[2] + 0]
        raw, depth, bpp = img, 8, 1 if img.ndim == 2 else img.shape[2]
    h = img.shape[0]
    rows = raw.reshape(h, -1).astype(np.int32)
    out = []
    prev = np.zeros_like(rows[0])
    for r in range(h):
        cur, f = rows[r], r % 5
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(np.concatenate([[f], (cur - pred) & 255]).astype(np.uint8))
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", img.shape[1], h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
                + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
                + chunk(b"IEND", b""))


def _images():
    g = _texture_u8(61, 83, 3)
    col = np.stack([g, np.roll(g, 7, 1), 255 - g], -1)
    rng = np.random.default_rng(0)
    return {
        "gray8": g,
        "bgr": col,
        "bgra": np.concatenate([col, rng.integers(0, 256, g.shape + (1,), dtype=np.uint8)], -1),
        "gray16": (g.astype(np.uint16) * 257 + rng.integers(0, 200, g.shape)).astype(np.uint16),
        "noise_bgr": rng.integers(0, 256, (37, 45, 3), dtype=np.uint8),
    }


@pytest.mark.parametrize("writer", ["cv2", "all_filters"])
def test_png_reader_matches_cv2(tmp_path, writer):
    for name, img in _images().items():
        path = str(tmp_path / f"{name}.png")
        if writer == "cv2":
            assert cv2.imwrite(path, img)
        else:
            # our writer takes RGB order for colour: give it the BGR -> RGB flip
            _png_with_all_filters(path, img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]])
        for flag, ours in ((cv2.IMREAD_GRAYSCALE, png.imread_gray),
                           (cv2.IMREAD_UNCHANGED, png.imread_unchanged)):
            want = cv2.imread(path, flag)
            got = ours(path)
            assert got.dtype == want.dtype, (name, flag)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {writer} {flag}")
    assert png.imread_gray(str(tmp_path / "missing.png")) is None


def test_png_writer_round_trips(tmp_path):
    g = _texture_u8(50, 70, 4)
    g16 = g.astype(np.uint16) * 251
    for img in (g, g16, np.asfortranarray(g)):
        path = str(tmp_path / "w.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
        np.testing.assert_array_equal(png.imread_unchanged(path), img)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.uint8))


def test_gray_conversion_matches_cvtcolor():
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    rng = np.random.default_rng(1)
    for n, code in ((3, cv2.COLOR_BGR2GRAY), (4, cv2.COLOR_BGRA2GRAY)):
        x = rng.integers(0, 256, (64, 81, n), dtype=np.uint8)
        np.testing.assert_array_equal(SlamManager._to_gray_f32(x),
                                      cv2.cvtColor(x, code).astype(np.float32))
        xf = x.astype(np.float32) * np.float32(0.93)
        np.testing.assert_allclose(SlamManager._to_gray_f32(xf), cv2.cvtColor(xf, code),
                                   atol=1e-4, rtol=0)
    g = rng.integers(0, 256, (5, 6), dtype=np.uint8)
    np.testing.assert_array_equal(SlamManager._to_gray_f32(g), g.astype(np.float32))


def _pushed(mgr, *a, **kw):
    assert mgr.add_image_from_buffer(*a, **kw)
    return mgr.camera_queue.get_nowait()


def test_buffer_layouts_match_jax():
    from lpslam_tpu.pipeline.manager import SlamManager as JManager
    from lpslam_tpu_torch.pipeline.manager import SlamManager

    jm, tm = JManager(), SlamManager(device="cpu")
    rng = np.random.default_rng(2)
    h, w = 12, 20
    cases = [
        (rng.integers(0, 256, h * w * 3 // 2, dtype=np.uint8),
         dict(pixel_format="nv12", width=w, height=h, stereo_layout="top_bottom")),
        (rng.integers(0, 256, h * w * 2, dtype=np.uint8),
         dict(pixel_format="yuyv", width=w, height=h, stereo_layout="side_by_side")),
        (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), dict(stereo_layout="side_by_side")),
        (rng.integers(0, 256, (h, w, 4), dtype=np.uint8), {}),
        (rng.random((h, w)).astype(np.float32) * 255, dict(stereo_layout="top_bottom")),
    ]
    for buf, kw in cases:
        a, b = _pushed(tm, 1.5, buf, 0, **kw), _pushed(jm, 1.5, buf, 0, **kw)
        np.testing.assert_array_equal(a.image, b.image)
        assert (a.image_second is None) == (b.image_second is None)
        if a.image_second is not None:
            np.testing.assert_array_equal(a.image_second, b.image_second)
    small = np.zeros(10, np.uint8)
    assert tm.add_image_from_buffer(0.0, small, pixel_format="nv12", width=w, height=h) is False
    l, r = cases[2][0], cases[3][0]
    tm.add_stereo_image_from_buffer(2.0, l, r)
    jm.add_stereo_image_from_buffer(2.0, l, r)
    a, b = tm.camera_queue.get_nowait(), jm.camera_queue.get_nowait()
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.image_second, b.image_second)


def test_processors_match_jax():
    from lpslam_tpu.pipeline import processors as jp
    from lpslam_tpu.pipeline.queues import CameraQueueEntry as JEntry
    from lpslam_tpu_torch.pipeline import processors as tp

    rng = np.random.default_rng(3)
    frames = [(rng.uniform(90, 150, (24, 32)).astype(np.float32),
               rng.uniform(40, 220, (24, 32)).astype(np.float32)) for _ in range(5)]
    for name, conf in (("BlackoutImageProcessor", {"start_frame": 1, "end_frame": 3}),
                       ("AdjustIntensityProcessor", {"low_percentile": 2.0,
                                                     "high_percentile": 97.0})):
        a, b = getattr(tp, name)(conf), getattr(jp, name)(conf)
        for i, (l, r) in enumerate(frames):
            ea = a.process_image(CameraQueueEntry(i, l.copy(), r.copy()))
            eb = b.process_image(JEntry(i, l.copy(), r.copy()))
            np.testing.assert_array_equal(ea.image, eb.image)
            np.testing.assert_array_equal(ea.image_second, eb.image_second)
    assert tp.stretchlim(frames[0][0]) == jp.stretchlim(frames[0][0])


def test_rectify_processor_matches_jax():
    from lpslam_tpu.io.benchmark import SyntheticBenchmark
    from lpslam_tpu.pipeline.config import CameraConfig as JCam
    from lpslam_tpu.pipeline.queues import CameraQueueEntry as JEntry
    from lpslam_tpu.pipeline.rectify import RectifyProcessor as JRect
    from lpslam_tpu_torch.pipeline.config import CameraConfig
    from lpslam_tpu_torch.pipeline.rectify import RectifyProcessor

    ds = SyntheticBenchmark(num_frames=2, h=120, w=160, seed=0, stereo=True, with_depth=False)
    intr = ds.intr
    fr = next(iter(ds))

    def cams(cls):
        kw = dict(model="perspective", fx=intr["fx"], fy=intr["fy"], cx=intr["cx"],
                  cy=intr["cy"], distortion=np.asarray(intr["dist"], np.float32),
                  width=160, height=120)
        left = cls(number=0, rotation=np.eye(3),
                   translation=np.array([-intr["baseline"], 0.0, 0.0]), **kw)
        return cls(number=0, **kw), left, cls(number=1, **kw)

    mono_t, left_t, right_t = cams(CameraConfig)
    mono_j, left_j, right_j = cams(JCam)
    depth = np.linspace(1.0, 5.0, 120 * 160, dtype=np.float32).reshape(120, 160)
    for ours, ref, second in ((RectifyProcessor(camera=mono_t, device="cpu"), JRect(camera=mono_j),
                               None),
                              (RectifyProcessor(camera=left_t, camera_right=right_t, device="cpu"),
                               JRect(camera=left_j, camera_right=right_j), fr.image_right)):
        np.testing.assert_allclose(ours.K_new, ref.K_new, rtol=2e-5)
        assert ours.focal_x_baseline == pytest.approx(ref.focal_x_baseline, rel=2e-5)
        for ga, gb in zip(ours._maps, ref._maps):
            if ga is not None:
                np.testing.assert_allclose(ga.numpy(), np.asarray(gb), atol=1e-3, rtol=0)
        # a 1e-3 px shift moves a 50-levels/px edge by 0.05
        tol = 1e-3 if second is None else 0.1
        aux = depth if second is None else None
        a = ours.process_image(CameraQueueEntry(0.0, fr.image.copy(), second, aux=aux))
        b = ref.process_image(JEntry(0.0, fr.image.copy(), second, aux=aux))
        np.testing.assert_allclose(a.image, b.image, atol=tol, rtol=0)
        if second is not None:
            np.testing.assert_allclose(a.image_second, b.image_second, atol=tol, rtol=0)
        else:
            np.testing.assert_allclose(a.aux, b.aux, atol=1e-4, rtol=0)


def test_synthetic_sequence_matches_jax():
    from lpslam_tpu.io import synthetic as js
    from lpslam_tpu_torch.io import synthetic as ts

    for kw in (dict(motion="orbit", stereo_baseline=0.2), dict(motion="forward", with_depth=True),
               dict(motion="translate")):
        a = ts.make_sequence(num_frames=4, h=48, w=64, seed=2, fx=60.0, tex_scale=2, **kw)
        b = js.make_sequence(num_frames=4, h=48, w=64, seed=2, fx=60.0, tex_scale=2, **kw)
        np.testing.assert_allclose(a.images, b.images, atol=1e-3, rtol=0)
        for p, q in zip(a.poses_wc, b.poses_wc):
            np.testing.assert_allclose(p.R, np.asarray(q.R), atol=1e-6)
            np.testing.assert_allclose(p.t, np.asarray(q.t), atol=1e-6)
        for x, y in ((a.images_r, b.images_r), (a.depths, b.depths)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_allclose(x, y, atol=1e-3, rtol=0)
        ga, aa = ts.imu_from_poses(a.poses_wc, 20.0)
        gb, ab = js.imu_from_poses(b.poses_wc, 20.0)
        np.testing.assert_allclose(ga, gb, atol=1e-4)
        np.testing.assert_allclose(aa, ab, rtol=1e-6, atol=1e-4)
    wp = [(0.5, 0.0), (0.5, 0.4), (0.0, 0.4)]
    for p, q in zip(ts.waypoint_trajectory(wp, 30), js.waypoint_trajectory(wp, 30)):
        np.testing.assert_array_equal(p.R, np.asarray(q.R))
        np.testing.assert_array_equal(p.t, np.asarray(q.t))


def test_map_files_cross_between_packages(tmp_path):
    from test_torch_pipeline_tracker import jax_map, small_map_numpy
    from lpslam_tpu.mapstore import checkpoint as jck
    from lpslam_tpu_torch.convert import map_to_numpy
    from lpslam_tpu_torch.mapstore import checkpoint as tck

    d = small_map_numpy(seed=4)
    jck.save_map(jax_map(d), str(tmp_path / "j.npz"))
    m = tck.load_map(str(tmp_path / "j.npz"), "cpu")
    assert m.lm_desc.dtype == torch.int32                 # descriptors as bit patterns
    got = map_to_numpy(m)
    tck.save_map(m, str(tmp_path / "t.npz"))
    back = jck.load_map(str(tmp_path / "t.npz"))
    with np.load(str(tmp_path / "t.npz")) as f_t, np.load(str(tmp_path / "j.npz")) as f_j:
        assert sorted(f_t.files) == sorted(f_j.files)
        for k in f_j.files:
            assert f_t[k].dtype == f_j[k].dtype, k
    for k, v in d.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), v, err_msg=k)
    assert tck.load_map(str(tmp_path / "none.npz"), "cpu") is None
    assert not list(tmp_path.glob("*.tmp.npz"))           # the write was atomic


def test_resize_nearest_matches_cv2():
    from lpslam_tpu_torch.pipeline.trackers import resize_nearest

    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    for h, w in ((120, 160), (480, 640), (20, 30), (37, 53), (111, 7), (3, 200)):
        np.testing.assert_array_equal(resize_nearest(src, h, w),
                                      cv2.resize(src, (w, h), interpolation=cv2.INTER_NEAREST))


def test_utils_match_jax(tmp_path):
    from lpslam_tpu import utils as ju
    from lpslam_tpu_torch import utils as tu

    rng = np.random.default_rng(6)
    q = [rng.normal(size=4) for _ in range(4)]
    q = [x / np.linalg.norm(x) for x in q]
    p = [rng.normal(size=3) for _ in range(4)]
    for fn in ("tracker_to_origin", "marker_to_global", "vehicle_pose_from_marker_measurement"):
        a = getattr(tu, fn)(p[0], q[0], p[1], q[1])
        b = getattr(ju, fn)(p[0], q[0], p[1], q[1])
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, np.asarray(y), atol=1e-6)
    pa, pb = tu.PidController(1.5, 0.1, 0.2, -1, 1), ju.PidController(1.5, 0.1, 0.2, -1, 1)
    for e in (0.5, 0.2, -0.7, 3.0):
        assert pa.update(e, 0.05) == pb.update(e, 0.05)
    assert tu.to_rad(90.0) == ju.to_rad(90.0) and tu.to_degree(1.0) == ju.to_degree(1.0)
    stats = tu.TimingStats()
    with tu.ScopeTimer("x", stats):
        sum(range(1000))
    assert stats.mean("x") > 0 and stats.mean("y") == 0.0
    with tu.device_trace(str(tmp_path)):
        torch.ones(8).cumsum(0)
    assert list(tmp_path.iterdir())                   # a trace was written
