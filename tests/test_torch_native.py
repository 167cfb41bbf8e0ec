"""Port parity, the native module (lpslam_tpu_torch/native, built here with
g++): the eight cases of tests/test_native.py run against the port's build
(queue FIFO, drop-oldest, blocking producer/consumer, qsize polling against
a blocking pop, close; stream round trip, the 5 MB cap; fast_detect against
JAX's fast_score and the port's plain FAST, IoU > 0.95, the JAX test's bar),
streams crossing the packages (the port's native writer against the JAX
package's Python framing, both ways, byte-equal files), and the factories:
the pipeline's BoundedQueue and the record stream take the native module.
"""
import queue
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpslam_tpu_torch.native import build_native, get_native, native_build_error

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def native():
    mod = get_native()
    assert mod is not None, native_build_error()
    return mod


class TestBoundedQueue:
    def test_fifo(self, native):
        q = native.BoundedQueue(maxsize=4)
        for i in range(3):
            assert q.push(i)
        assert q.qsize() == 3
        assert [q.pop() for _ in range(3)] == [0, 1, 2]
        assert q.pop(timeout=0.05) is None

    def test_drop_oldest(self, native):
        q = native.BoundedQueue(maxsize=2)
        q.push(1)
        q.push(2)
        q.push(3, drop_oldest=True)
        assert q.pop() == 2
        assert q.pop() == 3

    def test_blocking_producer_consumer(self, native):
        q = native.BoundedQueue(maxsize=8)
        received = []

        def consumer():
            while True:
                item = q.pop(timeout=2.0)
                if item is None or item == "stop":
                    break
                received.append(item)

        t = threading.Thread(target=consumer)
        t.start()
        for i in range(100):
            q.push(i)
        q.push("stop")
        t.join(timeout=5)
        assert not t.is_alive()
        assert received == list(range(100))

    def test_qsize_poll_vs_blocking_pop_no_deadlock(self, native):
        """A GIL-holding qsize() poll beside a GIL-releasing pop() and push()
        must not deadlock (the RecordEngine drain against its worker)."""
        q = native.BoundedQueue(maxsize=64)
        done = threading.Event()

        def consumer():
            while not done.is_set():
                q.pop(timeout=0.05)

        def producer():
            i = 0
            while not done.is_set():
                q.push(i, timeout=0.0, drop_oldest=True)
                i += 1

        threads = [threading.Thread(target=consumer, daemon=True),
                   threading.Thread(target=producer, daemon=True)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 2.0
        polls = 0
        while time.monotonic() < deadline:
            q.qsize()
            polls += 1
        done.set()
        for t in threads:
            t.join(timeout=5)
        assert not any(t.is_alive() for t in threads), f"deadlock after {polls} polls"
        assert polls > 1000

    def test_close_unblocks(self, native):
        q = native.BoundedQueue(maxsize=2)
        out = []

        def waiter():
            out.append(q.pop(timeout=10.0))

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.1)
        q.close()
        t.join(timeout=3)
        assert not t.is_alive()
        assert out == [None]


def _messages():
    from lpslam_tpu_torch.io import lpslam_pb as pb

    return [
        (pb.MSG_SENSOR_IMU, pb.SensorImu(timestamp=42, acc=pb.Vec3Sigma(x=1.0, y=2.0, z=3.0))),
        (pb.MSG_CAMERA_IMAGE, pb.CameraImage(timestamp=7, data_number=3, image_data=b"\xff" * 999)),
        (pb.MSG_RESULT, pb.GlobalStateInTime(timestamp=9)),
    ]


class TestStream:
    def test_roundtrip_and_python_interop(self, native, tmp_path, monkeypatch):
        from lpslam_tpu_torch.io import lpslam_pb as pb

        path = str(tmp_path / "native.pb")
        w = native.StreamWriter(path)
        msg = pb.SensorImu(timestamp=42, acc=pb.Vec3Sigma(x=1.0, y=2.0, z=3.0))
        w.write(pb.MSG_SENSOR_IMU, msg.encode())
        w.write(7, b"rawpayload")  # unknown type passthrough
        w.close()

        r = native.StreamReader(path)
        t1, p1 = r.read()
        assert t1 == pb.MSG_SENSOR_IMU
        dec = pb.SensorImu.decode(p1)
        assert dec.timestamp == 42 and dec.acc.z == 3.0
        assert r.read() == (7, b"rawpayload")
        assert r.read() is None

        # the port's Python framing reads the native file
        monkeypatch.setattr(pb, "_native_io", lambda: None)
        with pb.ProtoStreamReader(path) as pr:
            assert pr._native is None
            t, m = next(pr)
            assert t == pb.MSG_SENSOR_IMU and m.acc.y == 2.0
            assert next(pr) == (7, b"rawpayload")

    def test_size_cap(self, native, tmp_path):
        w = native.StreamWriter(str(tmp_path / "x.pb"))
        with pytest.raises(ValueError):
            w.write(1, b"x" * 6_000_000)
        w.close()

    def test_streams_cross_the_packages_byte_equal(self, native, tmp_path, monkeypatch):
        """The port's native writer and the JAX package's Python framing write
        the same bytes, and each package's reader takes the other's file."""
        from lpslam_tpu.io import lpslam_pb as jpb
        from lpslam_tpu_torch.io import lpslam_pb as pb

        msgs = _messages()
        ours, theirs = tmp_path / "port_native.pb", tmp_path / "jax_python.pb"
        with pb.ProtoStreamWriter(ours) as w:
            assert w._native is not None
            for t, m in msgs:
                w.write(t, m)
        monkeypatch.setattr(jpb, "_native_io", lambda: None)
        with jpb.ProtoStreamWriter(str(theirs)) as w:
            assert w._native is None
            for t, m in msgs:
                w.write(t, jpb._DECODERS[t].decode(m.encode()))
        assert ours.read_bytes() == theirs.read_bytes()

        with jpb.ProtoStreamReader(str(ours)) as r:
            assert [(t, m.encode()) for t, m in r] == [(t, m.encode()) for t, m in msgs]
        with pb.ProtoStreamReader(theirs) as r:
            assert r._native is not None
            assert [(t, m.encode()) for t, m in r] == [(t, m.encode()) for t, m in msgs]


class TestFastDetect:
    def test_matches_jax_and_the_plain_fast(self, native):
        from lpslam_tpu.kernels.fast import fast_score as jax_fast_score
        from lpslam_tpu_torch.io.synthetic import make_texture
        from lpslam_tpu_torch.kernels.fast import fast_score

        img = make_texture(120, 160, seed=6)
        img8 = np.clip(img, 0, 255).astype(np.uint8)
        corners = native.fast_detect(img8.tobytes(), 160, 120, 20.0)
        assert len(corners) > 20
        ours = {(x, y) for x, y, _ in corners}
        _, jax_corner = jax_fast_score(jnp.asarray(img8.astype(np.float32)), 20.0)
        _, port_corner = fast_score(torch.from_numpy(img8.astype(np.float32)), 20.0)
        for mask in (np.asarray(jax_corner), port_corner.numpy()):
            ref = {(x, y) for y, x in np.argwhere(mask)}
            assert len(ref & ours) / len(ref | ours) > 0.95, (len(ref & ours), len(ref | ours))


def test_factories_take_the_native_module(native, tmp_path):
    from lpslam_tpu_torch.io import lpslam_pb as pb
    from lpslam_tpu_torch.pipeline.queues import BoundedQueue, NativeBoundedQueue

    q = BoundedQueue(maxsize=2)
    assert isinstance(q, NativeBoundedQueue)
    for i in range(5):
        q.push(i)
    assert [q.pop(timeout=0.01) for _ in range(3)] == [3, 4, None]
    q.put_nowait("a")
    q.put_nowait("b")
    with pytest.raises(queue.Full):
        q.put_nowait("c")
    assert q.qsize() == 2 and not q.empty()
    assert q.get_nowait() == "a" and q.get(timeout=0.01) == "b"
    assert q.empty()
    with pb.ProtoStreamWriter(tmp_path / "f.pb") as w:
        assert w._native is not None
    # built once: the library name carries the hash of source and flags
    assert build_native() == build_native()


def test_a_failed_build_is_reported_and_falls_back(tmp_path, monkeypatch):
    """No module: the compiler's stderr is kept and warned about once, and
    the queue and the stream fall back to Python."""
    from lpslam_tpu_torch import native as nat
    from lpslam_tpu_torch.io import lpslam_pb as pb
    from lpslam_tpu_torch.pipeline.queues import BoundedQueue, PyBoundedQueue

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(nat, "SOURCE", broken)
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nat, "_state", {"tried": False, "module": None, "error": None,
                                        "build_s": None})
    with pytest.warns(RuntimeWarning, match="pure-Python"):
        assert nat.get_native() is None
    assert "broken.cpp" in nat.native_build_error()
    assert not list((tmp_path / "build").glob("*.so"))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert nat.get_native() is None           # not retried, not warned again
        assert isinstance(BoundedQueue(maxsize=2), PyBoundedQueue)
        with pb.ProtoStreamWriter(tmp_path / "f.pb") as w:
            assert w._native is None
            w.write(pb.MSG_RESULT, pb.GlobalStateInTime(timestamp=1))
    assert (tmp_path / "f.pb").read_bytes()[:16] == bytes([pb.MSG_RESULT] + [0] * 7) + bytes(
        [len(pb.GlobalStateInTime(timestamp=1).encode())] + [0] * 7)


def test_a_module_built_earlier_is_loaded_and_reported(tmp_path, monkeypatch):
    """A library that an earlier process built is loaded without g++, and
    chip_smoke.py's phase 2 / 15a line says so instead of a build time."""
    import chip_smoke
    from lpslam_tpu_torch import native as nat

    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "build")
    fresh = {"tried": False, "module": None, "error": None, "build_s": None}
    monkeypatch.setattr(nat, "_state", dict(fresh))
    assert nat.get_native() is not None
    assert nat.native_build_seconds() > 0
    assert chip_smoke.native_note().startswith("loaded, g++ ")
    monkeypatch.setattr(nat, "_state", dict(fresh))           # a second process
    assert nat.get_native() is not None
    assert nat.native_build_seconds() is None
    assert chip_smoke.native_note() == "loaded, built earlier (no g++ in this process)"
