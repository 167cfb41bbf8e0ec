"""Record and replay over the lpslam .pb stream (port of
lpslam_tpu/pipeline/record.py).

- RecordEngine serializes camera frames (grey JPEG, io/jpeg.py), their
  navigation states, sensor values and results on a worker thread; stop()
  drains its queue for up to 5 s.
- ReplayEngine streams a recording back onto the camera and sensor queues
  in chunks (500 by default), refilling when the camera queue falls below
  half a chunk; frames wait for room rather than drop.

Both write and read the JAX package's bytes: a stream either package wrote
replays through the other.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from ..io import lpslam_pb as pb
from ..io.jpeg import decode_gray, encode_gray
from .queues import BoundedQueue, CameraQueueEntry, ManagedThread, SensorQueueEntry

_log = logging.getLogger("lpslam_tpu_torch")


def _encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """A frame as grey JPEG; float frames are clipped and truncated to uint8."""
    return encode_gray(np.clip(img, 0, 255).astype(np.uint8), quality)


def _decode_image(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes as a float32 grey frame; None when they do not decode."""
    img = decode_gray(data)
    return None if img is None else img.astype(np.float32)


def _ts_to_int(ts: float) -> int:
    return int(ts * 1e9)


def _int_to_ts(t: int) -> float:
    return t / 1e9


def _quat_to_rot_np(w, x, y, z) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation matrix (host-side numpy)."""
    n = max(np.sqrt(w * w + x * x + y * y + z * z), 1e-12)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> wxyz quaternion (host-side numpy)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def pb_state_to_tuple(gs) -> tuple:
    """Normalize a pb.GlobalState message into the (position, rotation-matrix)
    tuple every live consumer uses (SensorQueueEntry.state convention of
    SyntheticSource / SlamManager.add_global_state)."""
    p = gs.position
    q = gs.orientation
    return (
        np.array([p.x, p.y, p.z], np.float64),
        _quat_to_rot_np(q.w, q.x, q.y, q.z),
    )


def tuple_to_pb_state(state) -> pb.GlobalState:
    """(position, rotation-matrix) tuple -> pb.GlobalState message."""
    pos, R = state
    q = _rot_to_quat_np(R)
    return pb.GlobalState(
        position=pb.Vec3Sigma(x=float(pos[0]), y=float(pos[1]), z=float(pos[2])),
        orientation=pb.Orientation(
            w=float(q[0]), x=float(q[1]), y=float(q[2]), z=float(q[3])
        ),
    )


class RecordEngine:
    """Async recorder: entries are queued and serialized on a worker thread."""

    def __init__(self, jpeg_quality: int = 90, record_images: bool = True):
        self._queue = BoundedQueue(maxsize=256)
        self._writer: Optional[pb.ProtoStreamWriter] = None
        self._worker: Optional[ManagedThread] = None
        self.jpeg_quality = jpeg_quality
        self.record_images = record_images

    def set_output_file(self, path: str):
        self._writer = pb.ProtoStreamWriter(path)

    def start(self):
        if self._writer is None:
            raise RuntimeError("set_output_file first")
        self._worker = ManagedThread(self._loop, name="record")
        self._worker.start()

    def stop(self):
        joined = True
        if self._worker is not None:
            # drain first, with a deadline so a stalled worker cannot wedge
            # shutdown (what is still queued after it is dropped)
            deadline = time.monotonic() + 5.0
            while not self._queue.empty() and time.monotonic() < deadline:
                time.sleep(0.01)
            joined = self._worker.stop()
            self._worker = None
        if self._writer is not None:
            if not joined:
                # the worker may still be writing: leave the stream open
                # rather than close it under the (daemon) thread
                _log.error("record worker did not stop; leaving stream open")
                self._writer = None
                return
            self._writer.close()
            self._writer = None

    def _loop(self, thread: ManagedThread):
        item = self._queue.pop(timeout=0.1)
        if item is None:
            return
        msg_type, msg = item
        self._writer.write(msg_type, msg)

    # -- store API (called from the pipeline worker thread) -----------------

    def store_camera_image(self, entry: CameraQueueEntry):
        """Queue the frame with its navigation states (CameraImage fields
        4, 5, 11 and 12), JPEG-encoded unless `record_images` is off."""
        msg = pb.CameraImage(
            timestamp=_ts_to_int(entry.timestamp),
            camera_number=entry.camera_number,
        )
        if entry.state_odom is not None:
            msg.state_odom = tuple_to_pb_state(entry.state_odom)
            msg.has_state_odom = True
        if entry.state_map is not None:
            msg.state_map = tuple_to_pb_state(entry.state_map)
            msg.has_state_map = True
        if self.record_images:
            msg.image_data = _encode_jpeg(entry.image, self.jpeg_quality)
            if entry.image_second is not None:
                msg.image_data_second = _encode_jpeg(entry.image_second, self.jpeg_quality)
        self._queue.push((pb.MSG_CAMERA_IMAGE, msg))

    def store_imu(self, ts: float, acc: np.ndarray, gyro: np.ndarray):
        msg = pb.SensorImu(
            timestamp=_ts_to_int(ts),
            acc=pb.Vec3Sigma(x=float(acc[0]), y=float(acc[1]), z=float(acc[2])),
            gyro=pb.Vec3Sigma(x=float(gyro[0]), y=float(gyro[1]), z=float(gyro[2])),
        )
        self._queue.push((pb.MSG_SENSOR_IMU, msg))

    def store_global_state(self, ts: float, position, orientation_wxyz, reference=False):
        gs = pb.GlobalState(
            position=pb.Vec3Sigma(
                x=float(position[0]), y=float(position[1]), z=float(position[2])
            ),
            orientation=pb.Orientation(
                w=float(orientation_wxyz[0]), x=float(orientation_wxyz[1]),
                y=float(orientation_wxyz[2]), z=float(orientation_wxyz[3]),
            ),
        )
        msg = pb.SensorGlobalState(timestamp=_ts_to_int(ts), state=gs, reference=reference)
        self._queue.push((pb.MSG_SENSOR_GLOBAL_STATE, msg))

    def store_result(self, ts: float, position, orientation_wxyz,
                     position_sigma=None, orientation_sigma: float = 0.0):
        sig = position_sigma if position_sigma is not None else (0.0, 0.0, 0.0)
        gs = pb.GlobalState(
            position=pb.Vec3Sigma(
                x=float(position[0]), y=float(position[1]), z=float(position[2]),
                x_sigma=float(sig[0]), y_sigma=float(sig[1]),
                z_sigma=float(sig[2]),
            ),
            orientation=pb.Orientation(
                w=float(orientation_wxyz[0]), x=float(orientation_wxyz[1]),
                y=float(orientation_wxyz[2]), z=float(orientation_wxyz[3]),
                sigma=float(orientation_sigma),
            ),
        )
        msg = pb.GlobalStateInTime(timestamp=_ts_to_int(ts), state=gs)
        self._queue.push((pb.MSG_RESULT, msg))

    def store_features(self, ts: float, features: list):
        for f in features:
            p = f["position"]
            msg = pb.SensorFeature(
                timestamp=_ts_to_int(ts),
                position=pb.Vec3Sigma(x=float(p[0]), y=float(p[1]), z=float(p[2])),
                observation_count=int(f.get("observations", 0)),
            )
            self._queue.push((pb.MSG_SENSOR_FEATURE, msg))


class ReplayEngine:
    """Chunked replay of a recorded stream onto the queues.

    Loads `chunk` items at a time, and again once the camera queue holds
    fewer than chunk/2 frames.
    """

    def __init__(self, path: str, chunk: int = 500):
        self._reader = pb.ProtoStreamReader(path)
        self.chunk = chunk
        self.done = False
        self._camera_queue: Optional[BoundedQueue] = None
        self._sensor_queue: Optional[BoundedQueue] = None

    def attach(self, camera_queue: BoundedQueue, sensor_queue: Optional[BoundedQueue]):
        self._camera_queue = camera_queue
        self._sensor_queue = sensor_queue

    def stream_more(self) -> int:
        """Refill if below half-chunk; returns number of items loaded."""
        if self.done or self._camera_queue is None:
            return 0
        if self._camera_queue.qsize() >= max(self.chunk // 2, 1):
            return 0
        loaded = 0
        while loaded < self.chunk:
            try:
                msg_type, msg = next(self._reader)
            except StopIteration:
                self.done = True
                break
            if msg_type == pb.MSG_CAMERA_IMAGE:
                img = _decode_image(msg.image_data)
                if img is None:
                    continue
                second = (
                    _decode_image(msg.image_data_second)
                    if msg.image_data_second
                    else None
                )
                self._camera_queue.push(
                    CameraQueueEntry(
                        timestamp=_int_to_ts(msg.timestamp),
                        image=img,
                        image_second=second,
                        camera_number=msg.camera_number,
                        state_odom=(
                            pb_state_to_tuple(msg.state_odom)
                            if msg.has_state_odom and msg.state_odom is not None
                            else None
                        ),
                        state_map=(
                            pb_state_to_tuple(msg.state_map)
                            if msg.has_state_map and msg.state_map is not None
                            else None
                        ),
                    ),
                    drop_oldest=False,
                )
                loaded += 1
            elif msg_type == pb.MSG_SENSOR_IMU and self._sensor_queue is not None:
                self._sensor_queue.push(
                    SensorQueueEntry(
                        timestamp=_int_to_ts(msg.timestamp),
                        kind="imu",
                        acc=np.asarray([msg.acc.x, msg.acc.y, msg.acc.z]),
                        gyro=np.asarray([msg.gyro.x, msg.gyro.y, msg.gyro.z]),
                    )
                )
            elif msg_type == pb.MSG_SENSOR_GLOBAL_STATE and self._sensor_queue is not None:
                # as the (position, rotation matrix) tuple of
                # SlamManager.add_global_state
                self._sensor_queue.push(
                    SensorQueueEntry(
                        timestamp=_int_to_ts(msg.timestamp),
                        kind="global_state",
                        state=pb_state_to_tuple(msg.state),
                        reference=msg.reference,
                    )
                )
            # MSG_RESULT / MSG_SENSOR_FEATURE are outputs; skipped on replay
        return loaded
