"""The lpslam recording stream (a copy of lpslam_tpu/io/lpslam_pb.py, which
imports no JAX but sits in a package that does).

- framing: [u64 little-endian message-type][u64 payload size][proto3 payload],
  5 MB payload cap;
- message types 1..5;
- the proto3 schema ``LpgfSlamSerialize`` with its field numbers, so streams
  written by either package, or by the original C++ system, read back here.

A self-contained proto3 wire codec for exactly these messages (doubles as
fixed64; int64 / int32 / bool as varints; bytes, strings and nested messages
length-delimited); no protoc. The framing and file IO run in the native
module (``native/``: StreamWriter / StreamReader, the GIL released while
they write or read) when it builds, else in Python; the bytes on disk are
the same either way.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

MAX_MSG_SIZE = 5_000_000

# message type ids (framing enum)
MSG_CAMERA_IMAGE = 1
MSG_SENSOR_IMU = 2
MSG_SENSOR_GLOBAL_STATE = 3
MSG_RESULT = 4
MSG_SENSOR_FEATURE = 5

# proto3 wire types
_VARINT = 0
_FIX64 = 1
_LEN = 2


def _tag(fieldno, wt):
    return (fieldno << 3) | wt


def _enc_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_double(buf: bytearray, fieldno: int, v: float, always=False):
    if v == 0.0 and not always:
        return
    buf += _enc_varint(_tag(fieldno, _FIX64))
    buf += struct.pack("<d", v)


def _enc_int(buf: bytearray, fieldno: int, v: int):
    if v == 0:
        return
    buf += _enc_varint(_tag(fieldno, _VARINT))
    buf += _enc_varint(int(v))


def _enc_bool(buf: bytearray, fieldno: int, v: bool):
    if not v:
        return
    buf += _enc_varint(_tag(fieldno, _VARINT))
    buf += b"\x01"


def _enc_bytes(buf: bytearray, fieldno: int, v: bytes):
    if not v:
        return
    buf += _enc_varint(_tag(fieldno, _LEN))
    buf += _enc_varint(len(v))
    buf += v


def _enc_msg(buf: bytearray, fieldno: int, payload: bytes):
    if not payload:
        return
    _enc_bytes(buf, fieldno, payload)


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.i = 0

    def eof(self):
        return self.i >= len(self.d)

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.d[self.i]
            self.i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def svarint64(self) -> int:
        v = self.varint()
        if v >= 1 << 63:
            v -= 1 << 64
        return v

    def double(self) -> float:
        v = struct.unpack_from("<d", self.d, self.i)[0]
        self.i += 8
        return v

    def blob(self) -> bytes:
        n = self.varint()
        b = self.d[self.i : self.i + n]
        self.i += n
        return b

    def skip(self, wt):
        if wt == _VARINT:
            self.varint()
        elif wt == _FIX64:
            self.i += 8
        elif wt == _LEN:
            self.blob()
        elif wt == 5:  # fixed32
            self.i += 4
        else:
            raise ValueError(f"bad wire type {wt}")

    def fields(self):
        while not self.eof():
            key = self.varint()
            yield key >> 3, key & 0x7


# ---------------------------------------------------------------------------
# messages (field numbers mirror the reference schema)
# ---------------------------------------------------------------------------


@dataclass
class Vec3Sigma:
    """Position / Acceleration / Velocity / AngularVelocity share layout:
    x,y,z = 1,2,3 ; x_sigma,y_sigma,z_sigma = 4,5,6."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    x_sigma: float = 0.0
    y_sigma: float = 0.0
    z_sigma: float = 0.0

    def encode(self) -> bytes:
        b = bytearray()
        _enc_double(b, 1, self.x)
        _enc_double(b, 2, self.y)
        _enc_double(b, 3, self.z)
        _enc_double(b, 4, self.x_sigma)
        _enc_double(b, 5, self.y_sigma)
        _enc_double(b, 6, self.z_sigma)
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if wt == _FIX64 and 1 <= f <= 6:
                v = r.double()
                setattr(m, ["x", "y", "z", "x_sigma", "y_sigma", "z_sigma"][f - 1], v)
            else:
                r.skip(wt)
        return m


@dataclass
class Orientation:
    """w,x,y,z = 1..4 ; sigma = 5."""

    w: float = 1.0
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    sigma: float = 0.0

    def encode(self) -> bytes:
        b = bytearray()
        _enc_double(b, 1, self.w)
        _enc_double(b, 2, self.x)
        _enc_double(b, 3, self.y)
        _enc_double(b, 4, self.z)
        _enc_double(b, 5, self.sigma)
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls(w=0.0)
        r = _Reader(data)
        for f, wt in r.fields():
            if wt == _FIX64 and 1 <= f <= 5:
                setattr(m, ["w", "x", "y", "z", "sigma"][f - 1], r.double())
            else:
                r.skip(wt)
        return m


@dataclass
class GlobalState:
    """position=1, orientation=2, velocity=3, velocityValid=4."""

    position: Vec3Sigma = field(default_factory=Vec3Sigma)
    orientation: Orientation = field(default_factory=Orientation)
    velocity: Vec3Sigma = field(default_factory=Vec3Sigma)
    velocity_valid: bool = False

    def encode(self) -> bytes:
        b = bytearray()
        _enc_msg(b, 1, self.position.encode())
        _enc_msg(b, 2, self.orientation.encode())
        _enc_msg(b, 3, self.velocity.encode())
        _enc_bool(b, 4, self.velocity_valid)
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if f == 1 and wt == _LEN:
                m.position = Vec3Sigma.decode(r.blob())
            elif f == 2 and wt == _LEN:
                m.orientation = Orientation.decode(r.blob())
            elif f == 3 and wt == _LEN:
                m.velocity = Vec3Sigma.decode(r.blob())
            elif f == 4 and wt == _VARINT:
                m.velocity_valid = bool(r.varint())
            else:
                r.skip(wt)
        return m


@dataclass
class GlobalStateInTime:
    """timeStamp=1 (int64), globalState=2."""

    timestamp: int = 0
    state: GlobalState = field(default_factory=GlobalState)

    def encode(self) -> bytes:
        b = bytearray()
        _enc_int(b, 1, self.timestamp)
        _enc_msg(b, 2, self.state.encode())
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if f == 1 and wt == _VARINT:
                m.timestamp = r.svarint64()
            elif f == 2 and wt == _LEN:
                m.state = GlobalState.decode(r.blob())
            else:
                r.skip(wt)
        return m


@dataclass
class TrackerCoordinateSystem:
    """position=1, orientation=2."""

    position: Vec3Sigma = field(default_factory=Vec3Sigma)
    orientation: Orientation = field(default_factory=Orientation)

    def encode(self) -> bytes:
        b = bytearray()
        _enc_msg(b, 1, self.position.encode())
        _enc_msg(b, 2, self.orientation.encode())
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if f == 1 and wt == _LEN:
                m.position = Vec3Sigma.decode(r.blob())
            elif f == 2 and wt == _LEN:
                m.orientation = Orientation.decode(r.blob())
            else:
                r.skip(wt)
        return m


@dataclass
class CameraImage:
    """timeStamp=1, dataNumber=2, imageData=3, state_odom=4, state_map=5,
    cameraNumber=6, imageData_second=7, cameraNumber_second=8, imageBase=9,
    imageBase_second=10, hasGlobalState_odom=11, hasGlobalState_map=12."""

    timestamp: int = 0
    data_number: int = 0
    image_data: bytes = b""
    state_odom: Optional[GlobalState] = None
    state_map: Optional[GlobalState] = None
    camera_number: int = 0
    image_data_second: bytes = b""
    camera_number_second: int = 0
    image_base: Optional[TrackerCoordinateSystem] = None
    image_base_second: Optional[TrackerCoordinateSystem] = None
    has_state_odom: bool = False
    has_state_map: bool = False

    def encode(self) -> bytes:
        b = bytearray()
        _enc_int(b, 1, self.timestamp)
        _enc_int(b, 2, self.data_number)
        _enc_bytes(b, 3, self.image_data)
        if self.state_odom is not None:
            _enc_msg(b, 4, self.state_odom.encode())
        if self.state_map is not None:
            _enc_msg(b, 5, self.state_map.encode())
        _enc_int(b, 6, self.camera_number)
        _enc_bytes(b, 7, self.image_data_second)
        _enc_int(b, 8, self.camera_number_second)
        if self.image_base is not None:
            _enc_msg(b, 9, self.image_base.encode())
        if self.image_base_second is not None:
            _enc_msg(b, 10, self.image_base_second.encode())
        _enc_bool(b, 11, self.has_state_odom)
        _enc_bool(b, 12, self.has_state_map)
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if f == 1 and wt == _VARINT:
                m.timestamp = r.svarint64()
            elif f == 2 and wt == _VARINT:
                m.data_number = r.svarint64()
            elif f == 3 and wt == _LEN:
                m.image_data = bytes(r.blob())
            elif f == 4 and wt == _LEN:
                m.state_odom = GlobalState.decode(r.blob())
            elif f == 5 and wt == _LEN:
                m.state_map = GlobalState.decode(r.blob())
            elif f == 6 and wt == _VARINT:
                m.camera_number = r.svarint64()
            elif f == 7 and wt == _LEN:
                m.image_data_second = bytes(r.blob())
            elif f == 8 and wt == _VARINT:
                m.camera_number_second = r.svarint64()
            elif f == 9 and wt == _LEN:
                m.image_base = TrackerCoordinateSystem.decode(r.blob())
            elif f == 10 and wt == _LEN:
                m.image_base_second = TrackerCoordinateSystem.decode(r.blob())
            elif f == 11 and wt == _VARINT:
                m.has_state_odom = bool(r.varint())
            elif f == 12 and wt == _VARINT:
                m.has_state_map = bool(r.varint())
            else:
                r.skip(wt)
        return m


@dataclass
class SensorImu:
    """timesTamp=1 (sic — typo preserved from the wire schema), acc=2, gyro=3."""

    timestamp: int = 0
    acc: Vec3Sigma = field(default_factory=Vec3Sigma)
    gyro: Vec3Sigma = field(default_factory=Vec3Sigma)

    def encode(self) -> bytes:
        b = bytearray()
        _enc_int(b, 1, self.timestamp)
        _enc_msg(b, 2, self.acc.encode())
        _enc_msg(b, 3, self.gyro.encode())
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if f == 1 and wt == _VARINT:
                m.timestamp = r.svarint64()
            elif f == 2 and wt == _LEN:
                m.acc = Vec3Sigma.decode(r.blob())
            elif f == 3 and wt == _LEN:
                m.gyro = Vec3Sigma.decode(r.blob())
            else:
                r.skip(wt)
        return m


@dataclass
class SensorGlobalState:
    """timesTamp=1, globalState=2, reference=3."""

    timestamp: int = 0
    state: GlobalState = field(default_factory=GlobalState)
    reference: bool = False

    def encode(self) -> bytes:
        b = bytearray()
        _enc_int(b, 1, self.timestamp)
        _enc_msg(b, 2, self.state.encode())
        _enc_bool(b, 3, self.reference)
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if f == 1 and wt == _VARINT:
                m.timestamp = r.svarint64()
            elif f == 2 and wt == _LEN:
                m.state = GlobalState.decode(r.blob())
            elif f == 3 and wt == _VARINT:
                m.reference = bool(r.varint())
            else:
                r.skip(wt)
        return m


@dataclass
class SensorFeature:
    """timeStamp=1, lastObserved=2, position=3, closestKeyframePosition=4,
    observationCount=5, anchorId=6."""

    timestamp: int = 0
    last_observed: int = 0
    position: Vec3Sigma = field(default_factory=Vec3Sigma)
    closest_keyframe: Vec3Sigma = field(default_factory=Vec3Sigma)
    observation_count: int = 0
    anchor_id: str = ""

    def encode(self) -> bytes:
        b = bytearray()
        _enc_int(b, 1, self.timestamp)
        _enc_int(b, 2, self.last_observed)
        _enc_msg(b, 3, self.position.encode())
        _enc_msg(b, 4, self.closest_keyframe.encode())
        _enc_int(b, 5, self.observation_count)
        _enc_bytes(b, 6, self.anchor_id.encode("utf-8"))
        return bytes(b)

    @classmethod
    def decode(cls, data: bytes):
        m = cls()
        r = _Reader(data)
        for f, wt in r.fields():
            if f == 1 and wt == _VARINT:
                m.timestamp = r.svarint64()
            elif f == 2 and wt == _VARINT:
                m.last_observed = r.svarint64()
            elif f == 3 and wt == _LEN:
                m.position = Vec3Sigma.decode(r.blob())
            elif f == 4 and wt == _LEN:
                m.closest_keyframe = Vec3Sigma.decode(r.blob())
            elif f == 5 and wt == _VARINT:
                m.observation_count = r.svarint64()
            elif f == 6 and wt == _LEN:
                m.anchor_id = bytes(r.blob()).decode("utf-8", "replace")
            else:
                r.skip(wt)
        return m


_DECODERS = {
    MSG_CAMERA_IMAGE: CameraImage,
    MSG_SENSOR_IMU: SensorImu,
    MSG_SENSOR_GLOBAL_STATE: SensorGlobalState,
    MSG_RESULT: GlobalStateInTime,
    MSG_SENSOR_FEATURE: SensorFeature,
}


# ---------------------------------------------------------------------------
# framed stream
# ---------------------------------------------------------------------------


def _native_io():
    from ..native import get_native

    return get_native()


class ProtoStreamWriter:
    """[u64 type][u64 size][payload] framing, little-endian, 5 MB cap; the
    native StreamWriter frames and writes when the module is there."""

    def __init__(self, path):
        mod = _native_io()
        self._native = mod.StreamWriter(str(path)) if mod is not None else None
        self.f = None if self._native is not None else open(path, "wb")

    def write(self, msg_type: int, msg) -> None:
        payload = msg.encode()
        if self._native is not None:
            self._native.write(msg_type, payload)
            return
        if len(payload) > MAX_MSG_SIZE:
            raise ValueError(f"message of {len(payload)} bytes exceeds 5 MB cap")
        self.f.write(struct.pack("<QQ", msg_type, len(payload)))
        self.f.write(payload)

    def close(self):
        if self._native is not None:
            self._native.close()
        else:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ProtoStreamReader:
    """Iterates (type, decoded message), or (type, raw bytes) for an unknown
    type; the native StreamReader reads when the module is there."""

    def __init__(self, path):
        mod = _native_io()
        self._native = mod.StreamReader(str(path)) if mod is not None else None
        self.f = None if self._native is not None else open(path, "rb")

    def __iter__(self):
        return self

    def __next__(self):
        if self._native is not None:
            item = self._native.read()
            if item is None:
                raise StopIteration
            msg_type, payload = item
        else:
            hdr = self.f.read(16)
            if len(hdr) < 16:
                raise StopIteration
            msg_type, size = struct.unpack("<QQ", hdr)
            if size > MAX_MSG_SIZE:
                raise ValueError(f"corrupt stream: message size {size}")
            payload = self.f.read(size)
        dec = _DECODERS.get(msg_type)
        if dec is None:
            return msg_type, payload  # unknown type: raw passthrough
        return msg_type, dec.decode(payload)

    def close(self):
        if self._native is not None:
            self._native = None   # the native reader closes its file when freed
        else:
            self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
