"""ZED HID sensor stream, the zed-open-capture SensorCapture equivalent (a
copy of lpslam_tpu/pipeline/zed_hid.py, which the port cannot import; stdlib
and numpy only).

The camera's MCU sends 64-byte HID reports at 400 Hz: report 0x01 carries
IMU (gyro/accel int16), magnetometer, barometer and temperatures plus
frame-sync counters; the MCU timestamp ticks in units of 39062.5 ns and is
re-based onto the wall clock at the first valid sample; a ping report keeps
the stream alive about once per second.

The reader goes through the Linux hidraw interface directly: it enumerates
/sys/class/hidraw for the StereoLabs vendor id, reads packed reports,
decodes them with the sensor's wire scales, and publishes
SensorQueueEntry(kind="imu") on the pipeline's sensor queue, which feeds the
same nav-prior path as the synthetic and replay IMU sources. Tests inject a
file-like device double.

The wire constants (report ids, field layout, LSB scales) are the camera's
USB protocol and must stay verbatim.
"""
from __future__ import annotations

import glob
import os
import struct
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .queues import SensorQueueEntry, ManagedThread

SL_USB_VENDOR = 0x2B03
REP_ID_SENSOR_DATA = 0x01
REP_ID_REQUEST_SET = 0x21
RQ_CMD_PING = 0xF2

TS_SCALE_NS = 39062.5              # MCU timestamp tick
GRAVITY = 9.8189
ACC_SCALE = GRAVITY * 8.0 / 32768.0          # m/s^2 per LSB
GYRO_SCALE = 1000.0 / 32768.0                # deg/s per LSB
MAG_SCALE = 1.0 / 16.0                       # uT per LSB
TEMP_SCALE = 0.01                            # degC per LSB
PRESS_SCALE = 0.01                           # hPa per LSB
HUMID_SCALE = 1.0 / 1024.0                   # %rH per LSB

# RawData, packed little-endian (sensorcapture_def.hpp:70-97)
_RAW = struct.Struct("<BBQ3h3hBBIhB3hBIBIBhIIhh")


@dataclass
class ZedSensorSample:
    """One decoded MCU report (SensImuData/SensMagData/SensEnvData union)."""

    timestamp: float               # seconds, wall-clock re-based
    imu_valid: bool
    acc: np.ndarray                # (3,) m/s^2
    gyro: np.ndarray               # (3,) deg/s
    mag_valid: bool
    mag: np.ndarray                # (3,) uT
    env_valid: bool
    pressure: float                # hPa
    humidity: float                # %rH
    temp: float                    # degC (environmental)
    temp_imu: float
    temp_cam_left: float
    temp_cam_right: float
    frame_sync: bool
    frame_sync_count: int


def decode_report(buf: bytes) -> Optional[dict]:
    """64-byte HID report -> raw fields dict, or None if not sensor data."""
    if len(buf) < _RAW.size or buf[0] != REP_ID_SENSOR_DATA:
        return None
    (sid, imu_not_valid, ts,
     gx, gy, gz, ax, ay, az,
     frame_sync, sync_cap, frame_sync_count,
     imu_temp, mag_valid, mx, my, mz,
     _moving, _moving_cnt, _falling, _falling_cnt,
     env_valid, temp, press, humid,
     t_left, t_right) = _RAW.unpack_from(buf)
    return dict(
        imu_valid=imu_not_valid != 1, mcu_ts=ts,
        gyro=(gx, gy, gz), acc=(ax, ay, az),
        frame_sync=frame_sync != 0, sync_cap=sync_cap,
        frame_sync_count=frame_sync_count,
        imu_temp=imu_temp, mag_valid=mag_valid == 1, mag=(mx, my, mz),
        env_valid=env_valid == 1, temp=temp, press=press, humid=humid,
        t_left=t_left, t_right=t_right,
    )


def enumerate_hid_devices() -> list:
    """hidraw nodes whose HID vendor id is StereoLabs (the role of
    SensorCapture::enumerateDevices, sensorcapture.cpp:58-100)."""
    out = []
    for uevent in glob.glob("/sys/class/hidraw/hidraw*/device/uevent"):
        try:
            text = open(uevent).read()
        except OSError:
            continue
        for line in text.splitlines():
            if line.startswith("HID_ID=") and f"{SL_USB_VENDOR:08X}" in line:
                node = uevent.split("/")[4]  # hidrawN
                out.append("/dev/" + node)
    return sorted(out)


class ZedSensorCapture:
    """400 Hz MCU sensor reader with wall-clock timestamp re-basing.

    device: file-like with read(n)->bytes and write(bytes) (injected double
    in tests); otherwise `path` or auto-enumeration opens a hidraw node.
    on_sample: callback receiving each ZedSensorSample; alternatively attach
    a sensor queue with `attach` and IMU samples are published as
    SensorQueueEntry(kind="imu") like the other IMU-bearing sources.
    """

    def __init__(self, device=None, path: Optional[str] = None,
                 on_sample: Optional[Callable] = None):
        self._dev = device
        self._path = path
        self._fd = None
        self.on_sample = on_sample
        self.sensor_queue = None
        self._worker: Optional[ManagedThread] = None
        # timestamp re-base state (sensorcapture.cpp:365-390)
        self._start_sys: Optional[float] = None
        self._last_mcu_ns: float = 0.0
        self._rel_ns: float = 0.0
        self._reads_since_ping = 0
        self.n_samples = 0

    # -- lifecycle ------------------------------------------------------

    def attach(self, sensor_queue) -> None:
        self.sensor_queue = sensor_queue

    def start(self) -> None:
        if self._dev is None:
            path = self._path
            if path is None:
                found = enumerate_hid_devices()
                if not found:
                    raise RuntimeError(
                        "no StereoLabs HID device found (vendor 0x2b03); "
                        "pass path=/dev/hidrawN or inject a device"
                    )
                path = found[0]
            self._fd = os.open(path, os.O_RDWR)
        self._worker = ManagedThread(self._loop, name="zed-sensors")
        self._worker.start()

    def stop(self) -> None:
        if self._worker is not None:
            self._worker.stop()
            self._worker = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    # -- capture loop -----------------------------------------------------

    def _read(self, n: int) -> bytes:
        if self._dev is not None:
            return self._dev.read(n) or b""
        return os.read(self._fd, n)

    def _write(self, data: bytes) -> None:
        try:
            if self._dev is not None:
                self._dev.write(data)
            else:
                os.write(self._fd, data)
        except OSError:
            pass  # ping is best-effort keep-alive

    def _loop(self, thread: ManagedThread) -> None:
        # keep-alive ping about once per second at the 400 Hz data rate
        # (sensorcapture.cpp:322-327)
        if self._reads_since_ping >= 400:
            self._reads_since_ping = 0
            self._write(bytes([REP_ID_REQUEST_SET, RQ_CMD_PING]))
        self._reads_since_ping += 1

        buf = self._read(64)
        if not buf:
            time.sleep(0.002)
            return
        raw = decode_report(buf)
        if raw is None:
            return
        ts = self._rebase(raw)
        if ts is None:
            return  # first valid sample only anchors the clock
        sample = ZedSensorSample(
            timestamp=ts,
            imu_valid=raw["imu_valid"],
            acc=np.asarray(raw["acc"], np.float32) * ACC_SCALE,
            gyro=np.asarray(raw["gyro"], np.float32) * GYRO_SCALE,
            mag_valid=raw["mag_valid"],
            mag=np.asarray(raw["mag"], np.float32) * MAG_SCALE,
            env_valid=raw["env_valid"],
            pressure=raw["press"] * PRESS_SCALE,
            humidity=raw["humid"] * HUMID_SCALE,
            temp=raw["temp"] * TEMP_SCALE,
            temp_imu=raw["imu_temp"] * TEMP_SCALE,
            temp_cam_left=raw["t_left"] * TEMP_SCALE,
            temp_cam_right=raw["t_right"] * TEMP_SCALE,
            frame_sync=raw["frame_sync"],
            frame_sync_count=raw["frame_sync_count"],
        )
        self.n_samples += 1
        if self.on_sample is not None:
            self.on_sample(sample)
        if self.sensor_queue is not None and sample.imu_valid:
            self.sensor_queue.push(SensorQueueEntry(
                timestamp=sample.timestamp, kind="imu",
                acc=sample.acc, gyro=sample.gyro,
            ))

    def _rebase(self, raw: dict) -> Optional[float]:
        """MCU tick -> wall-clock seconds: anchor the first valid sample to
        the system clock, then advance by MCU deltas (the driver's
        drift-tolerant scheme, sensorcapture.cpp:365-390)."""
        mcu_ns = raw["mcu_ts"] * TS_SCALE_NS
        if self._start_sys is None:
            if not raw["imu_valid"]:
                return None
            self._start_sys = time.time()
            self._last_mcu_ns = mcu_ns
            self._rel_ns = 0.0
            return None
        self._rel_ns += mcu_ns - self._last_mcu_ns
        self._last_mcu_ns = mcu_ns
        return self._start_sys + self._rel_ns * 1e-9
