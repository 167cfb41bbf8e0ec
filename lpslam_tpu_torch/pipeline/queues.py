"""Bounded queues and managed worker threads, the pipeline's plumbing (port
of lpslam_tpu/pipeline/queues.py).

``BoundedQueue`` is the stdlib-backed queue: a full queue drops its oldest
entry on ``push``, so a source that outruns the tracker loses frames.
``ManagedThread`` runs a function in a loop until stopped; an exception in
an iteration is logged and kept in ``error`` (the manager's status shows it)
and the loop goes on.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

_log = logging.getLogger("lpslam_tpu_torch")


@dataclass
class CameraQueueEntry:
    """A mono or stereo frame with optional navigation states."""

    timestamp: float
    image: np.ndarray
    image_second: Optional[np.ndarray] = None
    camera_number: int = 0
    state_odom: Optional[object] = None
    state_map: Optional[object] = None
    ros_timestamp: Optional[int] = None
    aux: Any = None      # depth map for RGB-D sources
    valid: bool = True   # False = shutdown sentinel


@dataclass
class SensorQueueEntry:
    """Tagged union: imu | global_state | features."""

    timestamp: float
    kind: str                      # "imu" | "global_state" | "features"
    acc: Optional[np.ndarray] = None
    gyro: Optional[np.ndarray] = None
    state: Optional[object] = None
    reference: bool = False
    features: Optional[list] = None


@dataclass
class ResultQueueEntry:
    timestamp: float
    position: np.ndarray
    orientation_wxyz: np.ndarray
    valid: bool
    raw: Any = None
    # lpslam-frame position std-devs and scalar rotation std-dev [rad]
    position_sigma: np.ndarray = None
    orientation_sigma: float = 0.0

    def __post_init__(self):
        if self.position_sigma is None:
            self.position_sigma = np.zeros(3)


class PyBoundedQueue(queue.Queue):
    """Bounded queue whose ``push`` drops the oldest entry when full."""

    def __init__(self, maxsize: int = 32):
        super().__init__(maxsize=maxsize)

    def push(self, item, drop_oldest: bool = True):
        try:
            self.put_nowait(item)
        except queue.Full:
            if drop_oldest:
                try:
                    self.get_nowait()
                except queue.Empty:
                    pass
                try:
                    self.put_nowait(item)
                except queue.Full:
                    pass
            else:
                self.put(item)

    def pop(self, timeout: Optional[float] = None):
        try:
            return self.get(timeout=timeout)
        except queue.Empty:
            return None


# the pipeline's queue: the stdlib-backed one (the port has no native queue)
BoundedQueue = PyBoundedQueue


class ManagedThread:
    """Run `fn(thread)` in a loop on a daemon thread until stopped."""

    def __init__(self, fn: Callable[["ManagedThread"], None], name: str = "worker"):
        self._fn = fn
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the last exception an iteration raised, and how many there were
        self.error: Optional[BaseException] = None
        self.error_count: int = 0

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self._fn(self)
                except Exception as exc:  # noqa: BLE001 — the worker must survive
                    self.error = exc
                    self.error_count += 1
                    if self.error_count <= 3:
                        _log.exception("worker '%s' iteration failed", self._name)
                    elif self.error_count % 100 == 0:
                        _log.error(
                            "worker '%s' still failing (%d errors): %r",
                            self._name, self.error_count, exc,
                        )
                    time.sleep(0.01)  # no hot spin on a persistent failure

        self._thread = threading.Thread(target=loop, name=self._name, daemon=True)
        self._thread.start()

    def stop(self, join_timeout: float = 5.0) -> bool:
        """Signal the loop and join; True when the thread exited in time."""
        self._stop.set()
        if self._thread is not None:
            t = self._thread
            t.join(timeout=join_timeout)
            if t.is_alive():
                return False
            self._thread = None
        return True

    def stop_async(self):
        self._stop.set()


class FramerateCompute:
    """Sliding-window frame rate over the last `window` ticks."""

    def __init__(self, window: int = 10):
        self._times: list = []
        self._window = window

    def tick(self):
        now = time.monotonic()
        self._times.append(now)
        if len(self._times) > self._window:
            self._times.pop(0)

    @property
    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0
