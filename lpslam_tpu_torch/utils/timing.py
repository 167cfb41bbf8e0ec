"""Scoped timing and statistics (port of lpslam_tpu/utils/timing.py), with a
torch.profiler scope for device traces.

``ScopeTimer`` reads the host clock and never synchronizes the device: a
caller that wants device time synchronizes around the scope itself.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from contextlib import contextmanager

log = logging.getLogger("lpslam.timing")


class TimingStats:
    """Accumulates named timings; report() logs mean and max."""

    def __init__(self):
        self._sums = defaultdict(float)
        self._maxs = defaultdict(float)
        self._counts = defaultdict(int)

    def add(self, name: str, dt: float):
        self._sums[name] += dt
        self._maxs[name] = max(self._maxs[name], dt)
        self._counts[name] += 1

    def report(self):
        for name, total in self._sums.items():
            n = self._counts[name]
            log.info(
                "%s: mean %.2f ms, max %.2f ms over %d calls",
                name, 1e3 * total / max(n, 1), 1e3 * self._maxs[name], n,
            )

    def mean(self, name: str) -> float:
        n = self._counts[name]
        return self._sums[name] / n if n else 0.0


GLOBAL_STATS = TimingStats()


@contextmanager
def ScopeTimer(name: str, stats: TimingStats = GLOBAL_STATS):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.add(name, time.perf_counter() - t0)


@contextmanager
def device_trace(logdir: str):
    """torch.profiler scope over the CPU and, when present, the card; the
    trace goes to `logdir` as a TensorBoard/chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
