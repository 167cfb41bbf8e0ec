"""The program's own tracing (``lpslam_tpu_torch/utils/timing.py``) in a
traced run, for the metrics that read it (pose_opt_ms_per_frame,
pose_opt_launches_per_frame, host_syncs_per_frame, result_hold_ms_p95).

A traced run (``cell.run_cell`` with trace) switches the harness's
``Tracer`` on for the window (``timing``) and for the slice that the
profiler records with CUDA activity alone (``recording``). Importing this
module, which those readers do when the run loads them, puts
``ProgramTracer`` in the harness's place: the same tracer, whose two
switches also switch the program's tracing on at the window's start and
off after that slice, and note both intervals on the program's clock. The
slice's profiler events are kept from the harness's own
``trace.profiler_events`` call: the host's runtime and driver calls, which
``trace.device_time`` leaves out, on the profiler's clock, which is the
program's. Nothing else of the harness changes; a run without trace loads
no per-layer reader, so the program's tracing stays off.

Where the program has no tracing (``timing.enable`` missing), nothing is
switched and every reader returns None.
"""
from __future__ import annotations

import bisect
import re

from slam_bench import harness, trace

# host calls that put work on the card's queue
LAUNCH = re.compile(r"LaunchKernel|LaunchCooperativeKernel|GraphLaunch")
# host calls that wait for the card: synchronize, and the blocking copy
SYNC = re.compile(r"^(cuda|cu)(Stream|Device|Ctx|Event)Synchronize|^cudaMemcpy$|^cuMemcpyDtoH")
# the program's per-frame spans: the chunk loop's step and boundary, the host path
FRAME_SPANS = ("chunk_frame", "chunk_boundary", "engine_process")


def program_timing():
    """The program's tracing module, or None where it has no tracing."""
    try:
        from lpslam_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "enable") and hasattr(timing, "snapshot") else None


class Capture:
    """What one traced run's program tracing gave: the snapshot, the window
    and the CUDA-only slice as (start_ns, end_ns) on the program's clock,
    and the slice's host-side profiler records (name, start_ns, end_ns)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.snapshot = self.window = self.slice = self.records = None
        self._awaiting_records = False

    def ready(self) -> bool:
        return self.snapshot is not None and self.window is not None

    def spans(self, name: str, interval) -> list:
        """(start, end) of the closed spans `name` that start inside `interval`."""
        if not self.ready() or interval is None:
            return []
        a, b = interval
        return [(s0, s1) for n, s0, s1, _, _ in self.snapshot["spans"]
                if n == name and s1 is not None and a <= s0 <= b]

    def frames_in(self, interval) -> int:
        """Frames handed to the tracker inside `interval`."""
        if not self.ready() or interval is None:
            return 0
        a, b = interval
        return sum(1 for _, kind, t in self.snapshot["stamps"] if kind == "in" and a <= t <= b)

    def stamps(self) -> dict:
        """{frame: {kind: t_ns}}."""
        out = {}
        for fid, kind, t in (self.snapshot or {}).get("stamps", ()):
            out.setdefault(fid, {})[kind] = t
        return out

    def calls(self, pattern) -> list:
        """The slice's host records whose name matches `pattern`."""
        return [r for r in self.records or () if pattern.search(r[0])]


CAPTURE = Capture()


def count_inside(records, intervals) -> int:
    """Records (name, start, end) that lie inside one of the intervals."""
    merged = trace.merge(intervals)
    starts = [s for s, _ in merged]
    n = 0
    for _, s, e in records:
        i = bisect.bisect_right(starts, s) - 1
        n += i >= 0 and e <= merged[i][1]
    return n


def host_records(prof) -> list:
    """(name, start_ns, end_ns) of every event the profiler kept that is not
    a device event: the runtime and driver calls (and, where CPU activity
    was traced, the host's operators)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CUDA]


class ProgramTracer(harness.Tracer):
    """harness.Tracer whose window and CUDA-only slice switches also switch
    the program's tracing (see the module's docstring)."""

    @property
    def timing(self):
        return getattr(self, "_timing", False)

    @timing.setter
    def timing(self, on):
        was, self._timing = self.timing, bool(on)
        tm = program_timing()
        if tm is None or was == self._timing:
            return
        if self._timing:
            CAPTURE.clear()
            tm.reset()
            tm.enable()
            self._window_start = tm.now_ns()
        else:
            CAPTURE.window = (self._window_start, tm.now_ns())

    @property
    def recording(self):
        return getattr(self, "_recording", False)

    @recording.setter
    def recording(self, on):
        was, self._recording = self.recording, bool(on)
        tm = program_timing()
        if tm is None or was == self._recording or not tm.ENABLED:
            return
        if self._recording:
            self._slice_start = tm.now_ns()
        else:
            CAPTURE.slice = (self._slice_start, tm.now_ns())
            tm.disable()
            CAPTURE.snapshot = tm.snapshot()
            tm.reset()
            CAPTURE._awaiting_records = True

    def remove(self):
        tm = program_timing()
        if tm is not None and (self.timing or self.recording):
            tm.disable()
        super().remove()


def _keeping_records(profiler_events):
    def wrapped(prof):
        if CAPTURE._awaiting_records:
            CAPTURE._awaiting_records = False
            CAPTURE.records = host_records(prof)
        return profiler_events(prof)
    wrapped.keeps_records = True
    return wrapped


def install():
    """Put ProgramTracer in the harness's place and keep the next slice's
    records; once per process."""
    if harness.Tracer is not ProgramTracer:
        harness.Tracer = ProgramTracer
    if not getattr(trace.profiler_events, "keeps_records", False):
        trace.profiler_events = _keeping_records(trace.profiler_events)


install()
