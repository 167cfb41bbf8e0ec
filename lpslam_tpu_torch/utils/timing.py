"""The port's tracing and scoped timing (grown from the port of
lpslam_tpu/utils/timing.py).

``span(name, frame=None)`` marks a piece of the program's work. Tracing is
off by default: a span then costs one check of the module flag ``ENABLED``
and returns a shared no-op, with no clock read and no allocation. Between
``enable()`` and ``disable()`` each span records ``(name, start_ns, end_ns,
parent, frame)`` in a bounded buffer in memory (``parent`` is the index of
the enclosing span of the same thread in that buffer, -1 for none; ``frame``
is the engine's frame id, inherited from the enclosing span when not given)
and adds its duration to per-name totals (sum, count, max). A span opened
directly inside one of the same name (``StereoTracker.process`` calling
``MonoTracker.process``) counts once, as the outer one. ``stamp(frame,
kind)`` records a frame's passage: ``in`` (handed to the tracker), ``pose``
(its pose computed), ``out`` (its result handed back). ``snapshot()``
returns what was recorded; nothing is written to disk.

The clock is the one ``torch.profiler`` stamps its events with (Unix-epoch
nanoseconds): ``perf_counter_ns`` plus one offset to ``time_ns`` taken at
``enable()``. So the spans line up with a profiler trace of the same
interval, its kernels and runtime calls included, with no CPU activity
traced. Spans open no profiler range and never synchronize the device: a
span around asynchronous work times its enqueue.

``ScopeTimer(name, stats)`` with an explicit ``TimingStats`` times into it
whether tracing is on or off (and records a span as well while it is on);
without ``stats`` it is ``span(name)``.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict

log = logging.getLogger("lpslam.timing")

# tracing on; read as ``timing.ENABLED`` (a module attribute), never imported by value
ENABLED = False
# the buffer's bounds: past them, spans and stamps are counted as dropped
MAX_SPANS = 1 << 20
MAX_STAMPS = 1 << 18
FRAME_KINDS = ("in", "pose", "out")


class TimingStats:
    """Accumulates named timings; report() logs mean and max."""

    def __init__(self):
        self.reset()

    def reset(self):
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

    def totals(self) -> dict:
        """{name: (sum s, count, max s)}."""
        return {k: (self._sums[k], self._counts[k], self._maxs[k]) for k in self._sums}


class _Recorder:
    """What tracing records between enable() and disable()."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()   # per thread: the stack of open spans
        self.offset_ns = 0
        self.generation = 0
        self.reset()

    def reset(self):
        with self.lock:
            self.generation += 1         # spans open across a reset are not recorded
            self.spans: list = []        # [name, start_ns, end_ns, parent, frame]
            self.stamps: list = []       # (frame, kind, t_ns)
            self.stats = TimingStats()
            self.dropped_spans = self.dropped_stamps = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, sp) -> None:
        """Push `sp` on this thread's stack and give it a row."""
        st = self.stack()
        parent = st[-1] if st else None
        if sp.frame is None and parent is not None:
            sp.frame = parent.frame
        st.append(sp)
        with self.lock:
            sp.generation = self.generation
            if len(self.spans) >= MAX_SPANS:
                self.dropped_spans += 1
                return
            up = -1
            if parent is not None and parent.slot is not None \
                    and parent.generation == self.generation:
                up = parent.slot
            sp.slot = len(self.spans)
            self.spans.append([sp.name, None, None, up, sp.frame])

    def close(self, sp, t0: int, t1: int) -> None:
        st = self.stack()
        if st and st[-1] is sp:
            st.pop()
        with self.lock:
            if sp.generation != self.generation:
                return
            if sp.slot is not None:
                row = self.spans[sp.slot]
                row[1], row[2] = t0 + self.offset_ns, t1 + self.offset_ns
            self.stats.add(sp.name, (t1 - t0) * 1e-9)


_REC = _Recorder()


def _unix_offset_ns() -> int:
    """time_ns() - perf_counter_ns(), from the closest of a few paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


def now_ns() -> int:
    """The tracing clock (Unix-epoch ns, the profiler's) as of the last enable()."""
    return time.perf_counter_ns() + _REC.offset_ns


def enable() -> None:
    global ENABLED
    _REC.offset_ns = _unix_offset_ns()
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def reset() -> None:
    """Forget every span, stamp and total recorded so far."""
    _REC.reset()


def snapshot() -> dict:
    """What tracing recorded, as plain data: spans [(name, start_ns,
    end_ns, parent, frame)] in the order they opened (end_ns None while
    open), stamps [(frame, kind, t_ns)], totals {name: (sum s, count,
    max s)} and how many of each the bounded buffer dropped."""
    with _REC.lock:
        return {
            "clock": "unix_ns",
            "spans": [tuple(s) for s in _REC.spans],
            "stamps": list(_REC.stamps),
            "totals": _REC.stats.totals(),
            "dropped": {"spans": _REC.dropped_spans, "stamps": _REC.dropped_stamps},
        }


class _Span:
    __slots__ = ("name", "frame", "stats", "t0", "slot", "generation", "traced")

    def __init__(self, name: str, frame=None, stats: TimingStats = None):
        self.name, self.frame, self.stats = name, frame, stats
        self.slot = self.generation = None
        self.traced = False

    def __enter__(self):
        if ENABLED:
            st = _REC.stack()
            # directly inside a span of its name: counts once, as the outer
            if not (st and st[-1].name == self.name):
                self.traced = True
                _REC.open(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self.stats is not None:
            self.stats.add(self.name, (t1 - self.t0) * 1e-9)
        if self.traced:
            _REC.close(self, self.t0, t1)
        return False


class _NoSpan:
    # no __slots__ and a fixed-arity __exit__: the cheapest `with` CPython 3.12 runs
    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()


def span(name: str, frame=None):
    """A context manager that records `name` while tracing is on (see the
    module's docstring); frame: the engine's frame id, else the enclosing
    span's."""
    if not ENABLED:
        return _NO_SPAN
    return _Span(name, frame)


def stamp(frame: int, kind: str) -> None:
    """Record that frame `frame` passed point `kind` (one of FRAME_KINDS)."""
    if not ENABLED:
        return
    t = time.perf_counter_ns() + _REC.offset_ns
    with _REC.lock:
        if len(_REC.stamps) < MAX_STAMPS:
            _REC.stamps.append((frame, kind, t))
        else:
            _REC.dropped_stamps += 1


def ScopeTimer(name: str, stats: TimingStats = None):
    """Time a scope into `stats` whatever tracing's state; without `stats`,
    span(name)."""
    if stats is None:
        return span(name)
    return _Span(name, stats=stats)
