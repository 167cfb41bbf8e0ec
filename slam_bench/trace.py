"""The device trace of a traced run: torch.profiler over slices of frames,
read in memory (a copy of the port's ``utils/timing.py::device_trace``
method, without the trace file). A slice that records CUDA activity alone
gives the device's busy time and kernel time by name; recording the host's
operations as well slows a host-bound loop markedly, so a second
slice, with CPU activity and the harness's spans as ranges, only labels
the device's idle gaps by the span the host was in.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np

SLICE = "profiled_slice"


@contextmanager
def profiled(cpu: bool):
    """torch.profiler over the card, and with `cpu` (or without a card, as
    in the CPU tests) over the host's operations too; a `cpu` slice is
    wrapped in ``record_function(SLICE)`` by the caller."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu = cpu or not torch.cuda.is_available()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        yield prof


def device_time(events, window_s: float) -> dict:
    """events: (name, is_device, start_us, end_us) of a slice that recorded
    CUDA activity alone, `window_s` its host-clock length (the card synced
    at both ends). Returns busy_s (the union of the device intervals),
    window_s and kernel_s {name: seconds}."""
    kernel_s, intervals = {}, []
    for name, is_device, s, e in events:
        if is_device and e > s:
            key = without_arguments(name)
            kernel_s[key] = kernel_s.get(key, 0.0) + (e - s) / 1e6
            intervals.append((s, e))
    return {"busy_s": sum(e - s for s, e in merge(intervals)) / 1e6, "window_s": window_s,
            "kernel_s": kernel_s}


def merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, span_names) -> dict:
    """events: (name, is_device, start_us, end_us). Returns busy_s,
    window_s (the SLICE range), kernel_s {name: seconds}, gaps {label:
    seconds}: idle time by the innermost span that covers the gap's middle
    ("no span" where none does)."""
    span_names = set(span_names)
    device, spans, window = [], [], None
    for name, is_device, s, e in events:
        if is_device:
            if name not in span_names and name != SLICE:    # skip the GPU copies of ranges
                device.append((name, s, e))
        elif name == SLICE:
            window = (s, e)
        elif name in span_names:
            spans.append((s, e, name))
    if window is None:
        return None
    w0, w1 = window
    kernel_s, clipped = {}, []
    for name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            key = without_arguments(name)
            kernel_s[key] = kernel_s.get(key, 0.0) + (e - s) / 1e6
            clipped.append((s, e))
    busy = merge(clipped)
    ss = np.array([x[0] for x in spans], np.float64)
    se = np.array([x[1] for x in spans], np.float64)
    names = [x[2] for x in spans]
    gaps, prev = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            cover = np.flatnonzero((ss <= mid) & (se >= mid))
            label = names[cover[np.argmin(se[cover] - ss[cover])]] if len(cover) else "no span"
            gaps[label] = gaps.get(label, 0.0) + (s - prev) / 1e6
        prev = max(prev, e)
    return {"busy_s": sum(e - s for s, e in busy) / 1e6, "window_s": (w1 - w0) / 1e6,
            "kernel_s": kernel_s, "gaps": gaps}


def without_arguments(name: str) -> str:
    """A kernel's name without its trailing argument list: "void
    (anonymous namespace)::k<false>(float const*, int)" -> "void
    (anonymous namespace)::k<false>"."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip()
    return name


def profiler_events(prof):
    """(name, is_device, start_us, end_us) of every event the profiler kept,
    read from its raw results (building its FunctionEvents takes tens of
    seconds for a slice)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
