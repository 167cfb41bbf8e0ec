"""One run of one cell: set-up, the window, the traced slice, the metrics,
and the reference's verdict. run.py prints what ``run_cell`` returns;
calibrate.py calls it over many seeds in one process."""
from __future__ import annotations

import gc
import math
import subprocess
import time
from types import SimpleNamespace

import torch

from . import harness, trace
from .reference.compare import compare


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo (a copy of the port's
    eval/bench_point.py::cpu_model); where the name reads "unknown", its
    vendor, family and model numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name and name != "unknown":
        return name
    if "vendor_id" in info:
        return (f"{info['vendor_id']} family {info.get('cpu family', '?')} model "
                f"{info.get('model', '?')} (model name {name!r})")
    import platform

    return platform.processor() or "unknown CPU"


def card_power_limit() -> str:
    """`nvidia-smi --query-gpu=power.limit` of the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            return lines[0].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown (nvidia-smi unavailable)"


def merged(*dicts) -> dict:
    out = {}
    for d in dicts:
        for name, targets in d.items():
            lst = out.setdefault(name, [])
            lst.extend(t for t in targets if t not in lst)
    return out


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool, t0: float,
             device="cuda", after_setup=None, limits=None) -> dict:
    """One run; returns the result's fields plus `numbers` (every number of
    the comparison), `marks` (seconds since `t0`, the process start on
    the host clock, at each phase) and, traced, `ms_per_frame` (the window's
    and each profiled slice's host ms per frame). `after_setup` (the tests' faults) is
    called with the session before the window; `limits` (the tests' small
    sizes) replaces the cell's limits file."""
    bench, cell, cfg, traffic = harness.load_cell(root, workload)
    entries = harness.cell_metrics(bench, cell, traced)
    readers = {m["name"]: harness.load_metric(m["name"]) for m in entries}
    device = torch.device(device)

    marks = {"start": time.perf_counter() - t0}
    session = harness.Session(cfg, traffic, seed, device)
    marks["lap_rendered"] = time.perf_counter() - t0
    session.set_up()
    if after_setup is not None:
        after_setup(session)
    tracer = None
    if traced:
        spans = merged(*(getattr(r, "SPANS", {}) for r in readers.values()), harness.LABEL_SPANS)
        calls = merged(*(getattr(r, "CALLS", {}) for r in readers.values()))
        tracer = harness.Tracer(spans, calls)
        tracer.timing = True
    session.sync()
    setup_s = time.perf_counter() - t0
    t_start, t_close = session.window(seconds)
    if tracer is not None:
        tracer.timing = False
    session.wait_results()
    marks["window_closed"], marks["results_in"] = t_close - t0, time.perf_counter() - t0

    summary, ms_per_frame = None, {}
    if tracer is not None:
        n = int(traffic["trace_frames"])
        tracer.recording = True
        with trace.profiled(cpu=False) as prof:
            session.sync()
            t_slice = time.perf_counter()
            for _ in range(n):
                session.feed(window=False)
            session.sync()
            t_slice = time.perf_counter() - t_slice
        tracer.recording = False
        summary = dict(trace.device_time(trace.profiler_events(prof), t_slice), frames=n)
        marks["slice_traced"] = time.perf_counter() - t0
        tracer.profiling = True
        with trace.profiled(cpu=True) as prof:
            with torch.profiler.record_function(trace.SLICE):
                for _ in range(n):
                    session.feed(window=False)
                session.sync()
        tracer.profiling = False
        labelled = trace.reduce_events(trace.profiler_events(prof), list(spans) + [trace.SLICE])
        summary["gaps"] = labelled["gaps"] if labelled else {}
        marks["slice_labelled"] = time.perf_counter() - t0
        ms_per_frame = {"window": 1e3 * (t_close - t_start) / max(len(session.window_frames()), 1),
                        "device_slice": 1e3 * t_slice / n}
        if labelled:
            ms_per_frame["labelled_slice"] = 1e3 * labelled["window_s"] / n
    session.sync()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    wf = session.window_frames()
    t_wait_end = time.perf_counter()
    run = SimpleNamespace(
        attempted=len(wf), window_s=t_close - t_start, setup_s=setup_s,
        tracked_in_window=harness.tracked_between(session.frames, t_start, t_close),
        latencies_s=[(f.t_out if f.t_out is not None else t_wait_end) - f.t_in for f in wf],
        spans={k: tuple(v) for k, v in tracer.totals.items()} if tracer else {},
        calls=tracer.calls if tracer else {}, trace=summary,
    )
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(1 for f in wf if not (f.result and f.result.valid))

    outputs = session.outputs()
    intr = session.intr
    if tracer is not None:
        tracer.remove()
    session.close()
    del session, run, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    marks["metrics_read"] = time.perf_counter() - t0
    numbers = compare(outputs, cfg, intr, seed)
    marks["compared"] = time.perf_counter() - t0
    limits = harness.load_limits(workload) if limits is None else limits
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else cpu_model(),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
           "power_limit": card_power_limit() if device.type == "cuda" else None,
           "host_cpu": cpu_model()}
    result = {"correct": correct, "attempted": len(wf), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": trace.top(summary["kernel_s"]),
                               "idle_gaps": trace.top(summary["gaps"])}
    result["checks"] = checks
    result["numbers"] = numbers
    result["marks"] = marks
    result["ms_per_frame"] = ms_per_frame
    return result
