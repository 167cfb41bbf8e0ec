"""device_idle_pct (%): the share of the window's host time per frame in
which no operation ran on the card. The device's busy time per frame is
the union of the device intervals of a profiler that records CUDA activity
alone, over the traced slice's frames; it is set against the untraced
window's time per frame, since the profiler slows the host-bound loop
(by about half in these cells) and not the device's work."""


def read(run):
    t = run.trace
    if not t or not t.get("frames") or not run.attempted or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["frames"]) / (run.window_s / run.attempted))
