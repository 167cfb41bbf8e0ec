"""result_hold_ms_p95 (ms): the 95th percentile, over the frames handed in
during the window, of how long a computed pose waits to be returned: from
the program's `pose` stamp (the chunk loop's step for the frame returned,
or the host path's engine.process) to its `out` stamp (the return of the
pipeline/trackers.py::VSLAMTracker call that hands out its result)
(slam_bench/program_trace.py)."""
import numpy as np

from slam_bench import program_trace


def read(run):
    cap = program_trace.CAPTURE
    if not cap.ready():
        return None
    a, b = cap.window
    held = [(k["out"] - k["pose"]) / 1e6 for k in cap.stamps().values()
            if "pose" in k and "out" in k and a <= k.get("in", a - 1) <= b]
    return float(np.percentile(held, 95)) if held else None
