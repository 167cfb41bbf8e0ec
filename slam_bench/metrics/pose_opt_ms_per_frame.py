"""pose_opt_ms_per_frame (ms): host time in frontend/pose_opt.py::pose_only_optimize
(two calls a frame inside track_frame), from the program's own spans
(slam_bench/program_trace.py) that start inside the window, per frame of
the window."""
from slam_bench import program_trace


def read(run):
    cap = program_trace.CAPTURE
    spans = cap.spans("pose_only_optimize", cap.window)
    if not spans or not run.attempted:
        return None
    return sum(e - s for s, e in spans) / 1e6 / run.attempted
