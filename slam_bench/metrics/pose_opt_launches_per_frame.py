"""pose_opt_launches_per_frame (count): the host's kernel launches (CUDA
runtime and driver launch calls) of the slice that the profiler records
with CUDA activity alone whose interval lies inside one of the program's
frontend/pose_opt.py::pose_only_optimize spans, per frame of the slice
(slam_bench/program_trace.py: the spans and the records share the
profiler's clock)."""
from slam_bench import program_trace


def read(run):
    cap = program_trace.CAPTURE
    frames = cap.frames_in(cap.slice)
    launches = cap.calls(program_trace.LAUNCH)
    spans = cap.spans("pose_only_optimize", cap.slice)
    if not frames or not launches or not spans:
        return None
    return program_trace.count_inside(launches, spans) / frames
