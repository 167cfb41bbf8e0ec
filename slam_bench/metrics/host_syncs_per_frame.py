"""host_syncs_per_frame (count): the host's waits for the card (stream,
device and event synchronize, blocking copies) in the slice that the
profiler records with CUDA activity alone, inside the program's per-frame
spans: the chunk loop's step (chunk_frame) and boundary (chunk_boundary:
the cull, sync and drain), the host path's engine_process; per frame of
the slice (slam_bench/program_trace.py)."""
from slam_bench import program_trace


def read(run):
    cap = program_trace.CAPTURE
    frames = cap.frames_in(cap.slice)
    if not frames or not cap.calls(program_trace.LAUNCH):
        return None      # no runtime records in the slice: nothing to read
    spans = [s for name in program_trace.FRAME_SPANS for s in cap.spans(name, cap.slice)]
    if not spans:
        return None
    return program_trace.count_inside(cap.calls(program_trace.SYNC), spans) / frames
