"""chunk_step_ms_per_frame (ms): host time in
frontend/device_loop.py::ChunkedTracker.process_chunk (upload, remap,
batched extraction and the per-frame step, boundary compaction), per frame
of the window."""
SPANS = {"process_chunk": ["lpslam_tpu_torch.frontend.device_loop:ChunkedTracker.process_chunk"]}


def read(run):
    total, count = run.spans["process_chunk"]
    return total * 1e3 / run.attempted if count else None
