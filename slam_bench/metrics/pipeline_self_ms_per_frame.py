"""pipeline_self_ms_per_frame (ms): host time in
pipeline/trackers.py::VSLAMTracker.process_image outside its engine calls
(the chunk driver and the engine's per-frame process): buffering,
stacking, draining and converting results, per frame of the window."""
SPANS = {
    "process_image": ["lpslam_tpu_torch.pipeline.trackers:VSLAMTracker.process_image"],
    "process_chunk": ["lpslam_tpu_torch.frontend.device_loop:ChunkedTracker.process_chunk"],
    "engine_process": ["lpslam_tpu_torch.frontend.tracker:MonoTracker.process",
                       "lpslam_tpu_torch.frontend.stereo:StereoTracker.process"],
}


def read(run):
    s = run.spans
    if not s["process_image"][1]:
        return None
    own = s["process_image"][0] - s["process_chunk"][0] - s["engine_process"][0]
    return own * 1e3 / run.attempted
