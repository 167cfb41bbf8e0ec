"""host_path_ms_per_frame (ms): host time in the engine's per-frame host
path, frontend/tracker.py::MonoTracker.process (StereoTracker.process for
stereo), per frame of the window."""
SPANS = {"engine_process": ["lpslam_tpu_torch.frontend.tracker:MonoTracker.process",
                            "lpslam_tpu_torch.frontend.stereo:StereoTracker.process"]}


def read(run):
    total, count = run.spans["engine_process"]
    return total * 1e3 / run.attempted if count else None
