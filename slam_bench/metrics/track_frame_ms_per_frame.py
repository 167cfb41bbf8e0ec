"""track_frame_ms_per_frame (ms): host time in frontend/tracker.py::track_frame
(projection, the fused matcher, frontend/pose_opt.py's two pose
optimizations), as the chunk loop and the host path call it, per frame of
the window."""
SPANS = {"track_frame": ["lpslam_tpu_torch.frontend.device_loop:track_frame",
                         "lpslam_tpu_torch.frontend.tracker:track_frame"]}


def read(run):
    total, count = run.spans["track_frame"]
    return total * 1e3 / run.attempted if count else None
