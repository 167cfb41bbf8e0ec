"""keyframes_per_100_frames (count): keyframes inserted in the window
(calls of frontend/tracker.py::insert_keyframe and
frontend/stereo.py::insert_keyframe_depth, from the chunk loop or the
host path), per 100 frames handed in."""
SPANS = {"insert_keyframe": ["lpslam_tpu_torch.frontend.device_loop:insert_keyframe",
                             "lpslam_tpu_torch.frontend.device_loop:insert_keyframe_depth",
                             "lpslam_tpu_torch.frontend.tracker:insert_keyframe",
                             "lpslam_tpu_torch.frontend.stereo:insert_keyframe_depth"]}


def read(run):
    return 100.0 * run.spans["insert_keyframe"][1] / run.attempted
