"""local_ba_ms_per_frame (ms): host time in backend/ba.py::local_ba, per
frame of the window."""
SPANS = {"local_ba": ["lpslam_tpu_torch.backend.ba:local_ba"]}


def read(run):
    total, count = run.spans["local_ba"]
    return total * 1e3 / run.attempted if count else None
