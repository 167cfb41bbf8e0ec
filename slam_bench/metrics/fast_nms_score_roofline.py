"""fast_nms_score_roofline (%): the least time the FAST+NMS score kernel
(csrc/fast_nms.cu, ``fast_kernel<false>``) could take on the traced
slice's launches (slam_bench/roofline.py), over the profiler's time of that
kernel."""
from slam_bench import roofline

CALLS = {"fast_nms_score": ["lpslam_tpu_torch.kernels.fast_nms:launch_score"]}
KERNEL = "fast_kernel<false>"


def read(run):
    calls = run.calls["fast_nms_score"]
    spent = sum(s for name, s in (run.trace or {}).get("kernel_s", {}).items() if KERNEL in name)
    if not calls or spent <= 0:
        return None
    least = sum(roofline.fast_score_bound_s(a[0], a[3], a[4]) for a, _ in calls)
    return 100.0 * least / spent
