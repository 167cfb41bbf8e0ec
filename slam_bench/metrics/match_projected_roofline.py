"""match_projected_roofline (%): the least time the fused projected matcher
(csrc/hamming.cu, ``match_projected_kernel``) could take on the traced
slice's launches (slam_bench/roofline.py), over the profiler's time of
that kernel."""
from slam_bench import roofline

CALLS = {"match_projected": ["lpslam_tpu_torch.kernels.match:match_projected_cuda"]}
KERNEL = "match_projected_kernel"


def read(run):
    calls = [a for a, _ in run.calls["match_projected"] if a[0].shape[0] > 0]
    spent = sum(s for name, s in (run.trace or {}).get("kernel_s", {}).items() if KERNEL in name)
    if not calls or spent <= 0:
        return None
    least = sum(roofline.match_projected_bound_s(*a[:7]) for a in calls)
    return 100.0 * least / spent
