"""frame_latency_p95_ms (ms): the 95th percentile, over every frame handed
in during the window, of the time from the call that handed the frame in
to the return of the call that gave back its result; a frame with no
result counts to the return of the call after which it had none."""
import numpy as np


def read(run):
    lat = run.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
