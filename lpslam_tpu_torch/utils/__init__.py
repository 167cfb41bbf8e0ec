from .transformations import (
    tracker_to_origin,
    marker_to_global,
    vehicle_pose_from_marker_measurement,
)
from .pid import PidController
from .timing import ScopeTimer, TimingStats, device_trace
from .math import to_rad, to_degree
