from .pose_opt import pose_only_optimize
from .triangulate import triangulate_midpoint, triangulate_rays
from .init2v import homography_dlt, decompose_homography, two_view_init_homography
from .tracker import MonoTracker, TrackerConfig, TrackerStatus
