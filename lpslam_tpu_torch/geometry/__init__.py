from .so3 import hat, so3_exp, so3_log, rot_to_quat, quat_log
from .se3 import (
    SE3,
    se3_exp,
    se3_log,
    se3_identity,
    se3_compose,
    se3_inverse,
    se3_apply,
)
from .camera import (
    PinholeCamera,
    project_pinhole,
    unproject_pinhole,
    distort_radtan,
    undistort_points_radtan,
    undistort_map_radtan,
)
