from .so3 import (
    hat,
    vee,
    so3_exp,
    so3_log,
    quat_to_rot,
    rot_to_quat,
    quat_mul,
    quat_conj,
    quat_normalize,
    quat_log,
)
from .se3 import (
    SE3,
    se3_exp,
    se3_log,
    se3_identity,
    se3_compose,
    se3_inverse,
    se3_apply,
    se3_from_Rt,
    se3_retract,
    se3_to_matrix,
    se3_from_matrix,
    se3_adjoint,
)
from .sim3 import sim3_exp, sim3_log, sim3_apply, sim3_compose, sim3_inverse
from .camera import (
    PinholeCamera,
    project_pinhole,
    unproject_pinhole,
    distort_radtan,
    undistort_points_radtan,
    distort_fisheye,
    undistort_points_fisheye,
    undistort_map_radtan,
    undistort_map_fisheye,
    rectify_maps_stereo,
)
from .frames import lpslam_to_optical, optical_to_lpslam
