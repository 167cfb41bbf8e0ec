"""Frame and marker transformations (port of
lpslam_tpu/utils/transformations.py). Poses are (position, quaternion wxyz)
pairs of a frame in its parent; the quaternion algebra runs in float32 on
the CPU, as the JAX package's does."""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.so3 import quat_conj, quat_mul, quat_to_rot


def _q(q):
    return torch.as_tensor(np.asarray(q, np.float32))


def _rot(q):
    return quat_to_rot(_q(q)).numpy()


def tracker_to_origin(tracker_pos, tracker_q, origin_pos, origin_q):
    """A tracker-frame pose in the origin (global) frame; origin_* is the
    tracker frame's pose there. Returns (position, q_wxyz)."""
    pos = _rot(origin_q) @ np.asarray(tracker_pos) + np.asarray(origin_pos)
    return pos, quat_mul(_q(origin_q), _q(tracker_q)).numpy()


def marker_to_global(marker_pos_vehicle, marker_q_vehicle, vehicle_pos, vehicle_q):
    """A marker seen in the vehicle frame -> its pose in the global frame."""
    pos = _rot(vehicle_q) @ np.asarray(marker_pos_vehicle) + np.asarray(vehicle_pos)
    return pos, quat_mul(_q(vehicle_q), _q(marker_q_vehicle)).numpy()


def vehicle_pose_from_marker_measurement(marker_global_pos, marker_global_q,
                                         measured_pos, measured_q):
    """The vehicle's global pose from a measurement of a known marker
    (measured_*: the marker as seen from the vehicle):
    T_vehicle = T_marker_global ∘ T_measured⁻¹."""
    q_meas_inv = quat_conj(_q(measured_q)).numpy()
    q_veh = quat_mul(_q(marker_global_q), _q(q_meas_inv)).numpy()
    pos = np.asarray(marker_global_pos) - _rot(q_veh) @ np.asarray(measured_pos)
    return pos, q_veh
