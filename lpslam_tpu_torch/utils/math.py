"""Angle conversions (port of lpslam_tpu/utils/math.py)."""
import math


def to_rad(deg: float) -> float:
    return deg * math.pi / 180.0


def to_degree(rad: float) -> float:
    return rad * 180.0 / math.pi
