"""PID controller for the synthetic source's waypoint navigation (port of
lpslam_tpu/utils/pid.py)."""
from __future__ import annotations


class PidController:
    def __init__(self, kp: float, ki: float = 0.0, kd: float = 0.0,
                 out_min: float = float("-inf"), out_max: float = float("inf")):
        self.kp, self.ki, self.kd = kp, ki, kd
        self.out_min, self.out_max = out_min, out_max
        self._integral = 0.0
        self._prev_error = None

    def reset(self):
        self._integral = 0.0
        self._prev_error = None

    def update(self, error: float, dt: float) -> float:
        self._integral += error * dt
        deriv = 0.0 if self._prev_error is None or dt <= 0 else (error - self._prev_error) / dt
        self._prev_error = error
        out = self.kp * error + self.ki * self._integral + self.kd * deriv
        return min(max(out, self.out_min), self.out_max)
