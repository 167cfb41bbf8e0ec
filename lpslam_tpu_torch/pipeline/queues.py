"""Pipeline queue entries (port of ``CameraQueueEntry`` from
lpslam_tpu/pipeline/queues.py; the queues and worker threads are not
ported yet)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass
class CameraQueueEntry:
    """A mono or stereo frame with optional navigation states."""

    timestamp: float
    image: np.ndarray
    image_second: Optional[np.ndarray] = None
    camera_number: int = 0
    state_odom: Optional[object] = None
    state_map: Optional[object] = None
    ros_timestamp: Optional[int] = None
    aux: Any = None      # depth map for RGB-D sources
    valid: bool = True   # False = shutdown sentinel
