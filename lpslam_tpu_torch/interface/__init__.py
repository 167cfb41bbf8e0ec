from .lpslam_manager import LpSlamManager, LpSlamStatus
