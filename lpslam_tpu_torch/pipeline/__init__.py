from .config import (
    CameraConfig, ConfigError, ConfigOptions, FullConfig, ManagerConfig, MarkerConfig,
    load_config_file,
)
from .queues import CameraQueueEntry, ResultQueueEntry, SensorQueueEntry
from .trackers import LaserScan, TrackerBase, TrackerResult, VSLAMTracker
from .processors import (
    AdjustIntensityProcessor, BlackoutImageProcessor, CameraCalibrationProcessor, ProcessorBase,
)
from .sources import FileImageSource, ImageSourceBase, ReplaySource, SyntheticSource
from .manager import SlamManager, SlamStatus
