from .config import ConfigError, ConfigOptions
from .queues import CameraQueueEntry
from .trackers import TrackerBase, TrackerResult, VSLAMTracker
