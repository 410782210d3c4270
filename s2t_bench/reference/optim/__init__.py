"""The flagship's optimizer and learning-rate schedule: ScaledAdam under
Eden."""

from .scaled_adam import ScaledAdam
from .schedules import EdenSchedule
from .setup import OptimSetup, optim_settings

__all__ = ["EdenSchedule", "OptimSetup", "ScaledAdam", "optim_settings"]
