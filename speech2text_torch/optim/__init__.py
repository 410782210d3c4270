"""Optimizer and learning-rate schedule of the port (ScaledAdam, Eden)."""

from .scaled_adam import ScaledAdam
from .schedules import EdenSchedule
from .setup import OptimSetup

__all__ = ["EdenSchedule", "OptimSetup", "ScaledAdam"]
