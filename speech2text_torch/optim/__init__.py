"""Optimizers and learning-rate schedules of the port (Adam, AdamW,
ScaledAdam; Warmup, Eden, the cosine and Noam-hold schedules)."""

from .adam import Adam, clip_by_global_norm_
from .scaled_adam import ScaledAdam
from .schedules import EdenSchedule, WarmupLRSchedule
from .setup import MultiSteps, OptimSetup

__all__ = ["Adam", "EdenSchedule", "MultiSteps", "OptimSetup", "ScaledAdam",
           "WarmupLRSchedule", "clip_by_global_norm_"]
