"""Learning-rate schedules (port of speech2text_tpu/optim/schedules.py):
callables update count → lr, the count starting at 0 as optax's does.
Each is computed on the host in float64 (JAX's in f32, a few ulps
apart).

- Warmup: lr · warmup^0.5 · min(s^-0.5, s · warmup^-1.5), s = max(count,
  1), so the first two updates both take s = 1;
- Eden: icefall's (step, epoch)-indexed schedule, the epoch derived from
  `steps_per_epoch`: lr · ((s²+B²)/B²)^-0.25 · ((e²+E²)/E²)^-0.25 ·
  (0.5 + 0.5·min(s/warmup_batches, 1));
- Cosine_Warmup: linear warmup, then a cosine from lr to min_lr by
  `total_steps`; Cosine_Annealing: the same without warmup;
- Noam_Hold_Annealing: linear warmup, hold, then (1 − progress)^(1 /
  decay_rate) from lr to min_lr.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def WarmupLRSchedule(lr: float, warmup_steps: int = 25000) -> Schedule:
    def schedule(step: int) -> float:
        s = max(float(step), 1.0)
        return (lr * warmup_steps ** 0.5
                * min(s ** -0.5, s * warmup_steps ** -1.5))
    return schedule


def EdenSchedule(lr: float, lr_batches: float = 5000.0,
                 lr_epochs: float = 6.0, steps_per_epoch: int = 10000,
                 warmup_batches: float = 500.0) -> Schedule:
    def schedule(step: int) -> float:
        s = float(step)
        epoch = s / steps_per_epoch
        f_step = ((s ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
        f_epoch = ((epoch ** 2 + lr_epochs ** 2) / lr_epochs ** 2) ** -0.25
        warmup = min(s / warmup_batches, 1.0) * 0.5 + 0.5
        return lr * f_step * f_epoch * warmup
    return schedule


def CosineWarmupSchedule(lr: float, warmup_steps: int, total_steps: int,
                         min_lr: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        s = float(step)
        if s < warmup_steps:
            return lr * s / max(warmup_steps, 1)
        progress = min(max((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (lr - min_lr) * (1 + math.cos(math.pi
                                                            * progress))
    return schedule


def CosineAnnealingSchedule(lr: float, total_steps: int,
                            min_lr: float = 0.0) -> Schedule:
    return CosineWarmupSchedule(lr, 0, total_steps, min_lr)


def NoamHoldAnnealingSchedule(lr: float, warmup_steps: int,
                              hold_steps: int, total_steps: int,
                              decay_rate: float = 0.5,
                              min_lr: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        s = float(step)
        hold_end = warmup_steps + hold_steps
        if s < warmup_steps:
            return lr * s / max(warmup_steps, 1)
        if s < hold_end:
            return lr
        progress = min(max((s - hold_end)
                           / max(total_steps - hold_end, 1), 0.0), 1.0)
        return (lr - min_lr) * (1.0 - progress) ** (1.0 / decay_rate) \
            + min_lr
    return schedule
