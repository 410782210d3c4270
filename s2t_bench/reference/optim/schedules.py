"""The flagship's learning-rate schedule (port of
speech2text_tpu/optim/schedules.py): a callable update count → lr, the
count starting at 0 as optax's does, computed on the host in float64.

Eden: icefall's (step, epoch)-indexed schedule, the epoch derived from
`steps_per_epoch`: lr · ((s²+B²)/B²)^-0.25 · ((e²+E²)/E²)^-0.25 ·
(0.5 + 0.5·min(s/warmup_batches, 1)).
"""

from __future__ import annotations

from typing import Callable

Schedule = Callable[[int], float]


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
