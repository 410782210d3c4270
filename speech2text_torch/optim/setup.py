"""OptimSetup (port of speech2text_tpu/optim/setup.py:71-113): the
optimizer and its schedule from the YAML `optim_setup` section.

Ported: ScaledAdam with the Eden schedule. A constant learning rate is a
float `lr` given to `ScaledAdam` itself. Every other optimizer or
scheduler type, and per-module learning rates (`seperate_lr`, the
reference's spelling), raise NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from .scaled_adam import ScaledAdam
from .schedules import EdenSchedule


def OptimSetup(config: Dict[str, Any], params: Iterable[torch.Tensor]
               ) -> Tuple[ScaledAdam, Callable[[int], float]]:
    """config = the `optim_setup` section → (optimizer over `params`,
    schedule)."""
    if (config.get("seperate_lr") or {}).get("apply"):
        raise NotImplementedError("per-module learning rates (seperate_lr) "
                                  "are not ported")
    opt_cfg = config["optimizer"]
    if opt_cfg["type"] != "ScaledAdam":
        raise NotImplementedError(f"optimizer {opt_cfg['type']!r} is not "
                                  f"ported (ScaledAdam only)")
    kw = dict(opt_cfg.get("config") or {})
    lr = float(kw.pop("lr", 1e-3))
    sched_cfg = config.get("lr_scheduler") or {}
    kind = sched_cfg.get("type", "Warmup")
    if kind != "Eden":
        raise NotImplementedError(f"lr scheduler {kind!r} is not ported "
                                  f"(Eden only)")
    c = sched_cfg.get("config") or {}
    schedule = EdenSchedule(lr, lr_batches=c.get("lr_batches", 5000.0),
                            lr_epochs=c.get("lr_epochs", 6.0),
                            steps_per_epoch=c.get("steps_per_epoch", 10000),
                            warmup_batches=c.get("warmup_batches", 500.0))
    opt = ScaledAdam(
        params, schedule, betas=tuple(kw.get("betas", (0.9, 0.98))),
        clipping_scale=kw.get("clipping_scale", 2.0),
        param_min_rms=kw.get("param_min_rms", 1e-5),
        param_max_rms=kw.get("param_max_rms", 3.0),
        scalar_lr_scale=kw.get("scalar_lr_scale", 0.1))
    return opt, schedule
