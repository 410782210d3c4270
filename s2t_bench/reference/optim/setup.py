"""OptimSetup (port of speech2text_tpu/optim/setup.py) for the flagship:
ScaledAdam under the Eden schedule from the YAML `optim_setup` section,
one parameter group. Another optimizer or schedule raises ValueError.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from .scaled_adam import ScaledAdam
from .schedules import EdenSchedule


def OptimSetup(config: Dict[str, Any], params: Iterable[torch.Tensor]
               ) -> Tuple[ScaledAdam, Callable[[int], float]]:
    """config = the `optim_setup` section → (optimizer over the `params`
    that take gradients, schedule)."""
    kw, schedule = optim_settings(config)
    opt = ScaledAdam([p for p in params if p.requires_grad], schedule, **kw)
    return opt, schedule


def optim_settings(config: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], EdenSchedule]:
    """The ScaledAdam keywords and the Eden schedule of an `optim_setup`
    section, with no tensor made."""
    if (config.get("seperate_lr") or {}).get("apply"):
        raise ValueError("the reference has one parameter group only")
    opt_cfg = config["optimizer"]
    if opt_cfg["type"] != "ScaledAdam":
        raise ValueError(f"the reference has no optimizer {opt_cfg['type']}")
    kw = dict(opt_cfg.get("config") or {})
    lr = float(kw.pop("lr", 1e-3))
    sched_cfg = config.get("lr_scheduler") or {}
    if sched_cfg.get("type") != "Eden":
        raise ValueError(f"the reference has no lr scheduler "
                         f"{sched_cfg.get('type')}")
    c = sched_cfg.get("config") or {}
    schedule = EdenSchedule(lr, lr_batches=c.get("lr_batches", 5000.0),
                            lr_epochs=c.get("lr_epochs", 6.0),
                            steps_per_epoch=c.get("steps_per_epoch", 10000),
                            warmup_batches=c.get("warmup_batches", 500.0))
    return dict(betas=tuple(kw.get("betas", (0.9, 0.98))),
                clipping_scale=kw.get("clipping_scale", 2.0),
                param_min_rms=kw.get("param_min_rms", 1e-5),
                param_max_rms=kw.get("param_max_rms", 3.0),
                scalar_lr_scale=kw.get("scalar_lr_scale", 0.1)), schedule
