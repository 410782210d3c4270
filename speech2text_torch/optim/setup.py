"""OptimSetup (port of speech2text_tpu/optim/setup.py): the optimizer and
its schedule from the YAML `optim_setup` section.

Optimizers: Adam and AdamW with optax's semantics (optim/adam.py),
ScaledAdam. Schedules: Warmup (the default), Eden, Cosine_Warmup,
Cosine_Annealing, Noam_Hold_Annealing, with the JAX package's defaults.
An unknown type raises ValueError; per-module learning rates
(`seperate_lr`, the reference's spelling), which no recipe sets, raise
NotImplementedError. Global-norm clipping (`trainer.gradient_clip_val`)
is the training step's (optim/adam.py:clip_by_global_norm_).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Tuple

import torch

from .adam import Adam
from .scaled_adam import ScaledAdam
from .schedules import (CosineAnnealingSchedule, CosineWarmupSchedule,
                        EdenSchedule, NoamHoldAnnealingSchedule,
                        WarmupLRSchedule)


def build_schedule(kind: str, lr: float, c: Dict[str, Any]
                   ) -> Callable[[int], float]:
    if kind == "Warmup":
        return WarmupLRSchedule(lr, warmup_steps=c.get("warmup_steps",
                                                       25000))
    if kind == "Eden":
        return EdenSchedule(lr, lr_batches=c.get("lr_batches", 5000.0),
                            lr_epochs=c.get("lr_epochs", 6.0),
                            steps_per_epoch=c.get("steps_per_epoch", 10000),
                            warmup_batches=c.get("warmup_batches", 500.0))
    if kind == "Cosine_Warmup":
        return CosineWarmupSchedule(
            lr, warmup_steps=c.get("warmup_steps", 1000),
            total_steps=c.get("total_steps", 100000),
            min_lr=c.get("min_lr", 0.0))
    if kind == "Cosine_Annealing":
        return CosineAnnealingSchedule(
            lr, total_steps=c.get("total_steps", c.get("T_max", 100000)),
            min_lr=c.get("min_lr", c.get("eta_min", 0.0)))
    if kind == "Noam_Hold_Annealing":
        return NoamHoldAnnealingSchedule(
            lr, warmup_steps=c.get("warmup_steps", 1000),
            hold_steps=c.get("hold_steps", 0),
            total_steps=c.get("total_steps", 100000),
            decay_rate=c.get("decay_rate", 0.5),
            min_lr=c.get("min_lr", 0.0))
    raise ValueError(f"unknown lr scheduler {kind}")


def OptimSetup(config: Dict[str, Any], params: Iterable[torch.Tensor]
               ) -> Tuple[Any, Callable[[int], float]]:
    """config = the `optim_setup` section → (optimizer over `params`,
    schedule)."""
    if (config.get("seperate_lr") or {}).get("apply"):
        raise NotImplementedError("per-module learning rates (seperate_lr) "
                                  "are not ported")
    opt_cfg = config["optimizer"]
    kw = dict(opt_cfg.get("config") or {})
    lr = float(kw.pop("lr", 1e-3))
    sched_cfg = config.get("lr_scheduler") or {}
    schedule = build_schedule(sched_cfg.get("type", "Warmup"), lr,
                              sched_cfg.get("config") or {})
    kind = opt_cfg["type"]
    if kind in ("Adam", "AdamW"):
        # optax.adamw decays every parameter by weight_decay (default 1e-2)
        wd = kw.get("weight_decay", 1e-2) if kind == "AdamW" else 0.0
        opt = Adam(params, schedule, betas=tuple(kw.get("betas",
                                                        (0.9, 0.999))),
                   eps=kw.get("eps", 1e-8), weight_decay=wd)
    elif kind == "ScaledAdam":
        opt = ScaledAdam(
            params, schedule, betas=tuple(kw.get("betas", (0.9, 0.98))),
            clipping_scale=kw.get("clipping_scale", 2.0),
            param_min_rms=kw.get("param_min_rms", 1e-5),
            param_max_rms=kw.get("param_max_rms", 3.0),
            scalar_lr_scale=kw.get("scalar_lr_scale", 0.1))
    else:
        raise ValueError(f"unknown optimizer {kind}")
    return opt, schedule
