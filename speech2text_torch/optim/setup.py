"""OptimSetup (port of speech2text_tpu/optim/setup.py): the optimizer and
its schedule from the YAML `optim_setup` section.

Optimizers: Adam and AdamW with optax's semantics (optim/adam.py),
ScaledAdam. Schedules: Warmup (the default), Eden, Cosine_Warmup,
Cosine_Annealing, Noam_Hold_Annealing, with the JAX package's defaults.
An unknown type raises ValueError. Per-module learning rates
(`seperate_lr`, the reference's spelling; setup.py:94-113 of the JAX
package, optax.multi_transform): with `seperate_lr.apply`, each top-level
module named in `seperate_lr.config` as `<module>_lr` gets an optimizer
of its own whose schedule has that base lr, the other parameters one with
the default lr (`MultiOptimizer`); each optimizer sees only its
parameters, so ScaledAdam clips each group by its own norms. Global-norm
clipping (`trainer.gradient_clip_val`) is the training step's
(optim/adam.py:clip_by_global_norm_), or `MultiSteps`' under gradient
accumulation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple, Union

import torch

from ..parallel import full, grad_norm, is_sharded, local, shard_rows
from .adam import Adam, clip_by_global_norm_
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


class MultiOptimizer:
    """Optimizers of disjoint parameter groups (by name) stepped together,
    as optax.multi_transform steps its transforms."""

    def __init__(self, optimizers: Dict[str, Any]):
        self.optimizers = optimizers

    def zero_grad(self) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad()

    def step(self) -> None:
        for opt in self.optimizers.values():
            opt.step()

    def state_dict(self) -> dict:
        return {name: opt.state_dict()
                for name, opt in self.optimizers.items()}

    def load_state_dict(self, state: dict) -> None:
        if set(state) != set(self.optimizers):
            raise ValueError(f"optimizer state of groups {sorted(state)}, "
                             f"not {sorted(self.optimizers)}")
        for name, opt in self.optimizers.items():
            opt.load_state_dict(state[name])


class MultiSteps:
    """Gradient accumulation over `every_k` micro-batches, as
    optax.MultiSteps wraps the JAX loop's whole chain (global-norm
    clipping to `clip`, then the optimizer): each `step()` folds the
    parameters' gradients (a missing one as zero) into the running mean
    acc ← acc + (g − acc) / (n + 1); at the k-th the mean is clipped and
    handed to `optimizer` as the gradients, its count advancing once per
    k, and the mean restarts from zero. The accumulator and both counters
    are in `state_dict()`, as they are in optax's state, so a checkpoint
    taken between micro-batches resumes bitwise. Under DDP every
    micro-batch's gradients are the ranks' average before they are folded
    in, so the mean is optax's over the global micro-batches; under FSDP
    the accumulator of a sharded parameter is sharded as it is, and
    `state_dict()` holds whole tensors."""

    def __init__(self, optimizer, every_k: int,
                 params: Iterable[torch.Tensor],
                 clip: Union[float, None] = None):
        self.optimizer = optimizer
        self.every_k = int(every_k)
        self.params = [p for p in params if p.requires_grad]
        self.clip = clip
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, acc in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(acc)
            acc.add_((g - acc) / (n + 1))
        if n < self.every_k - 1:
            self.mini_step = n + 1
            return
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.clone()
        if self.clip is not None:
            grads = [p.grad for p in self.params]
            clip_by_global_norm_(grads, self.clip, grad_norm(grads))
        self.optimizer.step()
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": [full(t).detach().cpu() for t in self.acc],
                "inner": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        if len(state["acc"]) != len(self.params) or any(
                t.shape != p.shape for t, p in zip(state["acc"],
                                                   self.params)):
            raise ValueError("accumulated gradients: shapes differ")
        self.optimizer.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        self.gradient_step = int(state["gradient_step"])
        self.acc = [self._mine(t, p)
                    for t, p in zip(state["acc"], self.params)]

    @staticmethod
    def _mine(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """A whole accumulator as `p`'s (this rank's rows if sharded)."""
        if not is_sharded(p):
            return t.to(p.device, copy=True)
        acc = torch.zeros_like(p)
        local(acc).copy_(shard_rows(t))
        return acc


def OptimSetup(config: Dict[str, Any],
               params: Iterable[Union[torch.Tensor,
                                      Tuple[str, torch.Tensor]]]
               ) -> Tuple[Any, Callable[[int], float]]:
    """config = the `optim_setup` section → (optimizer over `params`,
    schedule). `params` are tensors or, as `seperate_lr` needs, (name,
    tensor) pairs such as `model.named_parameters()`; those that take no
    gradient (`requires_grad` off, such as an LSTM's zero input biases)
    are left out. The schedule returned is the default group's."""
    params = [p for p in params
              if (p[1] if isinstance(p, tuple) else p).requires_grad]
    named = bool(params) and isinstance(params[0], tuple)
    opt_cfg = config["optimizer"]
    kw = dict(opt_cfg.get("config") or {})
    lr = float(kw.pop("lr", 1e-3))
    sched_cfg = config.get("lr_scheduler") or {}
    kind = sched_cfg.get("type", "Warmup")
    schedule = build_schedule(kind, lr, sched_cfg.get("config") or {})
    sep = config.get("seperate_lr") or {}
    if not sep.get("apply"):
        tensors = [p for _, p in params] if named else params
        return _optimizer(opt_cfg["type"], kw, tensors, schedule), schedule
    if not named:
        raise ValueError("seperate_lr needs the parameters' names "
                         "(model.named_parameters())")
    group_lrs = {k[:-len("_lr")]: float(v)
                 for k, v in (sep.get("config") or {}).items()
                 if k.endswith("_lr")}
    groups: Dict[str, List[torch.Tensor]] = {"default": []}
    for name, p in params:
        top = name.split(".")[0]
        groups.setdefault(top if top in group_lrs else "default",
                          []).append(p)
    optimizers = {}
    for group, tensors in groups.items():
        if not tensors:
            continue
        sched = schedule if group == "default" else build_schedule(
            kind, group_lrs[group], sched_cfg.get("config") or {})
        optimizers[group] = _optimizer(opt_cfg["type"], kw, tensors, sched)
    return MultiOptimizer(optimizers), schedule


def _optimizer(kind: str, kw: Dict[str, Any], params: List[torch.Tensor],
               schedule: Callable[[int], float]):
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
    return opt
