"""AdamW after a global-norm clip, under the Warmup schedule, in plain
PyTorch with optax's arithmetic (optax.chain(clip_by_global_norm(c),
adamw(schedule, weight_decay=wd)), as the JAX package's training loop
chains them; the port's speech2text_torch/optim/adam.py).

For each parameter p with gradient g, at update count n (from 0):

    g  ← g · c / ‖g_all‖   where ‖g_all‖ ≥ c (the global norm of every
                           gradient), else g
    mu ← (1 − b1)·g + b1·mu,   nu ← (1 − b2)·g² + b2·nu
    p  ← p − lr(n) · (mu / (1 − b1^(n+1)) / (√(nu / (1 − b2^(n+1))) + eps)
                      + wd·p)

The bias corrections are f32, as JAX's. Warmup (Noam's schedule):
lr(n) = lr · w^0.5 · min(s^−0.5, s · w^−1.5), s = max(n, 1). The clip
leaves the clipped gradient in `p.grad`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def warmup(lr: float, warmup_steps: int) -> Callable[[int], float]:
    def schedule(n: int) -> float:
        s = max(float(n), 1.0)
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)
    return schedule


class ClippedAdamW:

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Callable[[int], float], clip: Optional[float],
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params: List[torch.Tensor] = [p for p in params
                                           if p.requires_grad]
        self.schedule = schedule
        self.clip = clip
        self.b1, self.b2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.wd = float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            if norm >= self.clip:
                for g in grads:
                    g.mul_(self.clip / norm)
        n = self.count
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(n + 1))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(n + 1))
        lr = float(self.schedule(n))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            update = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
            p.sub_(lr * (update + self.wd * p))
        self.count = n + 1


def optim_settings(config: Dict[str, Any], clip: Optional[float]
                   ) -> Dict[str, Any]:
    """ClippedAdamW's keywords from an `optim_setup` section, with no
    tensor made; raises ValueError on what it does not have."""
    if (config.get("seperate_lr") or {}).get("apply"):
        raise ValueError("the reference has one parameter group only")
    opt = config["optimizer"]
    if opt["type"] not in ("Adam", "AdamW"):
        raise ValueError(f"the reference has no optimizer {opt['type']}")
    kw = dict(opt.get("config") or {})
    sched = config.get("lr_scheduler") or {}
    if sched.get("type", "Warmup") != "Warmup":
        raise ValueError(f"the reference has no lr scheduler "
                         f"{sched.get('type')}")
    c = sched.get("config") or {}
    return {"schedule": warmup(float(kw.get("lr", 1e-3)),
                               int(c.get("warmup_steps", 25000))),
            "clip": clip,
            "betas": tuple(kw.get("betas", (0.9, 0.999))),
            "eps": float(kw.get("eps", 1e-8)),
            "weight_decay": float(kw.get("weight_decay", 1e-2))
            if opt["type"] == "AdamW" else 0.0}
