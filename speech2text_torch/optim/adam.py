"""Adam, and AdamW as Adam with `weight_decay`, with optax's semantics
(port of optax.adam / optax.adamw as speech2text_tpu/optim/setup.py
builds them), and optax's global-norm clipping.

The update of each parameter p with gradient g, at update count c (from
0), is optax's, operation for operation in f32:

    mu = (1 − b1)·g + b1·mu,   nu = (1 − b2)·g² + b2·nu
    u  = (mu / (1 − b1^(c+1))) / (sqrt(nu / (1 − b2^(c+1))) + eps)
    u  = u + weight_decay·p            (AdamW: every parameter, biases and
                                        norm scales included)
    p  = p + (−lr(c))·u                (the schedule at the count before
                                        the increment)

torch.optim.AdamW decays p by (1 − lr·wd) before the step and folds the
bias corrections into the step size: the same update in exact
arithmetic, other roundings. The bias corrections are computed in f32,
as JAX computes them. The count is a host integer, so no step reads a
value back from the card. Under FSDP (parallel/mesh.py) the moments are
this rank's rows of a sharded parameter's, updated elementwise;
`state_dict()` gathers whole tensors and `load_state_dict()` takes this
rank's rows of them.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import numpy as np
import torch

from ..parallel import gather_rows, is_sharded, local, shard_rows


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: where `norm` (the gradients'
    global norm) is at least `max_norm`, each g becomes (g / norm) ·
    max_norm; no epsilon (torch.nn.utils.clip_grad_norm_ divides by
    norm + 1e-6)."""
    keep = norm < max_norm
    for g in grads:
        g = local(g)
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


class Adam:
    """`step()` updates `params` in place from their `.grad` (a missing
    grad counts as zero). `lr` is the schedule, update count → lr."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Callable[[int], float],
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = list(params)
        if not self.params:
            raise ValueError("Adam got no parameters")
        self.lr = lr
        self.beta1, self.beta2 = (float(b) for b in betas)
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(local(p)) for p in self.params]
        self.nu = [torch.zeros_like(local(p)) for p in self.params]

    def lr_at(self, count: int) -> float:
        return float(self.lr(count))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The update count and both moments as CPU tensors."""
        def whole(t, p):
            return gather_rows(t, p.shape[0]).cpu() if is_sharded(p) \
                else t.detach().cpu()
        return {"count": self.count,
                "mu": [whole(t, p) for t, p in zip(self.mu, self.params)],
                "nu": [whole(t, p) for t, p in zip(self.nu, self.params)]}

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output onto the parameters' devices;
        raises if the parameters' shapes differ."""
        for name in ("mu", "nu"):
            if len(state[name]) != len(self.params) or any(
                    t.shape != p.shape for t, p in zip(state[name],
                                                       self.params)):
                raise ValueError(f"optimizer state {name}: shapes differ")
        def mine(t, p):
            if is_sharded(p):
                t = shard_rows(t)
            return t.to(local(p).device, copy=True).contiguous()
        self.count = int(state["count"])
        self.mu = [mine(t, p) for t, p in zip(state["mu"], self.params)]
        self.nu = [mine(t, p) for t, p in zip(state["nu"], self.params)]

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.beta1, self.beta2
        c = self.count + 1
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(c))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(c))
        step_size = -self.lr_at(self.count)
        params = [local(p) for p in self.params]
        grads = [local(p.grad) if p.grad is not None else torch.zeros_like(lp)
                 for p, lp in zip(self.params, params)]
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1),
                                     torch._foreach_mul(self.mu, b1))
        sq = torch._foreach_mul(grads, grads)
        self.nu = torch._foreach_add(torch._foreach_mul(sq, 1.0 - b2),
                                     torch._foreach_mul(self.nu, b2))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        if self.weight_decay:
            upd = torch._foreach_add(
                upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, step_size)
        torch._foreach_add_(params, upd)
        self.count = c

