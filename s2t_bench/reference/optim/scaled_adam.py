"""ScaledAdam (port of speech2text_tpu/optim/scaled_adam.py:80-255).

The update of each tensor is the JAX package's (icefall's ScaledAdam):

1. RMS-proportional step: the grad term added to the momentum buffer is
   −lr·(1−β1)·param_rms·g/denom, `param_rms` refreshed every
   `size_update_period` steps and held at least `param_min_rms`.
2. Learned parameter scale: the per-step scale grads Σ p·g are buffered
   over the period; at its last step a scale step with its own second
   moment (β2^period decay) multiplies the tensor, zero where the rms is
   below `param_min_rms` and clamped so the rms stays below
   `param_max_rms`.
3. The momentum `delta` carries the lr folded in.
4. Median clipping: the clipped norm is the rms-weighted grad norm
   (Σ(g·param_rms)² over tensors, scalar_lr_scale²·Σg² over scalars);
   the limit is `clipping_scale` × the median of the last
   `norm_buffer_size` norms, doubled while that buffer fills; no clipping
   on the first 10 steps. A non-finite norm zeroes the grads of the step
   and stays out of the buffer.
5. Tensors of one element take plain Adam with lr·scalar_lr_scale and the
   parameter clamped to ±scalar_max.

Like the JAX version, tensors of one shape are stacked and updated
together (one set of operations per shape, not per tensor); the math per
tensor does not depend on that grouping. The step count is a host
integer, so no step reads a value back from the card. One process: the
port's FSDP sums and its checkpoint state are left out.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Union

import torch


def _group_by_shape(params: List[torch.Tensor]) -> List[List[int]]:
    by_shape: dict = {}
    for i, p in enumerate(params):
        by_shape.setdefault(tuple(p.shape), []).append(i)
    return list(by_shape.values())


def _stack(tensors) -> torch.Tensor:
    return torch.stack([t.float() for t in tensors])


def _per_tensor(x: torch.Tensor, fn) -> torch.Tensor:
    """`fn` (sum or mean) over each stacked tensor: (N, *shape) → (N,);
    a stack of scalars (N,) is returned as it is."""
    return fn(x, dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x


def _bcast(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(N,) → (N, 1, ..., 1) for broadcasting against (N, *shape)."""
    return x.reshape(x.shape + (1,) * (ndim - 1))


class ScaledAdam:
    """`step()` updates `params` in place from their `.grad` (a missing
    grad counts as zero). `lr` is a float or a callable step → lr, the step
    counted from 0."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr: Union[float, Callable[[int], float]],
                 betas=(0.9, 0.98), eps: float = 1e-8,
                 clipping_scale: float | None = 2.0,
                 param_min_rms: float = 1e-5, param_max_rms: float = 3.0,
                 scalar_lr_scale: float = 0.1, scalar_max: float = 10.0,
                 size_update_period: int = 4, norm_buffer_size: int = 100):
        self.params = list(params)
        if not self.params:
            raise ValueError("ScaledAdam got no parameters")
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.clipping_scale = clipping_scale
        self.param_min_rms, self.param_max_rms = param_min_rms, param_max_rms
        self.scalar_lr_scale, self.scalar_max = scalar_lr_scale, scalar_max
        self.period = size_update_period
        self.buffer_size = norm_buffer_size
        self.groups = _group_by_shape(self.params)
        dev = self.params[0].device
        self.step_count = 0
        self.norm_buffer = torch.zeros(norm_buffer_size, device=dev)
        self.delta, self.exp_avg_sq = [], []
        self.scale_exp_avg_sq, self.scale_grads, self.param_rms = [], [], []
        with torch.no_grad():
            for gi, idxs in enumerate(self.groups):
                p = _stack([self.params[i] for i in idxs])
                n = len(idxs)
                self.delta.append(torch.zeros_like(p))
                self.exp_avg_sq.append(torch.zeros_like(p))
                self.scale_exp_avg_sq.append(torch.zeros(n, device=dev))
                self.scale_grads.append(torch.zeros(n, self.period,
                                                    device=dev))
                # a scalar group reduces over nothing: per-tensor |x|
                self.param_rms.append(self._mean(gi, p.square()).sqrt())

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _sums(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each group's per-tensor sums of its stack `xs[gi]`."""
        return [_per_tensor(x, torch.sum) for x in xs]

    def _mean(self, gi: int, x: torch.Tensor) -> torch.Tensor:
        """The per-tensor mean of group `gi`'s stack `x`."""
        return _per_tensor(x, torch.mean)

    def _scalar_group(self, gi: int) -> bool:
        return self.params[self.groups[gi][0]].numel() <= 1

    @torch.no_grad()
    def step(self) -> None:
        step = self.step_count
        lr = self.lr_at(step)
        b1, b2, eps, P = self.beta1, self.beta2, self.eps, self.period
        G, Pm = [], []
        for idxs in self.groups:
            G.append(_stack([
                self.params[i].grad if self.params[i].grad is not None
                else torch.zeros_like(self.params[i]) for i in idxs]))
            Pm.append(_stack([self.params[i] for i in idxs]))

        dev = self.norm_buffer.device
        if self.clipping_scale is not None and self.clipping_scale > 0:
            tot = torch.zeros((), device=dev)
            for gi, sumsq in enumerate(self._sums([g.square() for g in G])):
                w = (self.scalar_lr_scale ** 2 if self._scalar_group(gi)
                     else self.param_rms[gi].square())
                tot = tot + (sumsq * w).sum()
            gnorm = tot.sqrt()
            finite = torch.isfinite(gnorm)
            idx = step % self.buffer_size
            self.norm_buffer[idx] = torch.where(finite, gnorm,
                                                self.norm_buffer[idx])
            n_valid = min(step + 1, self.buffer_size)
            valid = torch.arange(self.buffer_size, device=dev) < n_valid
            sorted_buf = torch.sort(torch.where(valid, self.norm_buffer,
                                                torch.inf)).values
            median = sorted_buf[max((n_valid + 1) // 2 - 1, 0)]
            limit = self.clipping_scale * torch.clamp(median, min=1e-12)
            if step < self.buffer_size:       # estimation window
                limit = 2.0 * limit
            if step < 10:
                clip = torch.ones((), device=dev)
            else:
                clip = torch.clamp(limit / torch.clamp(gnorm, min=1e-12),
                                   max=1.0)
            clip = torch.where(finite, clip, 0.0)
        else:
            clip = torch.ones((), device=dev)

        is_boundary = step % P == P - 1
        size_step = (step + 1) // P
        beta2_corr = b2 ** P
        bias2_size = 1.0 - beta2_corr ** max(float(size_step), 1.0)
        bias2 = 1.0 - b2 ** (step + 1.0)
        # clip == 0 marks a non-finite step: zero the grads outright
        G = [torch.where(clip > 0.0, g * clip, 0.0) for g in G]
        scale_sums = self._sums([
            torch.zeros(0, device=dev) if self._scalar_group(gi)
            else g * p32 for gi, (g, p32) in enumerate(zip(G, Pm))])
        for gi, idxs in enumerate(self.groups):
            g, p32 = G[gi], Pm[gi]
            d = b1 * self.delta[gi]
            v = self.exp_avg_sq[gi]
            if self._scalar_group(gi):
                v = b2 * v + (1.0 - b2) * g.square()
                denom = (v / bias2).sqrt() + eps
                d = d - (lr * self.scalar_lr_scale) * (1.0 - b1) * g / denom
                upd = p32.clamp(-self.scalar_max, self.scalar_max) + d - p32
            else:
                sgbuf = self.scale_grads[gi]
                sgbuf[:, step % P] = scale_sums[gi]
                rms = self.param_rms[gi]
                sv = self.scale_exp_avg_sq[gi]
                if is_boundary:
                    rms = self._mean(gi, p32.square()).sqrt()
                    sv = (beta2_corr * sv + (1.0 - beta2_corr)
                          * sgbuf.square().mean(dim=1))
                if is_boundary and step > 0:
                    scale_step = (-(lr * self.scalar_lr_scale)
                                  * bias2_size ** 0.5 * sgbuf.sum(dim=1)
                                  / (sv.sqrt() + eps))
                    scale_step = torch.where(rms < self.param_min_rms, 0.0,
                                             scale_step)
                    scale_step = torch.minimum(
                        scale_step, (self.param_max_rms - rms)
                        / torch.clamp(rms, min=1e-12))
                    d = d + _bcast((1.0 - b1) * scale_step, d.ndim) * p32
                v = b2 * v + (1.0 - b2) * g.square()
                vhat = v / (bias2 if bias2 < 0.99 else 1.0)
                denom = vhat.sqrt() + eps
                alpha = -lr * (1.0 - b1) * torch.clamp(
                    rms, min=self.param_min_rms)
                d = d + _bcast(alpha, d.ndim) * g / denom
                upd = d
                self.param_rms[gi] = rms
                self.scale_exp_avg_sq[gi] = sv
            self.delta[gi] = d
            self.exp_avg_sq[gi] = v
            torch._foreach_add_([self.params[i] for i in idxs],
                                [u.to(self.params[i].dtype) for i, u in
                                 zip(idxs, upd.unbind(0))])
        self.step_count = step + 1
