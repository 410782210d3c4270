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
integer, so no step reads a value back from the card.

Under FSDP (parallel/mesh.py) a group of sharded parameters holds this
rank's rows of each tensor: the update is elementwise on them, and every
per-tensor statistic (the clipping norm's sums of squares, the scale
gradients Σ p·g, the parameter RMS) is summed over the ranks, so each is
the whole tensor's. `state_dict()` gathers whole tensors and
`load_state_dict()` takes this rank's rows of them: a checkpoint is the
same file at any world size.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..convert import to_flax
from ..parallel import all_reduce_sum, gather_rows, is_sharded, local, \
    shard_rows


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
        self.sharded = [is_sharded(self.params[g[0]]) for g in self.groups]
        dev = local(self.params[0]).device
        self.step_count = 0
        self.norm_buffer = torch.zeros(norm_buffer_size, device=dev)
        self.delta, self.exp_avg_sq = [], []
        self.scale_exp_avg_sq, self.scale_grads, self.param_rms = [], [], []
        with torch.no_grad():
            for gi, idxs in enumerate(self.groups):
                p = _stack([local(self.params[i]) for i in idxs])
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

    _LISTS = ("delta", "exp_avg_sq", "scale_exp_avg_sq", "scale_grads",
              "param_rms")
    _ROWS = ("delta", "exp_avg_sq")     # stacks of the tensors' own shape

    def _sums(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each group's per-tensor sums of its stack `xs[gi]`, those of
        sharded groups summed over the ranks in one collective."""
        sums = [_per_tensor(x, torch.sum) for x in xs]
        idx = [gi for gi, sh in enumerate(self.sharded) if sh]
        if idx:
            total = all_reduce_sum(torch.cat([sums[gi] for gi in idx]))
            for gi, s in zip(idx, total.split([len(sums[gi])
                                               for gi in idx])):
                sums[gi] = s
        return sums

    def _mean(self, gi: int, x: torch.Tensor) -> torch.Tensor:
        """The per-tensor mean of group `gi`'s stack `x`."""
        if not self.sharded[gi]:
            return _per_tensor(x, torch.mean)
        n = self.params[self.groups[gi][0]].numel()
        return all_reduce_sum(_per_tensor(x, torch.sum)) / n

    def _dim0(self, gi: int) -> int:
        return self.params[self.groups[gi][0]].shape[0]

    def state_dict(self) -> dict:
        """The optimizer's whole state as CPU tensors: the host step
        count, the clipping norms' buffer and each shape group's
        buffers."""
        out = {"step_count": self.step_count,
               "groups": [list(g) for g in self.groups],
               "norm_buffer": self.norm_buffer.detach().cpu()}
        for name in self._LISTS:
            out[name] = [
                gather_rows(t, self._dim0(gi), dim=1).cpu()
                if name in self._ROWS and self.sharded[gi]
                else t.detach().cpu()
                for gi, t in enumerate(getattr(self, name))]
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict()`'s output onto the parameters' device;
        raises if the parameters group differently."""
        if [list(g) for g in state["groups"]] != [list(g) for g in
                                                   self.groups]:
            raise ValueError("optimizer state of other parameter shapes")
        dev = self.norm_buffer.device
        self.step_count = int(state["step_count"])
        self.norm_buffer = state["norm_buffer"].to(dev, copy=True)
        for name in self._LISTS:
            mine = getattr(self, name)
            if len(state[name]) != len(mine):
                raise ValueError(f"optimizer state {name}: shapes differ")
            new = []
            for gi, (t, m) in enumerate(zip(state[name], mine)):
                if name in self._ROWS and self.sharded[gi]:
                    whole = (len(self.groups[gi]),) + tuple(
                        self.params[self.groups[gi][0]].shape)
                    if tuple(t.shape) != whole:
                        raise ValueError(f"optimizer state {name}: "
                                         f"shapes differ")
                    t = shard_rows(t, dim=1)
                elif t.shape != m.shape:
                    raise ValueError(f"optimizer state {name}: shapes differ")
                new.append(t.to(dev, copy=True).contiguous())
            setattr(self, name, new)

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
                local(self.params[i].grad) if self.params[i].grad is not None
                else torch.zeros_like(local(self.params[i])) for i in idxs]))
            Pm.append(_stack([local(self.params[i]) for i in idxs]))

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
            torch._foreach_add_([local(self.params[i]) for i in idxs],
                                [u.to(self.params[i].dtype) for i, u in
                                 zip(idxs, upd.unbind(0))])
        self.step_count = step + 1


def _flat_leaves(tree, prefix=""):
    """(path, leaf) of a flax tree in jax.tree_util's order (sorted
    keys), paths joined by '/'."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _flat_leaves(tree[k], path)
        else:
            yield path, tree[k]


def dominant_parameter_report(model: nn.Module,
                              grads: Optional[Dict[str, torch.Tensor]] = None,
                              scalar_lr_scale: float = 0.1, top_k: int = 5
                              ) -> List[Tuple[str, float]]:
    """Which parameters dominate the rms-weighted grad norm
    (speech2text_tpu/optim/scaled_adam.py:dominant_parameter_report):
    each flax leaf's Σg² · mean(p²) (Σg² · scalar_lr_scale² for a leaf of
    one element) as a fraction of their total, the `top_k` largest as
    (flax path, fraction). `grads` are named as `model`'s parameters
    (default: their `.grad`); names and layouts map to flax's as
    convert.to_flax maps them."""
    params = dict(model.named_parameters())
    if grads is None:
        grads = {n: p.grad for n, p in params.items() if p.grad is not None}
    flat_p = dict(_flat_leaves(to_flax(model, params)))
    rows = []
    for name, g in _flat_leaves(to_flax(model, grads)):
        p = flat_p[name]
        ss = float(np.sum(np.square(g.astype(np.float32))))
        scale = scalar_lr_scale ** 2 if p.size <= 1 else \
            float(np.mean(np.square(p)))
        rows.append((name, ss * scale))
    total = sum(s for _, s in rows) or 1.0
    rows.sort(key=lambda r: -r[1])
    return [(n, s / total) for n, s in rows[:top_k]]
