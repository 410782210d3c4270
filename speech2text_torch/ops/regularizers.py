"""Training-stability regularizers of the Zipformer2 training dynamics
(port of speech2text_tpu/ops/regularizers.py).

- `PiecewiseLinear` / `ScheduledFloat`: a value interpolated over (step,
  value) breakpoints and held past the ends, evaluated on the host as a
  float (the caller passes the global step as a host number, so no
  schedule reads anything back from the card).
- `balancer`: identity forward; its backward adds a gradient that steers
  each channel's mean/stddev ratio and RMS into ranges (the positive
  fraction and |x| limits converted as the JAX package converts them).
- `whiten`: identity forward; its backward adds the gradient of the
  whitening metric of the feature covariance, where it exceeds the limit,
  scaled to `grad_scale`·‖g‖.
- `limit_param_value`: the straight-through clamp.
- `penalize_abs_values_gt`: identity plus a penalty gradient on |x| over
  a limit.

Both custom gradients compute their statistics in f32 and return the
incoming gradient's dtype. Under a process group of several ranks
(parallel/mesh.py) every statistic over the batch (each channel's means,
the covariance, the row means and norms) is summed over the ranks, so
that each rank's gradient is the global batch's, as under JAX's pjit,
scaled as the ranks' average expects. As in the JAX package (and unlike icefall,
which applies them at random with probability `prob`), the extra gradient
is applied on every step scaled by `prob`. The whitening metric is taken
over every row of the (B·T, C) features, pads included, as JAX takes it.
Both backwards are the span "regularizers_backward" (utils/tracing.py),
which a profiler reads: the extra backward the training dynamics cost.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..parallel import all_reduce_sum, world_size
from ..utils.tracing import span


class PiecewiseLinear:
    """y = interp(x) over (x, y) breakpoints; constant past either end."""

    def __init__(self, *points: Tuple[float, float]):
        assert len(points) >= 1
        # f32 breakpoints and arithmetic, as jnp.interp on f32 arrays
        self.xs = np.asarray([p[0] for p in points], np.float32)
        self.ys = np.asarray([p[1] for p in points], np.float32)

    def __call__(self, x: float) -> float:
        return float(np.interp(np.float32(x), self.xs, self.ys)
                     .astype(np.float32))


class ScheduledFloat(PiecewiseLinear):
    """A step-indexed scalar schedule; call with the global step."""


def whitening_schedule(x: float, ratio: float = 2.0) -> ScheduledFloat:
    return ScheduledFloat((0.0, x), (20000.0, ratio * x))


# --------------------------------------------------------------- balancer
def _positive_to_mean(p: float) -> float:
    """A positive-fraction limit → a mean/stddev limit by the crude
    inverse erf of the JAX package, in f32."""
    eps = np.float32(1.0e-10)
    x = np.float32(-1.0) + np.float32(2.0) * np.float32(p)
    atanh = (np.log(np.float32(1.0) + x + eps)
             - np.log(np.float32(1.0) - x + eps)) / np.float32(2.0)
    return float(np.float32(0.8139535143) * atanh)


_ABS_TO_RMS = 1.25331413732  # sqrt(pi/2): E|x| → rms for normal data


def _rows(x: torch.Tensor, dims: Tuple[int, ...]) -> int:
    """The number of elements under `dims` over every rank, whose batches
    have one shape (the pipelines shard each global batch evenly)."""
    n = world_size()
    for d in dims:
        n *= x.shape[d]
    return n


def _batch_mean(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """The mean over `dims` (kept), over every rank's rows."""
    if world_size() == 1:
        return torch.mean(x, dim=dims, keepdim=True)
    return all_reduce_sum(torch.sum(x, dim=dims, keepdim=True)) \
        / _rows(x, dims)


def _balancer_grad(x: torch.Tensor, min_mean: float, max_mean: float,
                   min_rms: float, max_rms: float) -> torch.Tensor:
    """The gradient of Σ_c |m − clip(m)| + |log(clip(rms)/rms)| over the
    channels c of the last axis, m = mean/stddev and rms of each channel
    over the other axes, written out, in f32. It equals jax.grad of the
    JAX package's `stat_loss` on every channel outside a limit; on a
    channel inside every limit it is 0, where JAX's autodiff (jnp.abs has
    gradient 1 at 0) leaves rounding that the RMS normalisation can scale
    up (ROADMAP.md §C, reference caveat 4)."""
    x32 = x.float()
    axes = tuple(range(x.ndim - 1))
    n = _rows(x32, axes)
    uvar = _batch_mean(torch.square(x32), axes)
    mean = _batch_mean(x32, axes)
    var_raw = uvar - mean * mean
    var = torch.clamp(var_raw, min=1e-20)
    std = torch.sqrt(var)
    rms = torch.sqrt(torch.clamp(uvar, min=1e-20))
    m = mean / std
    # d|m − clip(m)|/dm: +1 above the range, −1 below, 0 inside
    dm = (m > max_mean).float() - (m < min_mean).float()
    # d|log(clip(rms)/rms)|/drms: 1/rms above, −1/rms below, 0 inside
    drms = ((rms > max_rms).float() - (rms < min_rms).float()) / rms
    var_live = (var_raw > 1e-20).float()
    # m = mean·var^(−1/2), var = uvar − mean²
    dvar = dm * mean * (-0.5) / (var * std) * var_live
    d_mean = dm / std + dvar * (-2.0 * mean)
    d_uvar = dvar + drms * (0.5 / rms) * (uvar > 1e-20).float()
    return (d_mean + d_uvar * 2.0 * x32) / n


class _Balancer(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, min_mean, max_mean, min_rms, max_rms, grad_scale):
        ctx.save_for_backward(x)
        ctx.limits = (min_mean, max_mean, min_rms, max_rms, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        min_mean, max_mean, min_rms, max_rms, grad_scale = ctx.limits
        with span("regularizers_backward"):
            loss_grad = _balancer_grad(x, min_mean, max_mean, min_rms,
                                       max_rms)
            axes = tuple(range(x.ndim - 1))
            lg_rms = torch.sqrt(torch.clamp(_batch_mean(
                torch.square(loss_grad), axes), min=1e-20))
            loss_grad = loss_grad * (grad_scale / lg_rms)
            g32 = g.float()
            out = (g32 + torch.abs(g32) * loss_grad).to(g.dtype)
        return out, None, None, None, None, None


def balancer(x: torch.Tensor, min_positive: float = 0.05,
             max_positive: float = 0.95, min_abs: float = 0.2,
             max_abs: float = 100.0, grad_scale: float = 0.04,
             prob: float = 1.0) -> torch.Tensor:
    """Identity whose backward steers the statistics of the last axis'
    channels; every limit a host float (a ScheduledFloat's value)."""
    f32 = np.float32
    return _Balancer.apply(
        x, _positive_to_mean(min_positive), _positive_to_mean(max_positive),
        float(f32(_ABS_TO_RMS) * f32(min_abs)),
        float(f32(_ABS_TO_RMS) * f32(max_abs)),
        float(f32(grad_scale) * f32(prob)))


# ----------------------------------------------------------------- whiten
def _whitening_metric_grad(x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(metric, d metric / dx) of x's rows (every axis but the last
    flattened) in f32: metric = (Σλ²/d) / (Σλ/d)² of the centred
    covariance, 1 when white; the gradient written out as autodiff of the
    JAX package's `_whitening_metric` gives it."""
    d = x.shape[-1]
    x32 = x.reshape(-1, d).float()
    n = max(_rows(x32, (0,)), 1)
    xc = x32 - _batch_mean(x32, (0,))
    cov = all_reduce_sum(xc.T @ xc) / n
    t = torch.trace(cov) / d
    t2 = torch.square(t)
    den = torch.clamp(t2, min=1e-20)
    frob2 = torch.sum(torch.square(cov))
    metric = (frob2 / d) / den
    # d metric / d cov = 2·cov/(d·den) − (metric/den)·2t/d·I (t² > 1e-20)
    dcov = (2.0 / d) * cov / den
    diag = (metric / den) * (2.0 / d) * t * (t2 > 1e-20).float()
    dcov = dcov - torch.diag_embed(diag.expand(d))
    dxc = (xc @ (dcov + dcov.T)) / n
    dx = dxc - _batch_mean(dxc, (0,))
    return metric, dx.reshape(x.shape)


class _Whiten(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, whitening_limit, grad_scale):
        ctx.save_for_backward(x)
        ctx.limits = (whitening_limit, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        whitening_limit, grad_scale = ctx.limits
        with span("regularizers_backward"):
            metric, pgrad = _whitening_metric_grad(x)
            g32 = g.float()
            g_norm = torch.sqrt(all_reduce_sum(torch.sum(torch.square(g32))))
            p_norm = torch.sqrt(all_reduce_sum(
                torch.sum(torch.square(pgrad)))) + 1e-20
            scale = torch.where(metric > whitening_limit,
                                grad_scale * g_norm / p_norm, 0.0)
            out = (g32 + scale * pgrad).to(g.dtype)
        return out, None, None


def whiten(x: torch.Tensor, whitening_limit: float = 2.0,
           grad_scale: float = 0.01, prob: float = 1.0) -> torch.Tensor:
    """Identity whose backward adds the whitening penalty's gradient
    where the metric exceeds `whitening_limit` (host floats)."""
    f32 = np.float32
    return _Whiten.apply(x, float(f32(whitening_limit)),
                         float(f32(grad_scale) * f32(prob)))


def limit_param_value(x: torch.Tensor, min_val: float,
                      max_val: float) -> torch.Tensor:
    """Straight-through clamp: forward clamps, backward passes the
    gradient unchanged."""
    return x + (torch.clamp(x, min_val, max_val) - x).detach()


class _PenalizeAbs(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, limit, penalty):
        ctx.save_for_backward(x)
        ctx.limits = (limit, penalty)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        limit, penalty = ctx.limits
        extra = torch.where(torch.abs(x) > limit, penalty * torch.sign(x),
                            0.0)
        return g + extra.to(g.dtype), None, None


def penalize_abs_values_gt(x: torch.Tensor, limit: float,
                           penalty: float) -> torch.Tensor:
    """Identity plus the gradient penalty·sign(x) where |x| > limit."""
    return _PenalizeAbs.apply(x, float(limit), float(penalty))
