"""The training-dynamics regularizers of the port
(speech2text_torch/ops/regularizers.py) against the JAX package's
(speech2text_tpu/ops/regularizers.py), on the same seeded numpy inputs
and incoming gradients, on the CPU.

Tolerances: schedules equal to JAX's f32 interpolation within 1e-7
relative; forwards bitwise (identity); f32 gradients within rtol 1e-5
(atol 1e-6 of the gradient's scale); bf16 gradients within one bf16 ulp
(rtol 8e-3), the statistics being f32 on both sides. The cases of
tests/test_regularizers.py (steering signs, the whitening gate, the
straight-through clamp, the abs penalty) run on the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.ops import regularizers as jr
from speech2text_torch.ops import regularizers as tr


def _vjp(fn, x, g):
    _, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(vjp(jnp.asarray(g))[0], np.float32)


def _torch_grad(fn, x, g, dtype=torch.float32):
    xt = torch.tensor(x, dtype=torch.float32).to(dtype).requires_grad_(True)
    out = fn(xt)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  xt.detach().float().numpy())
    out.backward(torch.tensor(g, dtype=torch.float32).to(dtype))
    assert xt.grad.dtype == dtype
    return xt.grad.float().numpy()


def _close(got, want, rtol=1e-5):
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)


@pytest.mark.parametrize("points,steps", [
    (((0.0, 0.3), (1000.0, 0.1), (2000.0, 0.0)),
     (0, 500, 1500, 99999, -5, 1000)),
    (((0.0, 0.5),), (123, 0, 1e9)),
    (((0.0, 0.2), (4000.0, 0.05), (16000.0, 0.0)),
     (0, 1, 3999, 4000, 5000, 16000, 30000, 1e9)),
    (((0.0, 0.004), (4000.0, 0.02)), (0, 777, 2500, 4000, 12345)),
])
def test_scheduled_float_matches_jax(points, steps):
    for step in steps:
        want = float(jr.ScheduledFloat(*points)(jnp.asarray(step,
                                                            jnp.float32)))
        got = tr.ScheduledFloat(*points)(step)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-7, abs=1e-9), step
    assert tr.whitening_schedule(4.0, 3.0)(10000) == pytest.approx(
        float(jr.whitening_schedule(4.0, 3.0)(jnp.float32(10000))),
        rel=1e-7)


BALANCER_CASES = [
    # (shape, scale, offset, limits): the JAX package's defaults, the
    # layer's placements, all-negative and tiny-RMS channels
    ((4, 8), 1.0, 0.0, dict()),
    ((2, 7, 16), 1.0, 0.5, dict(min_positive=0.3, max_positive=0.7,
                                min_abs=0.02, prob=0.05)),
    ((3, 5, 12), 3.0, 0.0, dict(min_positive=0.45, max_positive=0.55,
                                min_abs=0.2, max_abs=4.0, prob=0.5)),
    ((32, 4), 0.0, -1.0, dict(min_positive=0.05, max_positive=0.95,
                              min_abs=0.2, max_abs=100.0, grad_scale=0.1)),
    ((32, 4), 1e-4, 0.0, dict(min_positive=0.0, max_positive=1.0,
                              min_abs=0.2, max_abs=100.0, grad_scale=0.1)),
    ((2, 9, 6), 1.0, 0.0, dict(min_positive=0.25, max_positive=0.75,
                               min_abs=0.5, max_abs=5.0, prob=0.5)),
]


def _in_range(x, min_positive=0.05, max_positive=0.95, min_abs=0.2,
              max_abs=100.0, **_):
    """Channels (last axis) whose mean/stddev and RMS both lie inside the
    balancer's limits, from float64 statistics."""
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    mean, uvar = flat.mean(0), np.square(flat).mean(0)
    m = mean / np.sqrt(np.maximum(uvar - mean * mean, 1e-20))
    rms = np.sqrt(np.maximum(uvar, 1e-20))
    lo, hi = tr._positive_to_mean(min_positive), \
        tr._positive_to_mean(max_positive)
    return ((m > lo) & (m < hi) & (rms > tr._ABS_TO_RMS * min_abs)
            & (rms < tr._ABS_TO_RMS * max_abs))


@pytest.mark.parametrize("case", range(len(BALANCER_CASES)))
def test_balancer_matches_jax(case):
    """Channels outside a limit: the port's gradient equals JAX's.
    Channels inside every limit: the port adds nothing (the statistics'
    loss and its gradient are 0 there, as icefall computes them). JAX's
    gradient of that loss is not exactly 0 there (jnp.abs has gradient 1
    at 0, so the rounding of d log(clip(rms)/rms)/d rms leaks through) and
    its RMS normalisation can blow that rounding up to a full-size push;
    that is a fault of the reference (ROADMAP.md §C), not ported."""
    shape, scale, offset, kw = BALANCER_CASES[case]
    rng = np.random.default_rng(case)
    x = (scale * rng.standard_normal(shape) + offset).astype(np.float32)
    # two channels pushed out of range, one each way
    z = rng.standard_normal((2,) + shape[:-1]).astype(np.float32)
    x[..., 0] = 2.0 * np.abs(z[0]) + 3.0
    x[..., -1] = -np.abs(z[1]) - 1.0
    g = rng.standard_normal(shape).astype(np.float32)
    want = _vjp(lambda v: jr.balancer(v, **kw), x, g)
    got = _torch_grad(lambda v: tr.balancer(v, **kw), x, g)
    inside = _in_range(x, **kw)
    assert (~inside).sum() >= 2
    _close(got[..., ~inside], want[..., ~inside])
    np.testing.assert_array_equal(got[..., inside], g[..., inside])
    assert not np.allclose(got, g)


def test_balancer_traced_limits_match_jax():
    """Limits that are ScheduledFloat outputs (traced in JAX, host floats
    in the port), at three steps."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 6, 10)).astype(np.float32) * 0.3 + 0.2
    g = rng.standard_normal(x.shape).astype(np.float32)
    sched = dict(lo=((0.0, 0.25), (20000.0, 0.05)),
                 hi=((0.0, 0.75), (20000.0, 0.95)),
                 prob=((0.0, 0.5), (8000.0, 0.125)))
    for step in (0.0, 5000.0, 30000.0):
        jkw = {k: jr.ScheduledFloat(*v)(jnp.float32(step))
               for k, v in sched.items()}
        tkw = {k: tr.ScheduledFloat(*v)(step) for k, v in sched.items()}
        want = _vjp(lambda v: jr.balancer(
            v, jkw["lo"], jkw["hi"], 0.5, 5.0, prob=jkw["prob"]), x, g)
        got = _torch_grad(lambda v: tr.balancer(
            v, tkw["lo"], tkw["hi"], 0.5, 5.0, prob=tkw["prob"]), x, g)
        _close(got, want)


def test_balancer_bf16_gradient():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 9, 16)) * 2.0 + 0.7).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(min_positive=0.45, max_positive=0.55, min_abs=0.2,
              max_abs=1.0, prob=0.5)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    _, vjp = jax.vjp(lambda v: jr.balancer(v, **kw),
                     jnp.asarray(xb, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(gb, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = _torch_grad(lambda v: tr.balancer(v, **kw), xb, gb,
                      dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=8e-3, atol=1e-3)


WHITEN_CASES = [
    # (rows, direction scales, limit, grad_scale, prob): anisotropic above
    # the limit, white below it, the layer's placements
    ((64,), (3.0, 0.1, 0.1, 0.1), 1.5, 0.1, 1.0),
    ((4096,), (1.0, 1.0, 1.0, 1.0), 1.5, 0.1, 1.0),
    ((2, 13), (5.0, 1.0, 0.3, 0.3, 0.3, 0.2, 1.0, 2.0), 2.0, 0.01, 0.25),
    ((3, 7), tuple(np.linspace(0.1, 4.0, 12)), 4.0, 0.01, 0.25),
]


@pytest.mark.parametrize("case", range(len(WHITEN_CASES)))
def test_whiten_matches_jax(case):
    rows, dirs, limit, gs, prob = WHITEN_CASES[case]
    rng = np.random.default_rng(10 + case)
    d = len(dirs)
    mix = rng.standard_normal((d, d)).astype(np.float32) * 0.2 + np.eye(d)
    x = ((rng.standard_normal(rows + (d,)) * np.asarray(dirs)) @ mix
         + 0.3).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    want = _vjp(lambda v: jr.whiten(v, limit, gs, prob), x, g)
    got = _torch_grad(lambda v: tr.whiten(v, limit, gs, prob), x, g)
    _close(got, want)
    metric = float(jr._whitening_metric(jnp.asarray(x)))
    port_metric, _ = tr._whitening_metric_grad(torch.tensor(x))
    assert float(port_metric) == pytest.approx(metric, rel=1e-5)
    if metric > limit:
        assert not np.allclose(got, g)
    else:
        np.testing.assert_array_equal(got, g)


def test_whiten_metric_gradient_matches_jax():
    """The metric's raw gradient (before the norm scaling), pads' zero
    rows included."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32) * \
        np.asarray([4.0, 1.0, 1.0, 0.5, 0.5, 2.0], np.float32)
    x[1, 7:] = 0.0
    metric, vjp = jax.vjp(jr._whitening_metric, jnp.asarray(x))
    (want,) = vjp(jnp.ones(()))
    got_metric, got = tr._whitening_metric_grad(torch.tensor(x))
    assert float(got_metric) == pytest.approx(float(metric), rel=1e-5)
    _close(got.numpy(), np.asarray(want))


def test_whiten_bf16_gradient():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 10, 8)) * np.linspace(0.2, 3.0, 8)).astype(
        np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    gb = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    _, vjp = jax.vjp(lambda v: jr.whiten(v, 1.2, 0.05, 0.5),
                     jnp.asarray(xb, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(gb, jnp.bfloat16))
    got = _torch_grad(lambda v: tr.whiten(v, 1.2, 0.05, 0.5), xb, gb,
                      dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=8e-3, atol=1e-3)


def test_limit_param_value_straight_through():
    x = np.asarray([-2.0, 0.5, 3.0], np.float32)
    for lo, hi in ((-1.0, 1.0), (0.2, 1.0), (0.9, 1.0)):
        want_v = np.asarray(jr.limit_param_value(jnp.asarray(x), lo, hi))
        want_g = np.asarray(jax.grad(lambda v: jnp.sum(
            jnp.square(jr.limit_param_value(v, lo, hi))))(jnp.asarray(x)))
        xt = torch.tensor(x, requires_grad=True)
        out = tr.limit_param_value(xt, lo, hi)
        np.testing.assert_array_equal(out.detach().numpy(), want_v)
        torch.sum(torch.square(out)).backward()
        np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=1e-6)
    xt = torch.tensor(x, requires_grad=True)
    torch.sum(tr.limit_param_value(xt, -1.0, 1.0)).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), 1.0)


def test_penalize_abs_values_gt():
    x = np.asarray([0.5, 10.0, -10.0, 4.9, -6.0], np.float32)
    g = np.asarray([1.0, 1.0, 1.0, -2.0, 0.5], np.float32)
    want = _vjp(lambda v: jr.penalize_abs_values_gt(v, 5.0, 0.01), x, g)
    got = _torch_grad(lambda v: tr.penalize_abs_values_gt(v, 5.0, 0.01),
                      x, g)
    np.testing.assert_allclose(got, want, rtol=1e-7)
    np.testing.assert_allclose(got[:3], [1.0, 1.01, 0.99], atol=1e-6)


def test_steering_directions():
    """tests/test_regularizers.py's cases on the port: an all-negative
    channel's gradient is lowered, tiny activations are pushed to grow,
    white features get no whitening gradient."""
    xt = torch.full((32, 4), -1.0, requires_grad=True)
    tr.balancer(xt, 0.05, 0.95, 0.2, 100.0, 0.1).backward(
        torch.ones((32, 4)))
    assert float(xt.grad.mean()) < 1.0
    x = torch.tensor(np.random.default_rng(0).standard_normal((32, 4))
                     * 1e-4, dtype=torch.float32, requires_grad=True)
    tr.balancer(x, 0.0, 1.0, 0.2, 100.0, 0.1).backward(torch.ones((32, 4)))
    sign = torch.sign(x.detach())
    assert float((x.grad * sign).mean()) < float(sign.mean())
    xw = torch.tensor(np.random.default_rng(1).standard_normal((4096, 4)),
                      dtype=torch.float32, requires_grad=True)
    tr.whiten(xw, 1.5, 0.1).backward(torch.ones((4096, 4)))
    np.testing.assert_allclose(xw.grad.numpy(), 1.0, atol=1e-6)
