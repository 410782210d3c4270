"""The Zipformer2 training dynamics of the port (`dynamics: true`,
speech2text_torch/models/zipformer.py) against the JAX package's, on the
CPU, in f32:

- one encoder layer and the whole tiny `Zipformer2` in training mode at
  global steps 0, 5000 and 30000: the output, the input gradient and
  every parameter gradient within rtol 1e-4 (atol 1e-4 of the output's
  and the input gradient's largest magnitude, 1e-5 of the largest
  parameter gradient entry), given JAX's draws. The draws of the skips and of
  constant attention cannot be matched by a seed (two of the rates never
  reach 0), so a first eager JAX forward records JAX's own draws
  (`jax.random.uniform` and `jax.random.bernoulli` wrapped) and the port
  takes them through each layer's `given_draws`. Dropout and the
  feature mask are off, so those are the only draws. JAX runs its fused
  attention weights (`use_flash_attn`, the Pallas kernel in interpret
  mode), whose custom gradient is the one kernel B1's autograd.Function
  ports; JAX's materialized path differs from it on padded query rows.
- The balancers of both sides compute exact statistics' gradients: the
  JAX balancer is taken with `jnp.abs` given gradient 0 at 0 (as torch
  and icefall have it); JAX's own gradient 1 there turns rounding noise
  into a full-size push on channels inside every limit (ROADMAP.md §C,
  reference caveat 4; tests/test_torch_regularizers.py holds the port to
  the unmodified JAX balancer on the channels outside a limit).
- the rates of the seven draws over a seeded generator, and
  `dynamics: true` outside training equal to `dynamics: false`.
"""

import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.models import zipformer as jz
from speech2text_tpu.ops import regularizers as jr
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.models import zipformer as tz
from speech2text_torch.models.layers import init_parameters

TINY = dict(
    feature_dim=80, downsampling_factor=(1, 2), num_encoder_layers=(1, 1),
    feedforward_dim=(64, 64), encoder_dim=(32, 64),
    encoder_unmasked_dim=(24, 24), num_heads=(2, 2), query_head_dim=8,
    value_head_dim=8, pos_head_dim=4, pos_dim=16, cnn_module_kernel=(7, 7),
    causal=True, chunk_size=(8, -1), left_context_frames=(32, -1),
    dropout=0.0, feature_mask_dropout_prob=0.0, dynamics=True)
LAYER = (32, 48, 2, 8, 8, 4, 16, 7, True)
STEPS = (0, 5000, 30000)


# ------------------------------------------ the JAX balancer, exact at 0
def _abs0(v):
    return jnp.where(v == 0, 0.0, jnp.abs(v))


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _balancer_core(x, params, channel_axis):
    return x


def _balancer_fwd(x, params, channel_axis):
    return x, (x, params)


def _balancer_bwd(channel_axis, res, g):
    """speech2text_tpu/ops/regularizers.py:_balancer_bwd with _abs0."""
    x, params = res
    min_mean, max_mean, min_rms, max_rms, grad_scale = params
    axes = tuple(i for i in range(x.ndim) if i != channel_axis % x.ndim)

    def stat_loss(x32):
        uvar = jnp.mean(jnp.square(x32), axis=axes, keepdims=True)
        mean = jnp.mean(x32, axis=axes, keepdims=True)
        stddev = jnp.sqrt(jnp.maximum(uvar - mean * mean, 1e-20))
        rms = jnp.sqrt(jnp.maximum(uvar, 1e-20))
        m = mean / stddev
        m_loss = _abs0(m - jnp.clip(m, min_mean, max_mean))
        r_loss = _abs0(jnp.log(jnp.clip(rms, min_rms, max_rms) / rms))
        return jnp.sum(m_loss + r_loss)

    x32 = x.astype(jnp.float32)
    loss_grad = jax.grad(stat_loss)(x32)
    lg_rms = jnp.sqrt(jnp.maximum(
        jnp.mean(jnp.square(loss_grad), axis=axes, keepdims=True), 1e-20))
    loss_grad = loss_grad * (grad_scale / lg_rms)
    g32 = g.astype(jnp.float32)
    out = (g32 + jnp.abs(g32) * loss_grad).astype(g.dtype)
    return (out, jnp.zeros_like(params))


_balancer_core.defvjp(_balancer_fwd, _balancer_bwd)


def _exact_balancer(x, min_positive=0.05, max_positive=0.95, min_abs=0.2,
                    max_abs=100.0, grad_scale=0.04, prob=1.0,
                    channel_axis=-1):
    params = jnp.stack([
        jr._positive_to_mean(min_positive),
        jr._positive_to_mean(max_positive),
        jr._ABS_TO_RMS * jnp.asarray(min_abs, jnp.float32),
        jr._ABS_TO_RMS * jnp.asarray(max_abs, jnp.float32),
        jnp.asarray(grad_scale, jnp.float32)
        * jnp.asarray(prob, jnp.float32)])
    return _balancer_core(x, params, channel_axis)


@pytest.fixture
def exact_balancer(monkeypatch):
    # zipformer.py imports `balancer` from ops.regularizers at call time
    monkeypatch.setattr(jr, "balancer", _exact_balancer)


@contextlib.contextmanager
def recorded_draws(out):
    """Append each layer's draws to `out` as the port's `given_draws`
    while an eager JAX forward runs: six (B, 1, 1) uniforms, then the
    constant-attention Bernoulli."""
    uniform, bernoulli = jax.random.uniform, jax.random.bernoulli
    pending = []

    def rec_uniform(key, shape=(), *a, **kw):
        u = uniform(key, shape, *a, **kw)
        pending.append(np.asarray(u, np.float32))
        return u

    def rec_bernoulli(key, p=0.5, *a, **kw):
        b = bernoulli(key, p, *a, **kw)
        assert len(pending) == 6
        out.append({"keep_u": torch.from_numpy(np.stack(pending)),
                    "const": torch.tensor(bool(b))})
        pending.clear()
        return b

    jax.random.uniform, jax.random.bernoulli = rec_uniform, rec_bernoulli
    try:
        yield out
    finally:
        jax.random.uniform, jax.random.bernoulli = uniform, bernoulli


def _give(layers, draws):
    assert len(layers) == len(draws)
    for layer, d in zip(layers, draws):
        layer.given_draws = d


def _close(got, want, rtol=1e-4, what="", scale=None):
    want = np.asarray(want, np.float32)
    if scale is None:
        scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=1e-4 * scale, err_msg=what)


def _grads_close(model, jgrads, what):
    """Every parameter gradient within rtol 1e-4, atol 1e-5 of the
    largest gradient entry of the model (a gradient that is 0 in exact
    arithmetic, such as the key bias's under the softmax, is rounding on
    both sides)."""
    want = flax_to_state_dict(jax.tree.map(np.asarray, jgrads), model)
    named = dict(model.named_parameters())
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        p = named[k].grad
        got = np.zeros(g.shape, np.float32) if p is None else p.numpy()
        _close(got, g.numpy(), what=f"{what} {k}", scale=0.1 * scale)


def _perturbed(model, seed):
    init_parameters(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    params = to_flax(model)

    def go(tree):
        return {k: go(v) if isinstance(v, dict) else
                (v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                 if k in ("bias", "log_scale", "weights") else v)
                for k, v in tree.items()}

    params = go(params)
    model.load_state_dict(flax_to_state_dict(params, model))
    return params


# ----------------------------------------------------------------- layer
def _layer_inputs(seed, B=8, T=19):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, 32)).astype(np.float32)
    pos = rng.standard_normal((2 * T - 1, 16)).astype(np.float32)
    lens = np.array([T - (i % 4) * 3 for i in range(B)])
    pad = np.arange(T)[None] < lens[:, None]
    mask = pad[:, None, :] & pad[:, :, None]
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, pos, pad, mask, g


@pytest.mark.parametrize("step,key", [(0, 1), (5000, 5001), (30000, 30001),
                                      (0, 5)])
def test_layer_matches_jax_given_its_draws(step, key, exact_balancer):
    """The last case's key draws constant attention at step 0."""
    x, pos, pad, mask, g = _layer_inputs(step)
    tm = tz.Zipformer2EncoderLayer(*LAYER, dropout=0.0, dynamics=True)
    params = _perturbed(tm, 11)
    jm = jz.Zipformer2EncoderLayer(*LAYER, dropout=0.0, dynamics=True,
                                   flash=True, flash_min_batch=0)
    js = jnp.asarray(step, jnp.float32)
    rng_key = jax.random.PRNGKey(key)

    def fwd(p, xx):
        return jm.apply({"params": p}, xx, jnp.asarray(pos), jnp.asarray(pad),
                        jnp.asarray(mask), deterministic=False, step=js,
                        rngs={"dropout": rng_key})

    draws = []
    with recorded_draws(draws):
        fwd(params, jnp.asarray(x))
    want, vjp = jax.vjp(fwd, params, jnp.asarray(x))
    jgrads, jgx = jax.jit(vjp)(jnp.asarray(g))
    assert bool(draws[0]["const"]) == (key == 5)
    _give([tm], draws)
    xt = torch.tensor(x, requires_grad=True)
    tm.train()
    out = tm(xt, torch.from_numpy(pos), torch.from_numpy(pad),
             torch.from_numpy(mask), training=True, step=step)
    assert tm.given_draws is None
    _close(out.detach(), want, what="output")
    out.backward(torch.from_numpy(g))
    _close(xt.grad, jgx, what="input grad")
    _grads_close(tm, jgrads, f"step {step}")


def test_layer_draws_take_effect(exact_balancer):
    """Constant attention and every skip change the output: the port's
    layer, given draws that turn each on in turn, differs from the same
    layer with every module kept, and matches JAX's for the same masks."""
    x, pos, pad, mask, _ = _layer_inputs(3, B=4)
    tm = tz.Zipformer2EncoderLayer(*LAYER, dropout=0.0, dynamics=True)
    _perturbed(tm, 5)
    args = [torch.from_numpy(a) for a in (x, pos, pad, mask)]
    keep_all = {"keep_u": torch.ones((6, 4, 1, 1)),
                "const": torch.tensor(False)}
    tm.given_draws = keep_all
    with torch.no_grad():
        base = tm(*args, training=True, step=0)
    variants = [dict(keep_all, const=torch.tensor(True))]
    for i in range(6):
        u = torch.ones((6, 4, 1, 1))
        u[i, 1] = 0.0                       # skip module i for utterance 1
        variants.append({"keep_u": u, "const": torch.tensor(False)})
    for v in variants:
        tm.given_draws = v
        with torch.no_grad():
            out = tm(*args, training=True, step=0)
        assert not torch.equal(out, base)
        if not bool(v["const"]):
            # the other utterances are untouched by a per-sequence skip
            rows = [0, 2, 3]
            torch.testing.assert_close(out[rows], base[rows], rtol=0, atol=0)


# --------------------------------------------------------------- encoder
@pytest.fixture(scope="module")
def tiny_dynamics():
    tm = tz.Zipformer2(tz.Zipformer2Config.from_config(TINY))
    params = _perturbed(tm, 7)
    rng = np.random.default_rng(7)
    B, T = 6, 90
    x = rng.standard_normal((B, T, 80)).astype(np.float32)
    lens = np.array([T - 11 * i for i in range(B)], np.int32)
    return tm, params, x, lens


@pytest.mark.parametrize("step", STEPS)
def test_encoder_matches_jax_given_its_draws(tiny_dynamics, step,
                                             exact_balancer):
    tm, params, x, lens = tiny_dynamics
    jm = jz.Zipformer2(jz.Zipformer2Config(**TINY, use_flash_attn=True,
                                           flash_min_batch=0))
    js = jnp.asarray(step, jnp.float32)
    key = jax.random.PRNGKey(100 + step)

    def fwd(p, xx):
        out, _ = jm.apply({"params": p}, xx, jnp.asarray(lens),
                          deterministic=False, step=js,
                          rngs={"dropout": key})
        return out

    draws = []
    with recorded_draws(draws):
        fwd(params, jnp.asarray(x))
    want, vjp = jax.vjp(jax.jit(fwd), params, jnp.asarray(x))
    g = np.random.default_rng(step).standard_normal(want.shape).astype(
        np.float32)
    jgrads, jgx = jax.jit(vjp)(jnp.asarray(g))

    tm.zero_grad()
    layers = [m for m in tm.modules()
              if isinstance(m, tz.Zipformer2EncoderLayer)]
    _give(layers, draws)
    xt = torch.tensor(x, requires_grad=True)
    out, out_lens = tm(xt, torch.from_numpy(lens), training=True, step=step)
    _close(out.detach(), want, what="output")
    out.backward(torch.from_numpy(g))
    _close(xt.grad, jgx, what="input grad")
    _grads_close(tm, jgrads, f"step {step}")


def test_eval_ignores_dynamics(tiny_dynamics):
    """Outside training `dynamics: true` is the serving forward: equal to
    the same weights in a `dynamics: false` encoder, and no draw is
    taken."""
    tm, params, x, lens = tiny_dynamics
    plain = tz.Zipformer2(tz.Zipformer2Config.from_config(
        dict(TINY, dynamics=False)))
    plain.load_state_dict(tm.state_dict())
    g = torch.Generator().manual_seed(0)
    before = g.get_state()
    with torch.no_grad():
        a, _ = tm(torch.from_numpy(x), torch.from_numpy(lens), step=0,
                  generator=g)
        b, _ = plain(torch.from_numpy(x), torch.from_numpy(lens))
    assert torch.equal(a, b)
    assert torch.equal(g.get_state(), before)


def test_draw_rates():
    """The seven draws of a layer at three steps: each keep mask drops a
    share of sequences equal to its schedule's rate (within 4.5 standard
    errors over 40000 sequences), constant attention fires at its rate
    over 4000 draws."""
    g = torch.Generator().manual_seed(1)
    B = 40000
    for step in (0.0, 2000.0, 30000.0):
        dyn = tz.LayerDynamics(step)
        draws = tz.sample_layer_draws(B, dyn.const_attn, g, "cpu")
        masks = dyn.keep_masks(draws, torch.float32)
        rates = (dyn.attn_skip, dyn.conv_skip, dyn.conv_skip, dyn.ff2_skip,
                 dyn.ff3_skip, dyn.bypass_skip)
        for m, r in zip(masks, rates):
            assert m.shape == (B, 1, 1)
            share = 1.0 - float(m.mean())
            se = max((r * (1 - r) / B) ** 0.5, 1e-9)
            assert abs(share - r) <= 4.5 * se, (step, r, share)
        fired = [bool(tz.sample_layer_draws(1, dyn.const_attn, g,
                                            "cpu")["const"])
                 for _ in range(4000)]
        r = dyn.const_attn
        assert abs(np.mean(fired) - r) <= 4.5 * (r * (1 - r) / 4000) ** 0.5
    # the schedules at their breakpoints
    assert tz.LayerDynamics(0).attn_skip == pytest.approx(0.2)
    assert tz.LayerDynamics(16000).attn_skip == 0.0
    assert tz.LayerDynamics(1e9).bypass_skip == pytest.approx(0.02)
    assert tz.LayerDynamics(1e9).const_attn == pytest.approx(0.025)
    assert tz.LayerDynamics(20000).bypass_min == pytest.approx(0.2)
