"""Zipformer2 port (speech2text_torch/models/zipformer.py) against the JAX
reference: every serving module on the same numpy inputs and converted
weights, the whole encoder at tiny dims (materialized and Pallas-kernel
JAX paths, f32 and bf16), and one flagship-dims encoder at B=1."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech2text_tpu.models import zipformer as jz
from speech2text_tpu.ops import masking as jmask
from speech2text_torch.convert import flax_to_state_dict, to_flax
from speech2text_torch.models import zipformer as tz
from speech2text_torch.models.layers import init_parameters
from speech2text_torch.ops import masking as tmask

F32_TOL = dict(rtol=1e-4, atol=1e-4)

TINY = dict(
    feature_dim=80,
    downsampling_factor=(1, 2),
    num_encoder_layers=(1, 1),
    feedforward_dim=(64, 64),
    encoder_dim=(32, 64),
    encoder_unmasked_dim=(24, 24),
    num_heads=(2, 2),
    query_head_dim=8,
    value_head_dim=8,
    pos_head_dim=4,
    pos_dim=16,
    cnn_module_kernel=(7, 7),
    causal=True,
    chunk_size=(8, -1),
    left_context_frames=(32, -1),
)


def _perturb(params, seed=0):
    """Give zero/constant-initialised leaves (biases, norm and bypass
    scales, downsample weights) random values so they are exercised."""
    rng = np.random.default_rng(seed)

    def go(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = go(v)
            else:
                v = np.asarray(v, np.float32)
                if k in ("bias", "log_scale", "bypass_scale", "weights"):
                    v = v + 0.1 * rng.standard_normal(v.shape).astype(
                        np.float32)
                out[k] = v
        return out

    return go(params)


def _port(jax_module, torch_module, *args, seed=0, **kw):
    """Init `jax_module` on `args` (jitted; callables are closed over),
    perturb, load into `torch_module`; returns (params, torch_module)."""
    arrays = [jnp.asarray(a) for a in args if not callable(a)]

    def init(key, *arrays):
        it = iter(arrays)
        full = [a if callable(a) else next(it) for a in args]
        return jax_module.init({"params": key}, *full, **kw)["params"]

    params = jax.jit(init)(jax.random.PRNGKey(seed), *arrays)
    params = _perturb(jax.tree.map(np.asarray, params), seed)
    torch_module.load_state_dict(flax_to_state_dict(params, torch_module))
    return params, torch_module.eval()


def _apply(jax_module, params, *args, **kw):
    """Jitted `jax_module.apply`; callable args and keywords are static."""
    arrays = [jnp.asarray(a) for a in args if not callable(a)]

    def run(params, *arrays):
        it = iter(arrays)
        full = [a if callable(a) else next(it) for a in args]
        return jax_module.apply({"params": params}, *full, **kw)

    return jax.jit(run)(params, *arrays)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or F32_TOL))


def test_swoosh_matches(rng):
    x = (8 * rng.standard_normal(1000)).astype(np.float32)
    for jf, tf in ((jz.swoosh_l, tz.swoosh_l), (jz.swoosh_r, tz.swoosh_r)):
        _close(tf(torch.from_numpy(x)), jf(jnp.asarray(x)), rtol=1e-6,
               atol=1e-6)


def test_masks_match():
    lens = np.array([5, 9, 0], np.int32)
    np.testing.assert_array_equal(
        tmask.make_non_pad_mask(torch.from_numpy(lens), 9).numpy(),
        np.asarray(jmask.make_non_pad_mask(jnp.asarray(lens), 9)))
    for cs, left in ((4, 2), (3, -1), (-1, -1), (1, 0)):
        np.testing.assert_array_equal(
            tmask.chunk_causal_mask(13, cs, left).numpy(),
            np.asarray(jmask.chunk_causal_mask(13, cs, left)))


def test_bias_norm_bypass_channels(rng):
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    y = rng.standard_normal((2, 7, 12)).astype(np.float32)
    p, m = _port(jz.BiasNorm(), tz.BiasNorm(12), x)
    _close(m(torch.from_numpy(x)).detach(), _apply(jz.BiasNorm(), p, x))
    p, m = _port(jz.BypassModule(), tz.BypassModule(12), x, y)
    _close(m(torch.from_numpy(x), torch.from_numpy(y)).detach(),
           _apply(jz.BypassModule(), p, x, y))
    for n in (5, 12, 20):
        _close(tz.convert_num_channels(torch.from_numpy(x), n),
               jz.convert_num_channels(jnp.asarray(x), n))


@pytest.mark.parametrize("factor,T", [(2, 9), (4, 16), (8, 13)])
def test_down_up_sample(rng, factor, T):
    x = rng.standard_normal((2, T, 6)).astype(np.float32)
    p, m = _port(jz.SimpleDownsample(factor), tz.SimpleDownsample(factor), x)
    y = m(torch.from_numpy(x)).detach()
    _close(y, _apply(jz.SimpleDownsample(factor), p, x))
    _close(tz.SimpleUpsample(factor)(y, T),
           jz.SimpleUpsample(factor).apply({}, jnp.asarray(y.numpy()), T))


@pytest.mark.parametrize("variant", ["fourier", "icefall"])
def test_rel_positional_encoding(variant):
    got = tz.CompactRelPositionalEncoding(16, variant)(23)
    want = jz.CompactRelPositionalEncoding(16, variant).apply({}, 23)
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_conv2d_subsampling(rng, causal):
    x = rng.standard_normal((2, 40, 80)).astype(np.float32)
    lens = np.array([40, 23], np.int32)
    jm = jz.Conv2dSubsampling(32, causal=causal)
    p, m = _port(jm, tz.Conv2dSubsampling(80, 32, causal=causal), x, lens)
    got, got_len = m(torch.from_numpy(x), torch.from_numpy(lens))
    want, want_len = _apply(jm, p, x, lens)
    _close(got.detach(), want)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def _attn_inputs(rng, B=2, T=19, D=32):
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pos = np.array(jz.CompactRelPositionalEncoding(16).apply({}, T))
    lens = np.array([T, T - 6])
    pad = np.arange(T)[None] < lens[:, None]
    mask = pad[:, None, :] & pad[:, :, None]
    return x, pos, mask


def test_attention_weights(rng):
    """Projections, and the plain weights against both JAX paths: the
    materialized `__call__` and the Pallas `fused` kernel (interpret)."""
    x, pos, mask = _attn_inputs(rng)
    jm = jz.AttentionWeights(32, 2, 8, 4, 16, flash_min_batch=0)
    p, m = _port(jm, tz.AttentionWeights(32, 2, 8, 4, 16), x, pos, mask)
    with torch.no_grad():
        for a, b in zip(m.project(torch.from_numpy(x), torch.from_numpy(pos)),
                        _apply(jm, p, x, pos, method=jm.project)):
            _close(a, b)
        got = m(torch.from_numpy(x), torch.from_numpy(pos),
                torch.from_numpy(mask))
    for method in (None, jm.fused):
        want = _apply(jm, p, x, pos, mask, method=method)
        _close(got, want, rtol=1e-5, atol=1e-5)


def test_value_paths(rng):
    """SelfAttention, NonlinAttention and FeedforwardModule."""
    x, pos, mask = _attn_inputs(rng)
    w = rng.random((2, 2, 19, 19)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    p, m = _port(jz.SelfAttention(32, 2, 8), tz.SelfAttention(32, 2, 8),
                 x, w)
    _close(m(torch.from_numpy(x), torch.from_numpy(w)).detach(),
           _apply(jz.SelfAttention(32, 2, 8), p, x, w))
    p, m = _port(jz.NonlinAttention(32, 24), tz.NonlinAttention(32, 24),
                 x, w[:, 0])
    _close(m(torch.from_numpy(x), torch.from_numpy(w[:, 0])).detach(),
           _apply(jz.NonlinAttention(32, 24), p, x, w[:, 0]))
    p, m = _port(jz.FeedforwardModule(48), tz.FeedforwardModule(32, 48), x)
    _close(m(torch.from_numpy(x)).detach(),
           _apply(jz.FeedforwardModule(48), p, x))


@pytest.mark.parametrize("causal", [False, True])
def test_convolution_module(rng, causal):
    x, _, _ = _attn_inputs(rng)
    pad = np.arange(19)[None] < np.array([19, 11])[:, None]
    jm = jz.ConvolutionModule(32, 7, causal)
    p, m = _port(jm, tz.ConvolutionModule(32, 7, causal), x, pad)
    _close(m(torch.from_numpy(x), torch.from_numpy(pad)).detach(),
           _apply(jm, p, x, pad))


def test_encoder_layer(rng):
    x, pos, mask = _attn_inputs(rng)
    pad = np.arange(19)[None] < np.array([19, 13])[:, None]
    args = (32, 48, 2, 8, 8, 4, 16, 7, True)
    jm = jz.Zipformer2EncoderLayer(*args)
    p, m = _port(jm, tz.Zipformer2EncoderLayer(*args), x, pos, pad, mask)
    got = m(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(pad),
            torch.from_numpy(mask))
    _close(got.detach(), _apply(jm, p, x, pos, pad, mask))


@pytest.mark.parametrize("full_dim_bypass", [False, True])
def test_stack(rng, full_dim_bypass):
    x = rng.standard_normal((2, 21, 24)).astype(np.float32)
    lens = np.array([21, 14], np.int32)

    def mask_fn(Td, ds, pad_mask):
        return pad_mask[:, None, :] & pad_mask[:, :, None]

    kw = dict(num_layers=1, downsample=2, embed_dim=32, ff_dim=48,
              num_heads=2, query_head_dim=8, value_head_dim=8,
              pos_head_dim=4, pos_dim=16, kernel_size=7, causal=True,
              full_dim_bypass=full_dim_bypass)
    jm = jz.Zipformer2Stack(**kw)
    p, m = _port(jm, tz.Zipformer2Stack(input_dim=24, **kw), x, lens,
                 mask_fn)
    got = m(torch.from_numpy(x), torch.from_numpy(lens), mask_fn)
    _close(got.detach(), _apply(jm, p, x, lens, mask_fn))


# ------------------------------------------------------------- encoder
def _encoders(dtype="float32", **jax_kw):
    cfg = dict(TINY, dtype=dtype)
    jcfg = jz.Zipformer2Config(**cfg, **jax_kw)
    return jz.Zipformer2(jcfg), tz.Zipformer2(
        tz.Zipformer2Config.from_config(cfg))


def _feats(rng, B=2, T=90):
    x = rng.standard_normal((B, T, 80)).astype(np.float32)
    lens = np.array([T] + [T - 17 * i for i in range(1, B)], np.int32)
    return x, lens


@pytest.fixture(scope="module")
def tiny_encoder():
    """Seeded port weights with perturbed biases and scales, carried to
    JAX by the inverse converter (its tree is checked against flax's in
    test_torch_rnnt_serve.py and in the flagship test below)."""
    rng = np.random.default_rng(7)
    x, lens = _feats(rng)
    _, tm = _encoders()
    init_parameters(tm, torch.Generator().manual_seed(7))
    params = _perturb(to_flax(tm), 7)
    tm.load_state_dict(flax_to_state_dict(params, tm))
    tm.eval()
    with torch.no_grad():
        got, got_len = tm(torch.from_numpy(x), torch.from_numpy(lens))
    return x, lens, params, got, got_len


@pytest.mark.parametrize("jax_path", ["materialized", "pallas"])
def test_encoder_tiny_f32(tiny_encoder, jax_path):
    x, lens, params, got, got_len = tiny_encoder
    kw = (dict(use_flash_attn=False, score_dtype="float32")
          if jax_path == "materialized"
          else dict(use_flash_attn=True, flash_min_batch=0))
    jm, _ = _encoders(**kw)
    want, want_len = _apply(jm, params, x, lens)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    _close(got, want)


def test_encoder_tiny_chunk_mask(tiny_encoder):
    x, lens, params, _, _ = tiny_encoder
    jm, tm = _encoders()
    tm.load_state_dict(flax_to_state_dict(params, tm))
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(lens),
                    chunk_size=8, left_context_chunks=2)
    want, _ = _apply(jm, params, x, lens, chunk_size=jnp.asarray(8),
                     left_context_chunks=jnp.asarray(2))
    _close(got, want)


def test_encoder_tiny_bf16(tiny_encoder):
    x, lens, params, _, _ = tiny_encoder
    jm, tm = _encoders("bfloat16", use_flash_attn=True, flash_min_batch=0)
    tm.load_state_dict(flax_to_state_dict(params, tm))
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(lens))
    want, _ = _apply(jm, params, x, lens)
    _close(got, want, rtol=2e-2, atol=2e-2 * float(np.abs(want).max()))


def test_encoder_flagship_dims_b1():
    """Flagship widths and depth (12 layers, 192/256, ds 1..8) at B=1 on
    1 s of features; weights from the port's seeded init, carried to JAX
    by the inverse converter, whose tree must match flax's own."""
    cfg = dataclasses.asdict(tz.Zipformer2Config(causal=True))
    tm = tz.Zipformer2(tz.Zipformer2Config(**cfg)).eval()
    init_parameters(tm, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 100, 80)).astype(np.float32)
    lens = np.array([100], np.int32)
    jm = jz.Zipformer2(jz.Zipformer2Config(**cfg))
    params = to_flax(tm)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
                        jnp.asarray(lens)))["params"]
    assert jax.tree.map(lambda a: a.shape, shapes) == \
        jax.tree.map(lambda a: a.shape, params)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), torch.from_numpy(lens))
    want, _ = _apply(jm, params, x, lens)
    _close(got, want, rtol=1e-3, atol=1e-3)



def test_encoder_flagship_dims_bf16_b1():
    """Flagship widths and depth in bf16 at B=1 on 1 s of features: the
    port's bf16 output is no further (RMS over the output) from the f32
    output than JAX's bf16 output is. Both sides score in f32 (the port's
    plain weights always do; JAX with use_flash_attn=False,
    score_dtype="float32"). A fixed bound would not do: at random init,
    bf16 rounding through 12 layers moves JAX's own output by ~0.16 RMS
    on outputs of ~0.9 RMS."""
    cfg = dataclasses.asdict(tz.Zipformer2Config(causal=True))
    tm = tz.Zipformer2(tz.Zipformer2Config(**cfg)).eval()
    init_parameters(tm, torch.Generator().manual_seed(0))
    tb = tz.Zipformer2(tz.Zipformer2Config(**dict(cfg, dtype="bfloat16")))
    tb.load_state_dict(tm.state_dict())
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 100, 80)).astype(np.float32)
    lens = np.array([100], np.int32)
    params = to_flax(tm)
    want32, _ = _apply(jz.Zipformer2(jz.Zipformer2Config(**cfg)), params,
                       x, lens)
    jax16, _ = _apply(jz.Zipformer2(jz.Zipformer2Config(
        **dict(cfg, dtype="bfloat16", use_flash_attn=False,
               score_dtype="float32"))), params, x, lens)
    with torch.no_grad():
        got, _ = tb.eval()(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.shape == want32.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    want32 = np.asarray(want32, np.float32)

    def rms(a):
        return float(np.sqrt(np.mean(np.square(a))))

    assert rms(got - want32) <= rms(np.asarray(jax16, np.float32) - want32)
